"""Device time of the ``mamba_scan`` kernel at jamba-1.5-large's width
(Dm = 16384, N = 16; x bf16, the rest f32, as the jamba block passes them
under bf16) on one card, at B = 4, T = 256 (``chip_smoke.py`` phase 3's
shape), B = 2, T = 128 (phase 4c's) and B = 1, T = 4096.

Run from the root of a checkout, on a machine with a card::

    python3 benchmarks_torch/bench_mamba_scan.py [--src DIR] [--lanes]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; another commit unpacked beside it times its own
kernel, through ``selective_scan``, which every version has).  ``--lanes``
instead times every lane count the kernel has (``launch_mamba_scan``'s
``lanes``) at B = 1, 2, 4 and T = 128 .. 4096, the plan's choice marked:
the reading that ``plan_mamba``'s warp targets and ``LONG_SCAN`` rest on.
Each row: device ms per call (CUDA events around 20 replays of a CUDA
graph of calls, ``chip_smoke.device_ms``), the byte bound at 3.35 TB/s,
the special-function unit's floor (one exponential per step, channel and
state at 16 a clock per SM and the card's max SM clock), and the largest
error against the plain version over the tolerance of phase 2 (1e-5 of
the largest magnitude, plus one bf16 ulp of each value of y; at most 1
passes).  Inputs are drawn on the card from seed 0.  Prints one JSON
object per row.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (B, T) at jamba's width; Dm and N from the config
SHAPES = ((4, 256), (2, 128), (1, 4096))
#: (B, T) of the lane sweep
SWEEP = tuple((b, t) for b in (1, 2, 4) for t in (128, 256, 512, 1024, 2048, 4096))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--lanes", action="store_true")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_mamba_scan: needs a card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    from chip_smoke import (MAMBA_ARCH, SFU_PER_CLK_PER_SM, bound, device_ms,
                            nvidia_smi)
    from repro_torch.configs import get as get_arch
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba_scan import mamba_scan as mm
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain

    print(nvidia_smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    cfg = get_arch(MAMBA_ARCH)
    dm, n = cfg.mamba_d_inner, cfg.mamba_d_state
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, sc=1.0):
        return sc * torch.randn(shape, generator=gen, device=dev)

    def inputs(b, t):
        x = normal(b, t, dm, sc=0.5).to(torch.bfloat16)
        delta = normal(b, t, dm, sc=0.3).abs() + 0.1
        a = -(normal(dm, n).abs() + 0.1)
        return x, delta, a, normal(b, t, n, sc=0.5), normal(b, t, n, sc=0.5)

    def error(got, want):
        """Largest |got - want| over the tolerance of phase 2 (<= 1 passes)."""
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.float(), w.float()
            tol = 1e-5 * float(w.abs().max())
            if i == 0 and got[0].dtype == torch.bfloat16:
                tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
            worst = max(worst, float(((g - w).abs() / tol).max()))
        return worst

    def row(label, b, t, ins, want, fn, lanes, planned):
        got = fn()
        torch.cuda.synchronize()
        elems = b * t * dm
        nbytes = elems * (2 + 4 + 2) + 4.0 * (dm * n + 2 * b * t * n + b * dm * n)
        print(json.dumps({
            "kernel": label, "B": b, "T": t, "Dm": dm, "N": n, "lanes": lanes,
            "planned": planned,
            "warps_per_sm": b * -(-dm * lanes // mm.THREADS) * mm.THREADS / 32 / sms
            if lanes else None,
            "ms": device_ms(torch, fn, max(1, 20 * 256 * 4 // (b * t))),
            "bound_ms": bound(nbytes, 6.0 * elems * n)[0],
            "sfu_floor_ms": elems * n / (SFU_PER_CLK_PER_SM * sms * clock_hz) * 1e3,
            "err_over_tol": error(got, want)}), flush=True)

    info = common.build_kernels()
    print(f"kernels built in {info['seconds']:.1f} s", flush=True)
    label = Path(args.src).resolve().parent.name
    for b, t in SWEEP if args.lanes else SHAPES:
        ins = inputs(b, t)
        want = mamba_scan_plain(*ins)
        if not args.lanes:
            plan = getattr(mm, "plan_mamba", None)
            row(label, b, t, ins, want, lambda: selective_scan(*ins),
                plan(b, t, dm, n, sms).lanes if plan else None, True)
            continue
        y = torch.empty_like(ins[0])
        state = torch.empty(b, dm, n, device=dev)
        planned = mm.plan_mamba(b, t, dm, n, sms).lanes
        for lanes in mm.lane_choices(n):
            row(label, b, t, ins, want,
                lambda: (mm.launch_mamba_scan(*ins, None, y, state, lanes=lanes),
                         (y, state))[1], lanes, lanes == planned)
        del ins, want, y, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
