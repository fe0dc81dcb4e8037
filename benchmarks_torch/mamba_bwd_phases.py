"""Where the Mamba backward kernel's cycles go, phase by phase, on the card.

A copy of a tree's ``csrc/mamba_scan_bwd.cu`` is instrumented: at marks
before the lines that open and close the kernel's phases (the barriers,
the sweep, the recomputed chunk, the reverse walk) thread 0 of each block
reads ``clock64()`` and adds the cycles since its last mark to that
phase's counter (``_kernel_copy.py``).  :data:`PHASE_TABLES` holds the
marks of two kernels: the present one, and the first (a thread a channel,
three exponentials), which a tree before this design still has and whose
split ``PERF.md`` records; the table whose every mark is found in
``mamba_bwd_kernel`` in source order is used.  The copy is built with the
library's own ``nvcc`` flags beside that tree's library, and the tree's
own wrapper (``ops.mamba_scan_bwd``) is called with its launches sent to
the copy, at jamba's training shape (B 8, T 128, Dm 16384, N 16, x/dy
bf16, delta f32, numpy seed 0): once to check it against the library's
kernel and once counted.  The uninstrumented call's device ms
(``chip_smoke.device_ms``) and its kernels' device ms by name
(``torch.profiler``) are printed beside it::

    python3 -m benchmarks_torch.mamba_bwd_phases [--src OTHER/src]

``--src`` names the ``src`` directory whose kernel is profiled (this
checkout's by default; a parent commit unpacked under ``build/`` profiles
its own).  Prints one JSON object: the card's name and power limit, the
table used, the device ms of the call and of the instrumented copy (the
marks cost a few per cent), the device ms a call of each kernel, whether
the copy's gradients are bit-equal to the library's, the largest error
against the plain backward over its largest magnitude, and the mean cycles
a block by phase with each phase's share.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from . import _kernel_copy as kc

ROOT = Path(__file__).resolve().parents[1]

#: (text that starts a statement of mamba_bwd_kernel, the phase that the
#: mark put before it closes), in source order: the time from one mark to
#: the next goes to the second's phase.  A phase named twice sums both.
PHASE_TABLES = {
    "one thread a channel, three exponentials": (
        ("    __syncthreads();                          // the last chunk's reads are done",
         "sweep: steps and state store"),
        ("    stage<TX, TD, N>(sm, a, row0, ch0, t0, steps);", "barriers"),
        ("    __syncthreads();\n", "sweep: staging"),
        ("    for (int tt = 0; tt < steps; ++tt) {", "barriers"),
        ("  // 2. Backward", "sweep: steps and state store"),
        ("    __syncthreads();                          // the last chunk's reads are done",
         "backward: block partials"),
        ("    stage<TX, TD, N>(sm, a, row0, ch0, t0, steps);", "barriers"),
        ("    __syncthreads();\n", "backward: staging"),
        ("    // the chunk's steps forward again", "barriers; chunk state load"),
        ("    // the reverse walk with dh", "backward: recompute"),
        ("    __syncthreads();                          // red_b and red_c",
         "backward: reverse walk"),
        ("    // the block's partials of db and dc", "barriers"),
        ("  if (live) {\n#pragma unroll\n    for (int n = 0; n < N; ++n)\n      a.da_part",
         "backward: block partials"),
    ),
    "states over lanes, two exponentials": (
        ("    cp_async_wait<kStages - 2>();", "backward: reverse walk"),
        ("    if (s + kStages - 1 < loads)", "ring wait and barrier"),
        ("    if (s < sweeps) {", "copies issued"),
        ("      continue;", "sweep: steps and state store"),
        ("    float* const red_b", "backward: block partials"),
        ("    // 3. The chunk forward again", "barriers; chunk state load"),
        ("    // 4. The reverse walk", "backward: recompute"),
        ("  __syncthreads();                  // the last chunk's warp sums",
         "backward: reverse walk"),
        ("  flush(0,", "ring wait and barrier"),
        ("  if (live) {\n#pragma unroll\n    for (int j = 0; j < S; ++j)\n      a.da_part",
         "backward: block partials"),
    ),
}
HEAD = "mamba_bwd_kernel("


def instrument(src: str):
    """(the table's name, its phases, the source with a counter at each of
    its marks)."""
    head = src.index("{\n", src.index(HEAD)) + 2
    end = src.index("\n}\n", head)
    body = src[head:end]
    for name, marks in PHASE_TABLES.items():
        at, places = 0, []
        for text, _phase in marks:
            at = body.find(text, at)
            if at < 0:
                break
            places.append(at)
            at += len(text)
        if len(places) == len(marks):
            break
    else:
        raise RuntimeError("no phase table's marks are all in mamba_bwd_kernel")
    phases = tuple(dict.fromkeys(phase for _text, phase in marks))
    for place, (_text, phase) in sorted(zip(places, marks), reverse=True):
        body = body[:place] + kc.mark(phases.index(phase)) + "\n" + body[place:]
    out = src[:head] + "  " + kc.CLOCK_START + "\n" + body + src[end:]
    return name, phases, kc.with_counters(out, len(phases))


def kernel_ms(fn, calls: int = 3) -> dict:
    """Device ms a call of each kernel that ``fn`` runs, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0 and "mamba_bwd" in ev.key:
            name = ("mamba_bwd_sum_kernel" if "mamba_bwd_sum_kernel" in ev.key
                    else "mamba_bwd_kernel")
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def run(src_dir: Path) -> dict:
    sys.path[:0] = [str(src_dir), str(ROOT)]
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba_scan import mamba_scan as mm
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_bwd
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    b, t, dm, n = 8, 128, 16384, 16
    x = normal(b, t, dm, dtype=torch.bfloat16, sc=0.5)
    delta = normal(b, t, dm, sc=0.3).abs() + 0.1
    a = -(normal(dm, n).abs() + 0.1)
    bm, cm = normal(b, t, n, sc=0.5), normal(b, t, n, sc=0.5)
    dy = normal(b, t, dm, dtype=torch.bfloat16)
    ins = (x, delta, a, bm, cm, dy)
    want = mamba_scan_bwd(*ins)
    ms = device_ms(torch, lambda: mamba_scan_bwd(*ins), 10)
    by_kernel = kernel_ms(lambda: mamba_scan_bwd(*ins))
    table, phases, text = instrument(
        (common.CSRC_DIR / "mamba_scan_bwd.cu").read_text())
    lib, _ = kc.build(common, "mamba_scan_bwd_phases", text)
    plain = mamba_scan_bwd_plain(*(z.float() for z in ins))
    with kc.redirect(mm, lib):
        got = mamba_scan_bwd(*ins)
        counts = kc.read_cycles(lib, len(phases), lambda: mamba_scan_bwd(*ins))
        instrumented_ms = device_ms(torch, lambda: mamba_scan_bwd(*ins), 10)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    blocks = b * -(-dm // (128 if table.startswith("one thread") else
                           mm.plan_mamba_bwd(dm, n).channels))
    total = sum(counts)
    return {
        "card": nvidia_smi("name,power.limit"),
        "src": str(src_dir), "table": table, "kernel_ms": ms,
        "kernel_ms_by_name": by_kernel,
        "instrumented_ms": instrumented_ms,
        "bits_equal_to_the_kernel": same,
        "max_err_vs_plain_over_max": max(
            float((g.float() - p.float()).abs().max() / p.float().abs().max())
            for g, p in zip(got, plain)),
        "blocks": blocks,
        "cycles_a_block": {k: round(c / blocks) for k, c in zip(phases, counts)},
        "share": {k: round(c / total, 4) for k, c in zip(phases, counts)},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mamba_bwd_phases needs the card")
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    print(json.dumps(run(Path(args.src).resolve())), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
