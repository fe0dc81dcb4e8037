"""Where the RWKV-6 backward kernel's cycles go, phase by phase, on the card.

A copy of ``src/repro_torch/csrc/rwkv6_scan_bwd.cu`` is instrumented: at
every barrier of ``rwkv6_bwd_kernel`` thread 0 of each block reads
``clock64()`` and adds the cycles since its last reading to that phase's
counter (``_kernel_copy.py``).  The copy is built with the library's own
``nvcc`` flags into ``build/repro_torch/`` beside the library and called
through the library's wrapper (``ops.rwkv6_scan_bwd``) at rwkv6-3b's
training shape (B 8, H 40, T 128, D 64, r/k/v/dy bf16, w f32, numpy seed
0), once to check it against the plain backward and once counted; the
uninstrumented kernel's device ms (``chip_smoke.device_ms``) is printed
beside it::

    python3 -m benchmarks_torch.rwkv_bwd_phases

Prints one JSON object: the card's name and power limit, the device ms of
the kernel and of the instrumented copy (the counters cost a few per
cent), whether the copy's gradients are bit-equal to the kernel's, and the
mean cycles a block by phase with each phase's share.  Needs the card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import _kernel_copy as kc

ROOT = Path(__file__).resolve().parents[1]

#: the phase each barrier of the kernel closes, in source order: the sweep
#: loop's top (the last sweep chunk's product and state write), its staging,
#: its decays; the backward loop's top (the last chunk's walks), its
#: staging, its decays / c / A, its products; the barrier after the loop
#: (the last chunk's walks)
BARRIER_PHASES = ("sweep: products and state", "sweep: staging",
                  "sweep: decays", "backward: walks", "backward: staging",
                  "backward: decays, c and A", "backward: shared products",
                  "backward: walks")
#: the mark put before the shared products (the carry's product ends there)
CARRY_MARK = "    // The shared products, in strips"
PHASES = tuple(dict.fromkeys(BARRIER_PHASES)) + ("backward: the carry",)


def instrument(src: str) -> str:
    """The source with a counter at each barrier of rwkv6_bwd_kernel."""
    head = src.index("rwkv6_bwd_kernel(Args a, int hist_smem) {")
    end = src.index("\n}\n", head)
    body = src[head:end]

    def mark(phase: str) -> str:
        return "__syncthreads(); " + kc.mark(PHASES.index(phase))

    parts = body.split("__syncthreads();")
    if len(parts) - 1 != len(BARRIER_PHASES):
        raise RuntimeError(f"rwkv6_bwd_kernel has {len(parts) - 1} barriers, "
                           f"expected {len(BARRIER_PHASES)}")
    body = parts[0] + "".join(mark(p) + rest for p, rest in
                              zip(BARRIER_PHASES, parts[1:]))
    body = body.replace(CARRY_MARK, "    " + mark("backward: the carry") + "\n"
                        + CARRY_MARK, 1)
    body = body.replace("extern __shared__ __align__(16) float sm[];",
                        "extern __shared__ __align__(16) float sm[];\n  "
                        + kc.CLOCK_START, 1)
    return kc.with_counters(src[:head] + body + src[end:], len(PHASES))


def run() -> dict:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels import common
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rk
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_bwd
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    b, h, t, d = 8, 40, 128, 64
    r, k, v = (normal(b, h, t, d, dtype=torch.bfloat16, sc=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(normal(b, h, t, d, sc=0.5) - 1.0))
    u = normal(h, d, sc=0.5)
    dy = normal(b, h, t, d, dtype=torch.bfloat16)
    ins = (r, k, v, w, u, dy)
    want = rwkv6_scan_bwd(*ins)
    plain = rwkv6_scan_bwd_plain(*(z.float() for z in ins))
    lib, _ = kc.build(common, "rwkv6_scan_bwd_phases", instrument(
        (common.CSRC_DIR / "rwkv6_scan_bwd.cu").read_text()))
    with kc.redirect(rk, lib):
        got = rwkv6_scan_bwd(*ins)
        counts = kc.read_cycles(lib, len(PHASES), lambda: rwkv6_scan_bwd(*ins))
        instrumented_ms = device_ms(torch, lambda: rwkv6_scan_bwd(*ins), 20)
    total = sum(counts)
    return {
        "card": nvidia_smi("name,power.limit"),
        "kernel_ms": device_ms(torch, lambda: rwkv6_scan_bwd(*ins), 20),
        "instrumented_ms": instrumented_ms,
        "bits_equal_to_the_kernel": all(torch.equal(a, c) for a, c in zip(got, want)),
        "max_err_vs_plain_over_max": max(
            float((a.float() - c.float()).abs().max() / c.float().abs().max())
            for a, c in zip(got, plain)),
        "cycles_a_block": {name: round(c / (b * h)) for name, c in zip(PHASES, counts)},
        "share": {name: round(c / total, 4) for name, c in zip(PHASES, counts)},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rwkv_bwd_phases needs the card")
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
