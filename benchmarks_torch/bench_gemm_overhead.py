"""Fig 3 — GeMM: transfer / scheduling / compute breakdown vs matrix size.

The port of ``benchmarks/bench_gemm_overhead.py``.  Runs the int32 GeMM
functionally through the port's ``gemm`` (the hand-written kernel
``csrc/gemm.cu`` on the card, its plain version on the CPU), exact against
numpy, and reports the analytic phase breakdown of the paper's Fig 3 —
the same rows as the JAX bench, from the same machine model.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_gemm_overhead
"""

from typing import Any

import numpy as np
import torch

from repro_torch.core import EGPU_4T, EGPU_8T, EGPU_16T, egpu_time
from repro_torch.core.runtime import resolve_device
from repro_torch.core.scheduler import optimal_ndrange
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.gemm.ref import counts as gemm_counts

SIZES = (32, 64, 128, 256)


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print("Fig 3 — GeMM Tiny-OpenCL overhead breakdown (modeled @ 300 MHz)")
    print("=" * 76)
    rng = np.random.default_rng(0)
    rows = []
    # functional check once per size (int32, like the FPU-less e-GPU)
    for s in SIZES:
        a = rng.integers(-64, 64, (s, s)).astype(np.int32)
        b = rng.integers(-64, 64, (s, s)).astype(np.int32)
        got = gemm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        np.testing.assert_array_equal(got.cpu().numpy(), a @ b)
    print(f"functional: int32 GeMM == numpy on {dev.type} for {SIZES}\n")
    print(f"{'config':10s} {'size':>5s} {'total ms':>9s} {'sched %':>8s} "
          f"{'transfer %':>10s} {'compute %':>9s}")
    for cfg in (EGPU_4T, EGPU_8T, EGPU_16T):
        for s in SIZES:
            t = egpu_time(cfg, gemm_counts(s, s, s),
                          optimal_ndrange(s * s, cfg))
            tot = t.total_cycles
            row = {"config": cfg.name, "size": s,
                   "total_ms": t.total_s * 1e3,
                   "sched_pct": 100 * t.scheduling_fraction,
                   "transfer_pct": 100 * t.transfer_fraction,
                   "compute_pct": 100 * t.compute / tot}
            rows.append(row)
            print(f"{cfg.name:10s} {s:5d} {row['total_ms']:9.3f} "
                  f"{row['sched_pct']:8.2f} {row['transfer_pct']:10.2f} "
                  f"{row['compute_pct']:9.2f}")
    s16 = [r for r in rows if r["config"] == "e-gpu-16t"]
    print(f"\nclaims: sched 256x256 = {s16[-1]['sched_pct']:.2f}% (<1%); "
          f"transfer 256x256 = {s16[-1]['transfer_pct']:.1f}% (~20%+)")
    return rows


if __name__ == "__main__":
    run()
