"""Benchmarks of the PyTorch port (``src/repro_torch``), one per JAX bench.

Each module's ``run(device="cuda")`` drives the port on ``device`` (the
card by default; ``"cpu"`` runs the kernels' plain PyTorch versions),
prints its table and returns its rows.  Modeled numbers come from the
machine model and equal the JAX package's; wall times are the host's clock
on whatever device ran.  Nothing is written to disk.

Run from the root of the checkout::

    PYTHONPATH=src python -m benchmarks_torch.bench_gemm_overhead
"""

import time

import torch


def wall_s(fn, device: torch.device, reps: int) -> float:
    """Mean host seconds per call of ``fn`` after one warm-up call, each
    call ending in a device synchronize on a CUDA device."""
    def once():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    once()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t0) / reps
