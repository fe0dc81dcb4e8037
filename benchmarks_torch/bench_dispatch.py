"""Measured dispatch overhead of the TinyCL runtime (the ~25 us analogue).

The port of ``benchmarks/bench_dispatch.py``.  The paper's scheduling
overhead is the Tiny-OpenCL runtime distributing work-items; here it is the
host-side cost of dispatching an already-built kernel.  The three TinyCL
dispatch modes run side by side on a chain of small dependent GeMMs
(x_{i+1} = x_i @ b), where compute is negligible and overhead dominates:

* ``eager-sync`` — ``CommandQueue(profile=False, blocking=True)``: every
  enqueue waits on its own launch's completion (one host<->device round
  trip per kernel);
* ``async`` — ``blocking=False``: enqueues overlap, one ``finish()`` drains
  the chain;
* ``graph`` — ``queue.capture()`` once, then
  ``CommandGraph.launch(queue_events=False)``.  The port's launch replays
  the captured nodes one by one in Python (no fused computation, no CUDA
  graph), so it saves the queue's per-command bookkeeping, not the
  per-kernel launch.

Every mode's timed region ends with the chain's work complete: the queue
modes drain in ``finish()`` (each event waits on its own launch), the graph
mode synchronizes the card after the replay.  The executor is the plain
``gemm_ref`` (a float32 ``matmul``), as in the JAX bench, so the numbers
isolate host dispatch.  ``run()`` prints and returns the JAX bench's result
keys; it writes no file.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_dispatch [--device cpu]
"""

import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import (EGPU_16T, CommandQueue, Context, Device, Kernel,
                              NDRange)
from repro_torch.kernels.gemm.ref import gemm_ref

SIZE = 32          # small on purpose: dispatch floor, not compute
CHAIN = 8          # dependent kernels per rep (x = x @ b, 8 deep)
REPS = 30
TRIALS = 5         # best-of (min): robust to scheduler noise on shared hosts


def _chain_inputs(ctx):
    rng = np.random.default_rng(0)
    x = ctx.create_buffer(
        (rng.standard_normal((SIZE, SIZE)) * 0.1).astype(np.float32))
    b = ctx.create_buffer(
        (np.eye(SIZE) + 0.01 * rng.standard_normal((SIZE, SIZE))
         ).astype(np.float32))
    return x, b


def _best_per_kernel(chain):
    chain()                              # warm-up
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            chain()
        best = min(best, time.perf_counter() - t0)
    return best / (REPS * CHAIN)


def _bench_queue(ctx, kern, ndr, blocking):
    q = CommandQueue(ctx, profile=False, blocking=blocking)
    x, b = _chain_inputs(ctx)

    def chain():
        cur = x
        for _ in range(CHAIN):
            cur = q.enqueue_nd_range(kern, ndr, (cur, b)).outputs[0]
        q.finish()                       # drain inside the timed region

    return _best_per_kernel(chain)


def _bench_graph(ctx, kern, ndr):
    q = CommandQueue(ctx, profile=False)
    x, b = _chain_inputs(ctx)
    with q.capture() as graph:
        cur = x
        for _ in range(CHAIN):
            cur = q.enqueue_nd_range(kern, ndr, (cur, b)).outputs[0]

    def chain():
        (out,) = graph.launch(queue_events=False)
        if out.data.is_cuda:
            torch.cuda.synchronize(out.data.device)

    return _best_per_kernel(chain)


def run(device: Any = "cuda"):
    print("=" * 76)
    print("Tiny-OpenCL dispatch overhead: eager-sync vs async vs graph")
    print(f"(chain of {CHAIN} dependent {SIZE}x{SIZE} GeMMs, best of "
          f"{TRIALS}x{REPS} reps, full-queue drain timed, on "
          f"{torch.device(device).type})")
    print("=" * 76)
    ctx = Context(Device(EGPU_16T), device)
    kern = Kernel(name="gemm_small", executor=gemm_ref)
    ndr = NDRange((SIZE, SIZE), (8, 8))

    per_launch = {
        "eager-sync": _bench_queue(ctx, kern, ndr, blocking=True),
        "async": _bench_queue(ctx, kern, ndr, blocking=False),
        "graph": _bench_graph(ctx, kern, ndr),
    }
    for mode, per in per_launch.items():
        print(f"  {mode:11s} {per * 1e6:9.1f} us/kernel")

    ratio = per_launch["eager-sync"] / per_launch["graph"]
    print(f"\n  graph dispatch is {ratio:.1f}x cheaper per kernel than "
          f"eager-sync, {per_launch['async'] / per_launch['graph']:.2f}x "
          f"than async (paper's Tiny-OpenCL scheduling ≈ 25 us @ 300 MHz)")
    return {
        "bench": "dispatch",
        "size": SIZE,
        "chain_len": CHAIN,
        "reps": REPS,
        "trials": TRIALS,
        "per_launch_us": {m: p * 1e6 for m, p in per_launch.items()},
        "graph_vs_eager_sync_speedup": ratio,
    }


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args().device)
