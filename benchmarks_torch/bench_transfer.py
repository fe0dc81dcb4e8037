"""Explicit-transfer graphs vs naive per-stage round-trips.

The port of ``benchmarks/bench_transfer.py``.  With explicit
``enqueue_write_buffer`` / ``enqueue_read_buffer`` commands, transfers are
first-class DAG nodes: a fan-out pipeline writes each operand once, runs
its branches resident, reads the result once — and the critical-path model
overlaps the sibling branches' transfers with compute.

This bench captures the same fan-out/fan-in pipeline of four 128×128 f32
GeMM branches both ways:

* **naive**: an in-order chain where every stage round-trips — write its
  operands, compute, read its result back;
* **explicit**: an out-of-order capture with write-once / read-once
  transfer nodes and resident kernels, fused as a dependency DAG.

The modeled ratio is deterministic (capture-time machine model, equal to
the JAX bench's).  Both graphs launch on ``device``: each graph launch runs
the ``gemm`` kernel once per branch.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_transfer
"""

from typing import Any

import numpy as np
import torch

from repro_torch.core import Buffer, CommandQueue, Context, Device, EGPU_16T, NDRange
from repro_torch.core.runtime import resolve_device

from . import wall_s
from ._dag import BRANCHES, SIZE, combine_kernel, gemm_kernel


def _operands(dev):
    rng = np.random.default_rng(0)
    x = np.asarray(rng.standard_normal((SIZE, SIZE)) * 0.1, np.float32)
    ws = [np.asarray(rng.standard_normal((SIZE, SIZE)) * 0.1, np.float32)
          for _ in range(BRANCHES)]
    return torch.from_numpy(x).to(dev), [torch.from_numpy(w).to(dev) for w in ws]


def _capture_explicit(ctx):
    """Out-of-order DAG: write each operand once, branches resident,
    one read at the end — transfers overlap compute across branches."""
    x, ws = _operands(ctx.torch_device)
    ndr = NDRange((SIZE, SIZE), (8, 8))
    q = CommandQueue(ctx, out_of_order=True)
    with q.capture() as graph:
        bx = Buffer(torch.zeros_like(x))
        q.enqueue_write_buffer(bx, x)
        branches = []
        for i, w in enumerate(ws):
            bw = Buffer(torch.zeros_like(w))
            q.enqueue_write_buffer(bw, w)
            branches.append(q.enqueue_nd_range(
                gemm_kernel(f"branch{i}"), ndr, (bx, bw), _resident=True))
        out = q.enqueue_nd_range(combine_kernel(), ndr,
                                 tuple(b.outputs[0] for b in branches),
                                 wait_events=branches, _resident=True)
        q.enqueue_read_buffer(out.outputs[0])
    return graph


def _capture_naive(ctx):
    """In-order chain where every stage round-trips its operands: no
    transfer is shared, hoisted, or overlapped."""
    x, ws = _operands(ctx.torch_device)
    ndr = NDRange((SIZE, SIZE), (8, 8))
    q = CommandQueue(ctx)
    with q.capture() as graph:
        partials = []
        for i, w in enumerate(ws):
            bx = Buffer(torch.zeros_like(x))
            bw = Buffer(torch.zeros_like(w))
            q.enqueue_write_buffer(bx, x)
            q.enqueue_write_buffer(bw, w)
            ev = q.enqueue_nd_range(gemm_kernel(f"branch{i}"), ndr, (bx, bw),
                                    _resident=True)
            partials.append(q.enqueue_read_buffer(ev.outputs[0]))
        combined = []
        for p in partials:                       # round-trip back in
            bp = Buffer(torch.zeros_like(x))
            q.enqueue_write_buffer(bp, p.outputs[0])
            combined.append(bp)
        out = q.enqueue_nd_range(combine_kernel(), ndr, tuple(combined),
                                 _resident=True)
        q.enqueue_read_buffer(out.outputs[0])
    return graph


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print("Explicit-transfer DAG vs naive per-stage round-trips "
          f"({BRANCHES} {SIZE}x{SIZE} GeMM branches, on {dev.type})")
    print("=" * 76)
    ctx = Context(Device(EGPU_16T), dev)

    explicit = _capture_explicit(ctx)
    naive = _capture_naive(ctx)
    n_xfer = sum(1 for n in explicit.nodes if n.is_transfer)
    n_naive_xfer = sum(1 for n in naive.nodes if n.is_transfer)
    dag, _ = explicit.fused_modeled()
    chain, _ = naive.fused_modeled()
    # both graphs compute the identical function
    scratch = CommandQueue(ctx)
    a = explicit.launch(queue=scratch)[0].data
    b = naive.launch(queue=scratch)[0].data
    # fp32: atol beside rtol, since rtol alone fails near zero
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)

    speedup = chain.total_s / dag.total_s
    wall = wall_s(lambda: explicit.launch(queue=scratch), dev, reps=20)
    scratch.finish()
    scratch.release_events()
    print(f"  naive round-trip chain     {chain.total_s * 1e6:9.1f} us "
          f"({n_naive_xfer} transfer nodes, serial)")
    print(f"  explicit-transfer DAG      {dag.total_s * 1e6:9.1f} us "
          f"({n_xfer} transfer nodes on the critical-path model)")
    print(f"  modeled speedup            {speedup:9.2f}x "
          "(write-once + overlap vs per-stage round-trips)")
    print(f"  exposed transfer cycles    {chain.transfer:9.0f} -> "
          f"{dag.transfer:.0f}")
    print(f"  fused launch wall          {wall * 1e6:9.1f} us on {dev.type}")
    return {
        "bench": "transfer",
        "device": dev.type,
        "size": SIZE,
        "branches": BRANCHES,
        "explicit_transfer_nodes": n_xfer,
        "naive_transfer_nodes": n_naive_xfer,
        "modeled_naive_roundtrip_us": chain.total_s * 1e6,
        "modeled_explicit_dag_us": dag.total_s * 1e6,
        "explicit_vs_naive_speedup": speedup,
        "fused_launch_wall_us": wall * 1e6,
    }


if __name__ == "__main__":
    run()
