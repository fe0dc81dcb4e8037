"""Out-of-order queues vs in-order chains on a branching pipeline.

The port of ``benchmarks/bench_multiqueue.py``.  A shared ``pre`` GeMM
stage feeds four independent GeMM branches whose results are combined.  On
an in-order queue the machine model serializes the branches; an
out-of-order capture records the true event-dependency DAG and
``fused_modeled()`` reports the critical path, where concurrent branches
overlap.  The modeled ratio is deterministic and equal to the JAX bench's.
Each graph launch runs the ``gemm`` kernel five times (``pre`` + four
branches) on ``device``.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_multiqueue
"""

from typing import Any

import numpy as np
import torch

from repro_torch.core import (EGPU_16T, CommandQueue, Context, Device,
                              NDRange, fuse_breakdowns)
from repro_torch.core.runtime import resolve_device

from . import wall_s
from ._dag import BRANCHES, SIZE, combine_kernel, gemm_kernel


def _capture(ctx, out_of_order):
    rng = np.random.default_rng(0)
    x = np.asarray(rng.standard_normal((SIZE, SIZE)) * 0.1, np.float32)
    w = np.asarray(rng.standard_normal((SIZE, SIZE)) * 0.1, np.float32)
    ndr = NDRange((SIZE, SIZE), (8, 8))
    q = CommandQueue(ctx, out_of_order=out_of_order)
    with q.capture() as graph:
        a, wb = ctx.create_buffer(x), ctx.create_buffer(w)
        pre = q.enqueue_nd_range(gemm_kernel("pre"), ndr, (a, wb))
        branches = [
            q.enqueue_nd_range(gemm_kernel(f"branch{i}"), ndr,
                               pre.outputs + (wb,), wait_events=[pre])
            for i in range(BRANCHES)
        ]
        q.enqueue_nd_range(combine_kernel(), ndr,
                           tuple(b.outputs[0] for b in branches),
                           wait_events=branches)
    return graph


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print("Out-of-order critical path vs in-order chain "
          f"(fan-out of {BRANCHES} {SIZE}x{SIZE} GeMM branches, on {dev.type})")
    print("=" * 76)
    ctx = Context(Device(EGPU_16T), dev)

    ooo = _capture(ctx, out_of_order=True)
    ino = _capture(ctx, out_of_order=False)
    dag, _ = ooo.fused_modeled()
    chain, _ = ino.fused_modeled()
    # sanity: the in-order capture's DAG mode equals the classic chain sum
    assert chain.total_s == fuse_breakdowns(ino.modeled_breakdowns()).total_s
    # the ordering never changes the result
    scratch = CommandQueue(ctx)
    got = ooo.launch(queue=scratch)[0].data
    want = ino.launch(queue=scratch)[0].data
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)

    speedup = chain.total_s / dag.total_s
    wall = wall_s(lambda: ooo.launch(queue=scratch), dev, reps=20)
    scratch.finish()
    scratch.release_events()
    print(f"  modeled in-order chain     {chain.total_s * 1e6:9.1f} us")
    print(f"  modeled critical path      {dag.total_s * 1e6:9.1f} us")
    print(f"  critical-path speedup      {speedup:9.2f}x "
          f"({BRANCHES} branches overlap)")
    print(f"  fused launch wall          {wall * 1e6:9.1f} us on {dev.type} "
          "(the nodes run in capture order either way)")
    return {
        "bench": "multiqueue",
        "device": dev.type,
        "size": SIZE,
        "branches": BRANCHES,
        "modeled_chain_us": chain.total_s * 1e6,
        "modeled_critical_path_us": dag.total_s * 1e6,
        "critical_path_speedup": speedup,
        "fused_launch_wall_us": wall * 1e6,
    }


if __name__ == "__main__":
    run()
