"""Serving-path throughput: cached CommandGraphs vs per-offload re-capture.

The port of ``benchmarks/bench_serve.py``.  Without a cache every
``APU.offload(mode="graph")`` re-captures the chain (running each plain
version on ``meta`` tensors); with ``repro_torch.serve.GraphCache`` the same
call is a dictionary lookup plus a replay.  Both arms run a chain of six
dependent 32x32 f32 GeMM stages (the plain ``gemm_ref``, as the JAX bench
uses) and report host seconds per offload, each ending in a synchronize on
the card.

A traced arm replays the same pipeline through a small
``Server(tracer=...)`` session on a virtual clock: every request must grow a
complete span tree, the Chrome trace must validate, the traced session's
modeled report must equal an untraced twin's, and every result must have
the bits of a cached offload.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_serve [--device cpu]
"""

import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import APU, EGPU_16T, Kernel, Stage
from repro_torch.core.runtime import resolve_device
from repro_torch.kernels.gemm.ref import gemm_ref
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serve import GraphCache, Server

SIZE = 32
CHAIN = 6          # dependent GeMM stages per offload
REPS = 12          # offloads per trial
TRIALS = 3         # best-of (min)


def _stages(dev: torch.device):
    kern = Kernel(name="gemm_chain", executor=gemm_ref)
    w = torch.from_numpy(np.eye(SIZE, dtype=np.float32)
                         + 0.01 * np.random.default_rng(0).standard_normal(
                             (SIZE, SIZE)).astype(np.float32)).to(dev)
    return [Stage(kern, consts=(w,), n_inputs=1) for _ in range(CHAIN)]


def _bench_offload(apu, stages, x):
    def one():
        outs, _ = apu.offload(stages, (x,))
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return outs

    one()                                 # first capture
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            one()
        best = min(best, time.perf_counter() - t0)
    return best / REPS


class _VClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traced_session(stages, xs, dev, tracer=None):
    """A small serve session on a virtual clock (traced when asked)."""
    clk = _VClock()
    srv = Server(stages, workers=(EGPU_16T,), bucket_sizes=(SIZE,),
                 max_batch=2, clock=clk, tracer=tracer, device=dev)
    rids = []
    for i, x in enumerate(xs):
        clk.t = 1e-4 * i
        rids.append(srv.submit(x))
    clk.t = 1e-4 * len(xs) + 1e-3
    srv.flush()
    return srv, rids


def _traced_arm(stages, x, dev):
    xs = [x] * 8
    tracer = Tracer()
    srv_t, rids_t = _traced_session(stages, xs, dev, tracer=tracer)
    srv_u, rids_u = _traced_session(stages, xs, dev, tracer=None)
    assert tracer.request_rids() == sorted(rids_t)
    tree_errors = tracer.validate_request_trees()
    assert not tree_errors, tree_errors
    rep_t, rep_u = srv_t.report(), srv_u.report()
    assert (rep_t.n_requests, rep_t.n_batches, rep_t.modeled_latency_s,
            rep_t.goodput_per_s_modeled) == (
        rep_u.n_requests, rep_u.n_batches, rep_u.modeled_latency_s,
        rep_u.goodput_per_s_modeled), "tracing perturbed the modeled report"
    ref, _ = APU(EGPU_16T, device=dev).offload(stages, (x,))
    for rid_t, rid_u in zip(rids_t, rids_u):
        (got_t,), (got_u,) = srv_t.result(rid_t), srv_u.result(rid_u)
        assert torch.equal(got_t, ref[0].data) and torch.equal(got_u, ref[0].data)
    schema_errors = validate_chrome_trace(tracer.to_chrome_json())
    assert not schema_errors, schema_errors
    print(f"  traced arm: {len(tracer.spans)} spans over {len(rids_t)} request "
          "trees, schema valid, report unperturbed, results bit-equal")
    return {"n_spans": len(tracer.spans), "n_request_trees": len(rids_t),
            "request_trees_complete": not tree_errors,
            "schema_valid": not schema_errors}


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print("Serving path: cached CommandGraph vs per-offload re-capture")
    print(f"(chain of {CHAIN} dependent {SIZE}x{SIZE} GeMM stages, best of "
          f"{TRIALS}x{REPS} offloads, on {dev.type})")
    print("=" * 76)
    stages = _stages(dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (SIZE, SIZE)).astype(np.float32)).to(dev)

    recapture = _bench_offload(APU(EGPU_16T, device=dev), stages, x)
    cache = GraphCache(capacity=8)
    cached = _bench_offload(APU(EGPU_16T, device=dev, graph_cache=cache),
                            stages, x)
    ratio = recapture / cached
    print(f"  re-capture  {recapture * 1e6:9.1f} us/offload")
    print(f"  cached      {cached * 1e6:9.1f} us/offload   "
          f"(cache: {cache.hits} hits / {cache.misses} miss)")
    print(f"\n  cached offload is {ratio:.1f}x faster than re-capture")
    assert cache.misses == 1, "steady-state offloads must never re-capture"
    trace = _traced_arm(stages, x, dev)
    return [{"bench": "serve", "device": dev.type, "size": SIZE,
             "chain_len": CHAIN, "reps": REPS, "trials": TRIALS,
             "per_offload_us": {"recapture": recapture * 1e6,
                                "cached": cached * 1e6},
             "cached_vs_recapture_speedup": ratio,
             "cache_stats": cache.stats(), "trace": trace}]


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args().device)
