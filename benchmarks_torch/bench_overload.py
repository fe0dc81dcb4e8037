"""Open-loop overload: goodput under deadlines, shedding, and lane faults.

The port of ``benchmarks/bench_overload.py``.  A Poisson open-loop arrival
process drives the serving front door at 2x the fleet's modeled saturation
rate.  Four arms over the same arrival trace and request payloads:

* **fifo** — no admission control, no deadline flushing: under 2x load the
  modeled backlog grows linearly and almost every request completes past
  its deadline;
* **shed** — modeled-capacity admission control + deadline-aware partial
  flushes: infeasible requests are refused at the door and the backlog
  stays bounded near the deadline budget;
* **shed_faulted** — the same under a seeded ``FaultPlan`` that blacks out
  one of the three lanes mid-run and sprinkles launch failures: every
  accepted-and-served request must stay bit-identical to
  ``APU.offload(..., mode="eager")`` of it alone on the same device;
* **shed_faulted_traced** — the faulted arm under a ``Tracer``: every
  accepted rid grows a complete span tree, the Chrome trace validates, and
  the modeled outcome equals the untraced faulted arm's.

All timing is modeled virtual time, so every row is deterministic and
equals the JAX bench's; the gate is goodput(shed) and goodput(shed_faulted)
>= 1.3x goodput(fifo).  The served GeMM stages are the plain ``gemm_ref``
(on the card, PyTorch's matmul), as the JAX bench serves its plain version.
``run()`` prints and returns the JAX bench's result keys and writes no file
but the Chrome trace, and that only when ``trace_path`` is given.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_overload [--device cpu]
"""

from typing import Any

import numpy as np
import torch

from repro_torch.core import APU, EGPU_16T
from repro_torch.core.runtime import resolve_device
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serve import (AdmissionError, Blackout, FaultPlan, Server,
                               env_seed)

from ._gemm_chain import (BUCKET, CHAIN, MAX_BATCH, D, VClock, requests,
                          stages)

N_LANES = 3
MAX_PENDING = 12
N_REQUESTS = 480
OFFERED_X = 2.0    # offered load vs modeled saturation
GATE_X = 1.3       # shedding goodput vs fifo


def _profile_spr(stages_, dev):
    """Modeled seconds-per-request of one lane on this pipeline (a separate
    throwaway server, so the measured arms start cold)."""
    srv = Server(stages_, workers=(EGPU_16T,), bucket_sizes=(BUCKET,),
                 max_batch=MAX_BATCH, device=dev)
    for x in requests(MAX_BATCH, 99, dev):
        srv.submit(x)
    srv.flush()
    spr = srv.dispatcher.workers[0].modeled_s_per_request()
    assert spr is not None and spr > 0
    return spr


def _run_arm(stages_, xs, arrivals, budget, admission, dev, fault_plan=None,
             tracer=None):
    clk = VClock()
    srv = Server(stages_, workers=(EGPU_16T,) * N_LANES,
                 bucket_sizes=(BUCKET,), max_batch=MAX_BATCH,
                 max_pending=MAX_PENDING, admission=admission,
                 deadline_flush=admission, fault_plan=fault_plan,
                 breaker_threshold=2, breaker_cooldown=4, clock=clk,
                 tracer=tracer, device=dev)
    accepted = []
    max_backlog = 0.0
    max_pending_depth = 0
    for i, (x, t_arr) in enumerate(zip(xs, arrivals)):
        clk.t = t_arr
        srv.tick()                       # deadline pump between arrivals
        backlog = min(max(0.0, w.modeled_busy_until - clk.t)
                      for w in srv.dispatcher.workers)
        max_backlog = max(max_backlog, backlog)
        try:
            accepted.append((i, srv.submit(x, deadline=budget)))
        except AdmissionError:
            pass
        max_pending_depth = max(max_pending_depth, srv.batcher.n_pending)
    srv.flush()
    return srv, accepted, max_backlog, max_pending_depth


def _served_match_eager(srv, accepted, xs, stages_, apu, refs):
    """Every served request of an arm against the eager offload of it alone
    (bit for bit); returns how many were checked."""
    n = 0
    for i, rid in accepted:
        try:
            (got,) = srv.result(rid)
        except AdmissionError:
            continue                     # shed after acceptance: loud, fine
        if i not in refs:
            outs, _ = apu.offload(stages_, (xs[i],), mode="eager")
            refs[i] = outs[0].data
        assert torch.equal(got, refs[i]), (
            f"request {i}: served result diverged from the eager path")
        n += 1
    return n


def run(device: Any = "cuda", trace_path=None):
    dev = resolve_device(device)
    print("=" * 76)
    print(f"Open-loop overload: Poisson arrivals at {OFFERED_X:.1f}x modeled "
          f"saturation, {N_LANES} lanes, on {dev.type}")
    print(f"({N_REQUESTS} requests, chain of {CHAIN} {D}x{D} GeMM stages, "
          f"bucket {BUCKET}, batch {MAX_BATCH}; modeled virtual time)")
    print("=" * 76)
    stages_ = stages(dev)
    spr = _profile_spr(stages_, dev)
    batch_s = spr * MAX_BATCH            # one micro-batch's service time
    budget = 4.0 * batch_s               # per-request deadline budget
    sat_rate = N_LANES / spr             # fleet saturation, requests/s
    rng = np.random.default_rng(7)       # arrival process (fixed, all arms)
    arrivals = np.cumsum(rng.exponential(
        1.0 / (OFFERED_X * sat_rate), N_REQUESTS))
    xs = requests(N_REQUESTS, 21, dev)
    print(f"  modeled {spr * 1e6:8.2f} us/request -> saturation "
          f"{sat_rate:,.0f} req/s, deadline budget {budget * 1e6:.1f} us")

    def _fault_plan():
        # a fresh plan per arm: draws are pure functions of the seed, so the
        # arms see identical faults, and injection counters stay per arm
        return FaultPlan(
            seed=env_seed(42), p_launch_fail=0.05,
            blackouts=(Blackout("0:e-gpu-16t", start=5, length=7),))

    fault_plan = _fault_plan()
    tracer = Tracer()
    arms = {
        "fifo": _run_arm(stages_, xs, arrivals, budget, False, dev),
        "shed": _run_arm(stages_, xs, arrivals, budget, True, dev),
        "shed_faulted": _run_arm(stages_, xs, arrivals, budget, True, dev,
                                 fault_plan=fault_plan),
        "shed_faulted_traced": _run_arm(stages_, xs, arrivals, budget, True,
                                        dev, fault_plan=_fault_plan(),
                                        tracer=tracer),
    }

    # bit-identity of every served request of the faulted arms (whose
    # batches were rerouted and retried) against the eager path
    apu = APU(EGPU_16T, device=dev)
    refs = {}
    srv_f, accepted_f, _, _ = arms["shed_faulted"]
    n_checked = _served_match_eager(srv_f, accepted_f, xs, stages_, apu, refs)
    assert n_checked > 0
    # the traced arm accounts for every accepted request: one complete span
    # tree per rid, ending in exactly one terminal
    srv_t, accepted_t, _, _ = arms["shed_faulted_traced"]
    assert tracer.request_rids() == sorted(rid for _, rid in accepted_t)
    tree_errors = tracer.validate_request_trees()
    assert not tree_errors, tree_errors
    n_traced_served = _served_match_eager(srv_t, accepted_t, xs, stages_, apu,
                                          refs)

    goodput = {}
    rows = {}
    for name, (srv, accepted, max_backlog, max_depth) in arms.items():
        rep = srv.report()
        goodput[name] = rep.goodput_per_s_modeled
        rows[name] = dict(
            accepted=len(accepted), shed=rep.n_shed,
            violations=rep.n_deadline_violations,
            deadline_flushes=rep.deadline_flushes,
            retries=rep.n_retries, quarantines=rep.n_quarantines,
            dispatch_failures=rep.n_dispatch_failures,
            max_backlog_s=max_backlog, max_pending_depth=max_depth)
        print(f"  {name:12s} goodput {rep.goodput_per_s_modeled:10,.0f} "
              f"req/s modeled  {len(accepted):3d} accepted  "
              f"{rep.n_shed:3d} shed  {rep.n_deadline_violations:3d} late  "
              f"backlog <= {max_backlog * 1e6:8.1f} us")

    # zero-perturbation gate: tracing must not move a single modeled number
    assert goodput["shed_faulted_traced"] == goodput["shed_faulted"], (
        "tracing perturbed modeled goodput")
    assert rows["shed_faulted_traced"] == rows["shed_faulted"], (
        "tracing perturbed the modeled serving outcome")

    trace_doc = tracer.to_chrome_json(trace_path)
    schema_errors = validate_chrome_trace(trace_doc)
    assert not schema_errors, schema_errors
    if trace_path is not None:
        print(f"  traced arm: {len(tracer.spans)} spans over "
              f"{len(tracer.request_rids())} request trees -> {trace_path}")

    fifo = max(goodput["fifo"], 1e-12)
    speedup = goodput["shed"] / fifo
    speedup_faulted = goodput["shed_faulted"] / fifo
    print(f"\n  shedding goodput {speedup:.2f}x fifo; with a lane killed + "
          f"5% launch failures {speedup_faulted:.2f}x (>= {GATE_X}x gate)")
    print(f"  faulted arm: {rows['shed_faulted']['retries']} retries, "
          f"{rows['shed_faulted']['quarantines']} quarantines, "
          f"{n_checked} served results bit-identical to eager")
    assert speedup >= GATE_X and speedup_faulted >= GATE_X, (
        f"shedding goodput {speedup:.3f}x / {speedup_faulted:.3f}x fifo, "
        f"under the {GATE_X}x gate")
    # bounded queues: shedding caps the modeled backlog near the deadline
    # budget while FIFO's grows with the run length
    for name in ("shed", "shed_faulted"):
        assert rows[name]["max_backlog_s"] <= 2.0 * budget, (
            name, rows[name]["max_backlog_s"], budget)
        assert rows[name]["max_pending_depth"] <= MAX_PENDING
    assert rows["fifo"]["max_backlog_s"] > 3.0 * budget

    return {
        "bench": "overload",
        "offered_x": OFFERED_X,
        "n_requests": N_REQUESTS,
        "n_lanes": N_LANES,
        "chain_len": CHAIN,
        "bucket": BUCKET,
        "max_batch": MAX_BATCH,
        "max_pending": MAX_PENDING,
        "modeled_us_per_request": spr * 1e6,
        "deadline_budget_us": budget * 1e6,
        "fault_seed": fault_plan.seed,
        "goodput_modeled": goodput,
        "goodput_vs_fifo_speedup": speedup,
        "goodput_faulted_vs_fifo_speedup": speedup_faulted,
        "arms": rows,
        "bit_identical_under_faults": True,
        "n_bit_identity_checked": n_checked,
        "trace": {
            "n_spans": len(tracer.spans),
            "n_request_trees": len(tracer.request_rids()),
            "n_traced_served": n_traced_served,
            "request_trees_complete": not tree_errors,
            "schema_valid": not schema_errors,
            "path": None if trace_path is None else str(trace_path),
        },
    }


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="write the traced arm's Chrome trace JSON here")
    args = parser.parse_args()
    run(args.device, trace_path=args.trace)
