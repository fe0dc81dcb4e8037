"""Power-budget serving: goodput-per-watt under the paper's envelope.

The port of ``benchmarks/bench_power.py``.  One fleet, three DVFS operating
points (``repro_torch.core.OPERATING_POINTS``) on the same e-GPU silicon —
``turbo`` (450 MHz @ 0.95 V), the paper's ``nominal`` anchor (300 MHz @
0.8 V) and ``low`` (100 MHz @ 0.60 V).  Two arms over the same request
payloads:

* **uncapped** — depth-based routing spreads micro-batches evenly across
  all three lanes;
* **capped** — the same fleet under ``PowerBudget(lane_mw=28,
  fleet_mw=35)``: the dispatcher prices every candidate lane's
  window-average power, throttles the turbo lane and routes the rest by
  requests-per-joule, so the envelope holds by construction.

Everything is modeled virtual time and machine-model energy, so every row
is deterministic and equals the JAX bench's; the gate is capped
goodput-per-watt >= 1.2x uncapped, with zero booked budget violations, a
non-zero throttle count and bit-identical outputs across the arms.  The
served GeMM stages are the plain ``gemm_ref``, as in the JAX bench.
``run()`` prints and returns the JAX bench's result keys; it writes no
file.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_power [--device cpu]
"""

from typing import Any

import torch

from repro_torch.core import EGPU_16T, OPERATING_POINTS
from repro_torch.core.runtime import resolve_device
from repro_torch.serve import PowerBudget, Server

from ._gemm_chain import (BUCKET, CHAIN, MAX_BATCH, D, VClock, requests,
                          stages)

N_REQUESTS = 96
LANE_MW = 28.0     # the paper's per-lane envelope
FLEET_MW = 35.0    # nominal + low lanes flat out + turbo's leakage floor
GATE_X = 1.2       # capped goodput-per-watt vs uncapped

#: the three DVFS lanes: same silicon, different operating points
LANE_POINTS = ("turbo", "nominal", "low")


def _fleet():
    return tuple(EGPU_16T.at(OPERATING_POINTS[p]) for p in LANE_POINTS)


def _run_arm(stages_, xs, budget, dev):
    clk = VClock()
    srv = Server(stages_, workers=_fleet(), bucket_sizes=(BUCKET,),
                 max_batch=MAX_BATCH, clock=clk, power_budget=budget,
                 device=dev)
    rids = [srv.submit(x) for x in xs]
    srv.flush()
    outs = [srv.result(rid) for rid in rids]
    return srv, srv.report(), outs


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print(f"Power-budget serving: {len(LANE_POINTS)} DVFS lanes "
          f"({'/'.join(LANE_POINTS)}), capped vs latency-greedy, on "
          f"{dev.type}")
    print(f"({N_REQUESTS} requests, chain of {CHAIN} {D}x{D} GeMM stages, "
          f"bucket {BUCKET}, batch {MAX_BATCH}; modeled virtual time)")
    print("=" * 76)
    stages_ = stages(dev)
    xs = requests(N_REQUESTS, 21, dev)
    budget = PowerBudget(lane_mw=LANE_MW, fleet_mw=FLEET_MW)

    _, rep_free, outs_free = _run_arm(stages_, xs, None, dev)
    _, rep_cap, outs_cap = _run_arm(stages_, xs, budget, dev)

    for name, rep in (("uncapped", rep_free), ("capped", rep_cap)):
        print(f"  {name:9s} gpw {rep.goodput_per_s_per_watt:12,.0f} "
              f"req/J  avg {rep.avg_fleet_power_w * 1e3:6.2f} mW  "
              f"energy {rep.fleet_energy_j * 1e6:8.1f} uJ "
              f"(idle {rep.fleet_idle_energy_j * 1e6:6.1f})  "
              f"{rep.n_power_throttled:3d} throttled  "
              f"{rep.n_power_shed:3d} shed")
        for qs, point in zip(rep.queues, LANE_POINTS):
            print(f"      lane {point:8s} {qs.batches:3d} batches "
                  f"{qs.requests:3d} reqs  {qs.energy_j * 1e6:8.1f} uJ")

    # both arms complete every request on identical payloads: the caps
    # reroute work, they never drop it
    assert rep_free.n_requests == N_REQUESTS, rep_free.n_requests
    assert rep_cap.n_requests == N_REQUESTS, rep_cap.n_requests
    assert rep_cap.n_power_shed == 0 and rep_cap.n_shed == 0

    # budget semantics: the turbo lane cannot fit 28 mW, so the capped arm
    # throttles it and routes it zero batches, with zero booked violations
    # and a bounded peak draw
    assert rep_cap.n_power_throttled > 0
    assert rep_cap.queues[LANE_POINTS.index("turbo")].batches == 0
    assert rep_cap.n_budget_violations == 0, rep_cap.n_budget_violations
    assert rep_cap.peak_fleet_power_w <= FLEET_MW * 1e-3 + 1e-12
    assert rep_free.n_power_throttled == 0  # uncapped arm never prices

    # DVFS never changes the math: both arms give bit-identical outputs
    for (a,), (b,) in zip(outs_free, outs_cap):
        assert torch.equal(a, b), "capped arm outputs diverged from uncapped"

    gpw_free = max(rep_free.goodput_per_s_per_watt, 1e-12)
    ratio = rep_cap.goodput_per_s_per_watt / gpw_free
    print(f"\n  capped goodput-per-watt {ratio:.2f}x uncapped "
          f"(>= {GATE_X:.1f}x gate), envelope lane<={LANE_MW:g} mW "
          f"fleet<={FLEET_MW:g} mW held with "
          f"{rep_cap.n_budget_violations} violations")
    assert ratio >= GATE_X, (
        f"goodput-per-watt {ratio:.3f}x under the {GATE_X:.1f}x gate")

    return {
        "bench": "power",
        "n_requests": N_REQUESTS,
        "lanes": list(LANE_POINTS),
        "chain_len": CHAIN,
        "bucket": BUCKET,
        "max_batch": MAX_BATCH,
        "lane_mw": LANE_MW,
        "fleet_mw": FLEET_MW,
        "goodput_per_s_per_watt": {
            "uncapped": rep_free.goodput_per_s_per_watt,
            "capped": rep_cap.goodput_per_s_per_watt,
        },
        "goodput_per_watt_speedup": ratio,
        "avg_fleet_power_mw": {
            "uncapped": rep_free.avg_fleet_power_w * 1e3,
            "capped": rep_cap.avg_fleet_power_w * 1e3,
        },
        "peak_fleet_power_mw": rep_cap.peak_fleet_power_w * 1e3,
        "fleet_energy_uj": {
            "uncapped": rep_free.fleet_energy_j * 1e6,
            "capped": rep_cap.fleet_energy_j * 1e6,
        },
        "idle_energy_uj": {
            "uncapped": rep_free.fleet_idle_energy_j * 1e6,
            "capped": rep_cap.fleet_idle_energy_j * 1e6,
        },
        "n_power_throttled": rep_cap.n_power_throttled,
        "n_power_shed": rep_cap.n_power_shed,
        "n_budget_violations": rep_cap.n_budget_violations,
        "bit_identical_across_arms": True,
    }


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args().device)
