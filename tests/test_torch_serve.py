"""The port's serving stack (``repro_torch.serve``) held against the JAX
package on the CPU.

Scenarios in the manner of the reference's serve, fault, power, obs and
trace tests are replayed through both packages' ``Server`` on a virtual
clock with the same numpy requests.  The comparisons:

* every ``ServeReport`` field but the three measured on the host's clock
  (``wall_s``, ``requests_per_s``, ``goodput_per_s``): ``==`` — the machine
  model, the batcher, the dispatcher and the admission rules are plain
  Python over the same counts;
* the cache stats, the published metrics (snapshot and Prometheus text),
  the shed decisions and their messages, the request span trees and the
  Chrome trace: ``==``;
* the outputs: the f32 matmul of a small MLP, summed in another order by
  XLA and by PyTorch on the CPU: rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs as jobs
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro.kernels.gemm.ref import counts as j_gemm_counts
from repro.kernels.gemm.ref import gemm_ref as j_gemm_ref
from repro_torch.kernels.gemm.ref import counts as t_gemm_counts
from repro_torch.kernels.gemm.ref import gemm_ref as t_gemm_ref

MEASURED = ("wall_s", "requests_per_s", "goodput_per_s")
D = 8


class VClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stages(pkg, n=2, d=D, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, d)) * 0.2).astype(np.float32)
    if pkg == "jax":
        k = jcore.Kernel("mlp",
                         executor=lambda x, w: jnp.maximum(j_gemm_ref(x, w), 0.0),
                         counts=lambda **kw: j_gemm_counts(m=d, n=d, k=d))
        return [jcore.Stage(k, consts=(jnp.asarray(w),), n_inputs=1)
                for _ in range(n)]
    k = tcore.Kernel("mlp",
                     executor=lambda x, w: torch.clamp_min(t_gemm_ref(x, w), 0.0),
                     counts=lambda **kw: t_gemm_counts(m=d, n=d, k=d))
    return [tcore.Stage(k, consts=(torch.as_tensor(w),), n_inputs=1)
            for _ in range(n)]


def _mods(pkg):
    return (jcore, jserve, jobs) if pkg == "jax" else (tcore, tserve, tobs)


def _server(pkg, clock, workers=("16T",), fault=None, budget=None,
            tracer=False, **kw):
    core, serve, obs = _mods(pkg)
    points = core.OPERATING_POINTS
    cfgs = []
    for w in workers:
        name, _, point = w.partition("@")
        cfg = getattr(core, f"EGPU_{name}")
        cfgs.append(cfg.at(points[point]) if point else cfg)
    plan = None
    if fault is not None:
        plan = serve.FaultPlan(
            seed=fault.get("seed", 0), p_launch_fail=fault.get("p_fail", 0.0),
            p_latency_spike=fault.get("p_spike", 0.0),
            latency_spike_s=fault.get("spike_s", 0.0),
            blackouts=tuple(serve.Blackout(*b) for b in fault.get("blackouts", ())))
    extra = {} if pkg == "jax" else {"device": "cpu"}
    tr = obs.Tracer() if tracer else None
    srv = serve.Server(
        _stages(pkg, n=kw.pop("n_stages", 2)), workers=tuple(cfgs),
        clock=clock, fault_plan=plan, tracer=tr,
        power_budget=None if budget is None else serve.PowerBudget(**budget),
        **kw, **extra)
    return srv, tr


def _play(pkg, events, requests, **server_kw):
    """Drive one server through ``events``; returns what the comparison
    reads."""
    clock = VClock()
    srv, tr = _server(pkg, clock, **server_kw)
    arr = (lambda a: jnp.asarray(a)) if pkg == "jax" else torch.as_tensor
    _, serve, _ = _mods(pkg)
    door, rids = [], []
    for ev in events:
        kind = ev[0]
        if kind == "submit":
            _, i, t, deadline, priority = ev
            clock.t = t
            try:
                rids.append(srv.submit(arr(requests[i]), deadline=deadline,
                                       priority=priority))
            except serve.AdmissionError as e:
                door.append(str(e))
        elif kind == "tick":
            clock.t = ev[1]
            srv.tick()
        elif kind == "flush":
            clock.t = ev[1]
            srv.flush()
    outcomes = {}
    for rid in rids:
        try:
            outcomes[rid] = ("ok", np.asarray(srv.result(rid)[0]))
        except serve.AdmissionError as e:
            outcomes[rid] = ("shed", str(e))
        except KeyError as e:               # evicted from the results window
            outcomes[rid] = ("evicted", str(e))
    rep = srv.report()
    reg = srv.publish_metrics()
    return dict(report=rep, door=door, outcomes=outcomes, tracer=tr,
                cache=srv.cache.stats(), metrics=reg.snapshot(),
                prom=reg.to_prometheus_text(), summary=rep.summary())


def _modeled(rep):
    return {k: v for k, v in dataclasses.asdict(rep).items() if k not in MEASURED}


def _requests(n, seed, lengths=(4,)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((lengths[i % len(lengths)], D)).astype(np.float32)
            for i in range(n)]


def _events(n, seed, dt=1e-4, deadline=None, priorities=(0,), final=1.0):
    rng = np.random.default_rng(seed)
    t, evs = 0.0, []
    for i in range(n):
        t += float(rng.random()) * dt
        evs.append(("submit", i, t,
                    None if deadline is None else deadline(i, rng),
                    priorities[i % len(priorities)]))
    evs.append(("flush", t + final))
    return evs


SCENARIOS = {
    # serve: ragged lengths over two buckets, heterogeneous lanes
    "buckets, 16T + 8T": dict(
        requests=_requests(11, 1, lengths=(3, 8, 5, 16)),
        events=_events(11, 2),
        server=dict(workers=("16T", "8T"), bucket_sizes=(8, 16), max_batch=4)),
    "one lane, max_batch 1": dict(
        requests=_requests(5, 3), events=_events(5, 4),
        server=dict(workers=("16T",), bucket_sizes=(8,), max_batch=1,
                    max_in_flight=1)),
    "results window and evictions": dict(
        requests=_requests(9, 5), events=_events(9, 6),
        server=dict(workers=("16T",), bucket_sizes=(8,), max_batch=2,
                    metrics_window=3)),
    # admission: a bounded queue with priority preemption, infeasible
    # deadlines shed at the door, deadline flushes of partial buckets
    "admission and preemption": dict(
        requests=_requests(12, 7), events=_events(
            12, 8, priorities=(0, 2, 1), deadline=lambda i, r: 10.0),
        server=dict(workers=("16T", "8T"), bucket_sizes=(8,), max_batch=4,
                    max_pending=3)),
    "tight deadlines and flushes": dict(
        requests=_requests(10, 9), events=_events(
            10, 10, dt=2e-3, deadline=lambda i, r: float(r.uniform(1e-5, 5e-3)))
        + [("tick", 1.0)],
        server=dict(workers=("8T",), bucket_sizes=(8,), max_batch=4)),
    # faults: blackouts, seeded failures and spikes, breakers
    "blackout and retries": dict(
        requests=_requests(10, 11), events=_events(10, 12, deadline=lambda i, r: 10.0,
                                                   priorities=(0, 1, 2)),
        server=dict(workers=("16T", "16T"), bucket_sizes=(8,), max_batch=2,
                    max_pending=8, breaker_threshold=2, breaker_cooldown=2,
                    fault=dict(seed=3, p_fail=0.3, p_spike=0.2, spike_s=1e-4,
                               blackouts=[("0:e-gpu-16t", 1, 3)]))),
    "every lane dark": dict(
        requests=_requests(4, 13), events=_events(4, 14),
        server=dict(workers=("16T",), bucket_sizes=(8,), max_batch=2,
                    fault=dict(blackouts=[("0:e-gpu-16t", 0, 100)]))),
    "latency spikes": dict(
        requests=_requests(8, 15), events=_events(8, 16),
        server=dict(workers=("16T", "8T"), bucket_sizes=(8,), max_batch=2,
                    fault=dict(seed=5, p_spike=1.0, spike_s=2e-3))),
    # power: caps that throttle the hot lane, and one no lane meets
    "power caps": dict(
        requests=_requests(12, 17), events=_events(12, 18),
        server=dict(workers=("16T@turbo", "16T", "16T@low"), bucket_sizes=(8,),
                    max_batch=2, budget=dict(lane_mw=28.0, fleet_mw=35.0))),
    "impossible power budget": dict(
        requests=_requests(4, 19), events=_events(4, 20),
        server=dict(workers=("16T", "8T"), bucket_sizes=(8,), max_batch=2,
                    budget=dict(lane_mw=1e-6))),
    "fleet cap with spikes": dict(
        requests=_requests(10, 21), events=_events(10, 22),
        server=dict(workers=("8T@low", "16T"), bucket_sizes=(8,), max_batch=2,
                    budget=dict(fleet_mw=30.0),
                    fault=dict(seed=14, p_spike=0.3, spike_s=1e-3))),
    # obs: a traced session, and a traced fault session
    "traced": dict(
        requests=_requests(6, 23), events=_events(6, 24, dt=0.01),
        server=dict(workers=("16T",), bucket_sizes=(8,), max_batch=2,
                    tracer=True)),
    "traced faults": dict(
        requests=_requests(10, 25), events=_events(10, 26, deadline=lambda i, r: 10.0),
        server=dict(workers=("16T", "16T"), bucket_sizes=(8,), max_batch=2,
                    max_pending=8, breaker_threshold=2, breaker_cooldown=2,
                    tracer=True,
                    fault=dict(seed=4, p_fail=0.3,
                               blackouts=[("0:e-gpu-16t", 1, 2)]))),
}


def _spans(tr):
    return [(s.span_id, s.name, s.track, s.t0, s.t1, s.parent_id, s.rid,
             s.attrs, s.events) for s in tr.spans]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_reports_equal_the_reference(name):
    sc = SCENARIOS[name]
    got, want = (_play(pkg, sc["events"], sc["requests"], **dict(sc["server"]))
                 for pkg in ("torch", "jax"))
    assert _modeled(got["report"]) == _modeled(want["report"])
    assert got["cache"] == want["cache"]
    assert got["door"] == want["door"]
    assert got["metrics"] == want["metrics"]
    assert got["prom"] == want["prom"]
    assert got["outcomes"].keys() == want["outcomes"].keys()
    for rid, (kind, val) in got["outcomes"].items():
        wkind, wval = want["outcomes"][rid]
        assert kind == wkind, rid
        if kind == "ok":
            np.testing.assert_allclose(val, wval, rtol=1e-5, atol=1e-6)
        else:
            assert val == wval
    if got["tracer"] is not None:
        assert _spans(got["tracer"]) == _spans(want["tracer"])
        assert got["tracer"].instants == want["tracer"].instants
        assert got["tracer"].validate_request_trees() == []
        doc = got["tracer"].to_chrome_json()
        assert doc == want["tracer"].to_chrome_json()
        assert tobs.validate_chrome_trace(doc) == []


def test_scenarios_exercise_what_they_name():
    """The parity above is only as good as the paths it drives."""
    reps = {n: _play("torch", s["events"], s["requests"], **dict(s["server"]))
            for n, s in SCENARIOS.items()}
    assert reps["admission and preemption"]["report"].n_shed > 0
    assert any(k == "shed" for k, _ in
               reps["admission and preemption"]["outcomes"].values())
    assert reps["tight deadlines and flushes"]["report"].deadline_flushes > 0
    assert reps["blackout and retries"]["report"].n_retries > 0
    assert reps["every lane dark"]["report"].n_dispatch_failures > 0
    assert reps["power caps"]["report"].n_power_throttled > 0
    assert reps["power caps"]["report"].queues[0].batches == 0
    assert reps["impossible power budget"]["report"].n_power_shed == 4
    assert reps["results window and evictions"]["report"].results_evicted > 0
    assert reps["traced faults"]["tracer"].instants or any(
        ev[1] == "fault" for s in reps["traced faults"]["tracer"].spans
        for ev in s.events)
    for r in reps.values():
        assert r["report"].n_budget_violations == 0


# ---------------------------------------------------------------------------
# the pieces, on the port alone
# ---------------------------------------------------------------------------
def test_pad_to_and_batcher_collation():
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    p = tserve.pad_to(x, 5, axis=0, fill=-1)
    assert p.shape == (5, 2) and torch.equal(p[3:], torch.full((2, 2), -1.0))
    assert tserve.pad_to(x, 3) is x
    with pytest.raises(ValueError, match="exceeds"):
        tserve.pad_to(x, 2)
    b = tserve.BucketBatcher((4, 8), max_batch=3, fill=0, device="cpu")
    b.submit(np.ones((3, 2), np.float32))
    b.submit(torch.ones(6, 2))
    (mb4, mb8) = sorted(b.drain(), key=lambda m: m.bucket_key)
    assert mb4.inputs[0].shape == (3, 4, 2) and mb8.inputs[0].shape == (3, 8, 2)
    assert b.padded_elements == 2 + 2 * 8 + 4 + 2 * 16
    rows = mb4.crop((mb4.inputs[0] * 2,))
    assert rows[0][0].shape == (3, 2)
    for bad in ((), (0, 4), (4, 4), (8, 4)):
        with pytest.raises(ValueError):
            tserve.BucketBatcher(bad)


def test_batched_stages_scale_counts_and_keep_registry_identity():
    prog = tcore.Program.build(tcore.EGPU_16T)
    st = tcore.Stage(prog.create_kernel("fir"), consts=(torch.ones(4),),
                     counts_params={"n": 64, "taps": 4})
    (bst,) = tserve.batched_stages([st], 3)
    assert bst.kernel.variant == st.kernel.variant + (("__batched__", 3),)
    assert (bst.kernel.family, bst.kernel.config) == (st.kernel.family, st.kernel.config)
    one = st.kernel.counts(n=64, taps=4)
    assert bst.kernel.counts(n=64, taps=4) == one.scaled(3)
    x = torch.randn(3, 64)
    y = bst.kernel.executor(x, torch.ones(4))
    assert all(torch.equal(y[i], st.kernel.executor(x[i], torch.ones(4)))
               for i in range(3))


def test_cache_keys_carry_the_torch_device():
    stages = _stages("torch")
    cache = tserve.GraphCache(4)
    apu = tcore.APU(tcore.EGPU_16T, device="cpu", graph_cache=cache)
    x = torch.randn(4, D)
    o1, r1 = apu.offload(stages, (x,))
    o2, r2 = apu.offload(stages, (x.numpy(),))
    assert (cache.hits, cache.misses) == (1, 1) and r1 is r2
    assert torch.equal(o1[0].data, o2[0].data)
    key = cache.key_for(apu, stages, (x,))
    assert key[-1] == (((4, D), "torch.float32", "cpu"),)
    # the same content in other weights is another entry
    apu.offload(_stages("torch", seed=3), (x,))
    assert cache.misses == 2


def test_cached_offload_equals_a_fresh_capture():
    stages = _stages("torch", n=3)
    x = torch.randn(4, D)
    fresh, rep = tcore.APU(tcore.EGPU_16T, device="cpu").offload(stages, (x,))
    apu = tcore.APU(tcore.EGPU_16T, device="cpu", graph_cache=tserve.GraphCache())
    for _ in range(2):
        got, rep_c = apu.offload(stages, (x,))
        assert torch.equal(got[0].data, fresh[0].data)
        assert dataclasses.asdict(rep_c) == dataclasses.asdict(rep)


def test_retirement_waits_on_its_own_segment_only():
    """Backpressure retires the oldest ticket and releases exactly its
    queue events; later tickets stay in flight."""
    w = tserve.QueueWorker(tcore.EGPU_16T, max_in_flight=1, device="cpu",
                           clock=VClock())
    cache = tserve.GraphCache()
    stages = tserve.batched_stages(_stages("torch"), 2)
    batcher = tserve.BucketBatcher((8,), max_batch=2, device="cpu")
    for _ in range(4):
        batcher.submit(torch.randn(4, D))
    mbs = batcher.pop_full()
    graph, _ = cache.get_or_capture(w.apu, stages, mbs[0].inputs)
    t1, r1 = w.launch(graph, mbs[0])
    assert r1 == [] and len(w.queue.events) == len(graph.nodes)
    t2, r2 = w.launch(graph, mbs[1])
    assert r2 == [t1] and t1.done and not t2.done
    assert len(w.queue.events) == len(graph.nodes)
    assert w.queue.released_count == len(graph.nodes)
    assert w.drain() == [t2] and w.queue.events == ()


def test_server_on_the_cpu_matches_its_own_offloads():
    stages = _stages("torch")
    srv = tserve.Server(stages, workers=(tcore.EGPU_16T, tcore.EGPU_8T),
                        bucket_sizes=(8,), max_batch=3, device="cpu")
    assert srv.warmup(np.zeros((8, D), np.float32)) == 2
    xs = [torch.randn(8, D) for _ in range(7)]
    rids = [srv.submit(x) for x in xs]
    srv.flush()
    apu = tcore.APU(tcore.EGPU_16T, device="cpu")
    for rid, x in zip(rids, xs):
        (got,) = srv.result(rid)
        want, _ = apu.offload(stages, (x,))
        assert torch.equal(got, want[0].data)
    assert srv.cache.misses == 2


def test_entry_points_default_to_the_card_and_refuse_what_is_not_ported():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.QueueWorker(tcore.EGPU_16T)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.Server(_stages("torch"))
    with pytest.raises(NotImplementedError, match="step 2"):
        tserve.Server(_stages("torch"), engine=object(), device="cpu")
    srv = tserve.Server(_stages("torch"), device="cpu")
    with pytest.raises(NotImplementedError, match="step 2"):
        srv.submit_decode(np.zeros(3, np.int32), 4)
    with pytest.raises(NotImplementedError, match="step 2"):
        next(iter(srv.stream(0)))
    for name, step in (("ShardedWorker", "step 9"), ("DecodeEngine", "step 2"),
                       ("EngineHTTPServer", "step 2")):
        with pytest.raises(NotImplementedError, match=step):
            getattr(tserve, name)


def test_bench_serve_runs_on_the_cpu():
    """``benchmarks_torch/bench_serve.py`` on the CPU: one capture for
    every cached offload, and a traced arm with complete request trees."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks_torch import bench_serve
    (row,) = bench_serve.run("cpu")
    assert row["cache_stats"]["misses"] == 1
    assert row["cache_stats"]["hits"] == bench_serve.TRIALS * bench_serve.REPS
    assert row["trace"] == {"n_spans": row["trace"]["n_spans"], "n_request_trees": 8,
                            "request_trees_complete": True, "schema_valid": True}
    assert row["per_offload_us"]["cached"] > 0


@pytest.mark.parametrize("point", ["low", "turbo"])
def test_op_point_from_the_environment_equals_the_reference(monkeypatch, point):
    """``REPRO_OP_POINT`` rebases the anchor-point lanes: modeled time and
    power move alike in both packages, the outputs do not move."""
    sc = SCENARIOS["buckets, 16T + 8T"]
    base = _play("torch", sc["events"], sc["requests"], **dict(sc["server"]))
    monkeypatch.setenv("REPRO_OP_POINT", point)
    got, want = (_play(pkg, sc["events"], sc["requests"], **dict(sc["server"]))
                 for pkg in ("torch", "jax"))
    assert _modeled(got["report"]) == _modeled(want["report"])
    assert _modeled(got["report"]) != _modeled(base["report"])
    for rid, (kind, val) in got["outcomes"].items():
        assert kind == "ok" and np.array_equal(val, base["outcomes"][rid][1])


def test_a_submitted_numpy_request_is_copied():
    """An edit of the caller's array after submit never reaches the
    request (host data is copied at intake, as the reference's immutable
    arrays are)."""
    srv = tserve.Server(_stages("torch"), bucket_sizes=(8,), max_batch=2,
                        device="cpu")
    x = np.random.default_rng(0).standard_normal((8, D)).astype(np.float32)
    want, _ = tcore.APU(tcore.EGPU_16T, device="cpu").offload(
        _stages("torch"), (torch.tensor(x),))
    rid = srv.submit(x)
    x[:] = 0.0
    srv.flush()
    assert torch.equal(srv.result(rid)[0], want[0].data)
