"""The port's observability, graph sanitizer, fault and power pieces
(``repro_torch.obs``, ``repro_torch.analyze``, ``repro_torch.serve.faults``
and ``.power``) and the runtime options the serving stack calls, held
against the JAX package on the CPU.

Everything compared here is exact (``==``): the metrics registry, the
span tracer, the sanitizer, the fault draws and the lane prices are plain
Python over the same inputs in both packages, and the queue tracer's
spans are laid on the machine model's timeline, which the port reproduces
float for float.
"""

import dataclasses
import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analyze as janalyze
import repro.core as jcore
import repro.obs as jobs
import repro.serve as jserve
import repro_torch.analyze as tanalyze
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.serve as tserve

PACKAGES = {"jax": (jcore, jobs, jserve, janalyze),
            "torch": (tcore, tobs, tserve, tanalyze)}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _drive_registry(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("repro_things_total", "things that happened")
    c.inc(kind="a")
    c.inc(2.5, kind="b", lane="0:x")
    c.set_total(7, kind="a")
    c.set_total(7, kind="a")                       # idempotent snapshot
    g = reg.gauge("repro_level", "a level")
    g.set(0.25)
    g.set(-3.0, lane="1:y")
    g.inc(1.5, lane="1:y")
    h = reg.histogram("repro_latency_seconds", "latencies",
                      buckets=(1e-3, 1e-2, 1e-1))
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.02, 50):
        h.observe(float(v), lane="0:x")
    h.observe(5.0, lane="1:y")
    return reg


def test_metrics_snapshot_and_prometheus_text_equal_the_reference():
    regs = {k: _drive_registry(v[1]) for k, v in PACKAGES.items()}
    assert regs["torch"].snapshot() == regs["jax"].snapshot()
    assert regs["torch"].to_prometheus_text() == regs["jax"].to_prometheus_text()
    assert len(regs["torch"]) == len(regs["jax"]) == 3
    h = regs["torch"].get("repro_latency_seconds")
    assert h.quantile(0.5, lane="0:x") == \
        regs["jax"].get("repro_latency_seconds").quantile(0.5, lane="0:x")


def test_metric_kind_clash_raises_in_both():
    for _, obs, _, _ in PACKAGES.values():
        reg = obs.MetricsRegistry()
        reg.counter("repro_x")
        with pytest.raises(ValueError, match="already registered as counter"):
            reg.gauge("repro_x")


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
def _drive_tracer(obs):
    tr = obs.Tracer()
    tr.begin_request(0, 0.0, priority=1)
    tr.request_event(0, 0.001, "submit", n_pending=1)
    tr.begin_request(1, 0.0005)
    launch = tr.span("launch", 0.002, 0.004, track="lane:0:x",
                     n_requests=2, rids=[0, 1])
    tr.span("fir", 0.0021, 0.003, track="lane:0:x", parent=launch,
            kind="kernel")
    tr.instant("lane:0:x", 0.0045, "retire", n_events=4)
    tr.child(0, "bucket-wait", 0.0, 0.002)
    tr.child(0, "dispatch", 0.002, 0.0021, lane="0:x")
    tr.child(0, "execute", 0.0021, 0.004, lane="0:x", batch_requests=2)
    tr.finish_request(0, 0.004, "result")
    tr.request_event(1, 0.003, "fault", lane="0:x", reason="blackout")
    tr.finish_request(1, 0.005, "shed", reason="dispatch failed")
    tr.instant("server", 0.006, "shed-at-door", reason="queue full")
    return tr


def _spans(tr):
    return [(s.span_id, s.name, s.track, s.t0, s.t1, s.parent_id, s.rid,
             s.attrs, s.events) for s in tr.spans]


def test_span_trees_and_chrome_json_equal_the_reference():
    trs = {k: _drive_tracer(v[1]) for k, v in PACKAGES.items()}
    assert _spans(trs["torch"]) == _spans(trs["jax"])
    assert trs["torch"].instants == trs["jax"].instants
    assert trs["torch"].request_rids() == trs["jax"].request_rids() == [0, 1]
    assert trs["torch"].validate_request_trees() == \
        trs["jax"].validate_request_trees() == []
    doc = trs["torch"].to_chrome_json()
    assert doc == trs["jax"].to_chrome_json()
    assert tobs.validate_chrome_trace(doc) == jobs.validate_chrome_trace(doc) == []


def test_incomplete_trees_are_reported_alike():
    reports = []
    for _, obs, _, _ in PACKAGES.values():
        tr = obs.Tracer()
        tr.begin_request(3, 0.0)
        tr.begin_request(4, 0.0)
        tr.finish_request(4, 1.0, "result")
        reports.append(tr.validate_request_trees())
    assert reports[0] == reports[1] and reports[0]


def _queue_trace(core, obs, array):
    ctx = core.Context(core.Device(core.EGPU_16T)) if core is jcore else \
        core.Context(core.Device(core.EGPU_16T), "cpu")
    tr = obs.Tracer()
    q = core.CommandQueue(ctx, tracer=tr)
    prog = core.Program.build(core.EGPU_16T)
    fir = prog.create_kernel("fir")
    x, h = array(np.linspace(-1, 1, 256)), array(np.hamming(16))
    ndr = core.optimal_ndrange(256, core.EGPU_16T)
    ev = q.enqueue_nd_range(fir, ndr, (ctx.create_buffer(x), ctx.create_buffer(h)),
                            counts_params={"n": 256, "taps": 16})
    buf = ctx.create_buffer(x)
    q.enqueue_write_buffer(buf, x)
    q.enqueue_marker()
    q.enqueue_read_buffer(ev.outputs[0])
    q.finish()
    return tr


def test_queue_tracer_spans_follow_the_modeled_timeline():
    """A traced queue books one span per event, end to end on its modeled
    timeline; the port's spans equal the reference's (names, track, t0,
    t1).  Their ``dispatch_s`` attribute is the host's clock, as in the
    reference, so it is left out of the comparison."""
    trs = {"jax": _queue_trace(jcore, jobs, lambda a: jnp.asarray(a, jnp.float32)),
           "torch": _queue_trace(tcore, tobs,
                                 lambda a: torch.tensor(a, dtype=torch.float32))}
    key = lambda tr: [(s.name, s.track, s.t0, s.t1) for s in tr.spans]
    assert key(trs["torch"]) == key(trs["jax"])
    assert [s.name for s in trs["torch"].spans] == [
        "fir", "write_buffer", "marker", "read_buffer"]
    assert trs["torch"].spans[-1].t1 > 0.0


# ---------------------------------------------------------------------------
# graph sanitizer
# ---------------------------------------------------------------------------
def _node(name, in_slots=(), out_slots=(), deps=(), kind="kernel",
          overwrites=()):
    return SimpleNamespace(kernel=SimpleNamespace(name=name),
                           in_slots=tuple(in_slots), out_slots=tuple(out_slots),
                           deps=tuple(deps), kind=kind,
                           overwrites=tuple(overwrites))


def _graph(nodes, ext=(), flags=None, outputs=None, ext_values=()):
    g = SimpleNamespace(nodes=list(nodes), _ext_slots=list(ext),
                        _slot_flags=dict(flags or {}),
                        _ext_values=list(ext_values))
    if outputs is not None:
        g._output_slots = lambda: tuple(outputs)
    return g


_shared = object()
HAZARDS = {
    "waw dual producers": (_graph([_node("p1", out_slots=(0,)),
                                   _node("p2", out_slots=(0,)),
                                   _node("r", in_slots=(0,), out_slots=(1,),
                                         deps=(0, 1))]), ()),
    "waw unordered overwrite": (_graph(
        [_node("p", out_slots=(1,), in_slots=(0,)),
         _node("w", kind="write", in_slots=(2,), out_slots=(3,),
               overwrites=(1,))], ext=(0, 2)), ()),
    "use after donate": (_graph(
        [_node("stray", in_slots=(0,), out_slots=(2,)),
         _node("main", in_slots=(1,), out_slots=(3,))],
        ext=(0, 1), outputs=(3,)), (0,)),
    "donation on the ordered path": (_graph(
        [_node("a", in_slots=(0,), out_slots=(1,)),
         _node("b", in_slots=(1,), out_slots=(2,), deps=(0,))],
        ext=(0,), outputs=(2,)), (0,)),
    "double donation": (_graph([_node("a", in_slots=(0, 1), out_slots=(2,))],
                               ext=(0, 1)), (0, 0)),
    "aliased donation": (_graph([_node("a", in_slots=(0, 1), out_slots=(2,))],
                                ext=(0, 1), ext_values=(_shared, _shared)),
                         (0, 1)),
    "read of a write-only slot": (_graph(
        [_node("k", in_slots=(0,), out_slots=(1,))], ext=(0,),
        flags={0: "w"}), ()),
    "write into a read-only slot": (_graph(
        [_node("w", kind="write", in_slots=(0,), out_slots=(1,)),
         _node("k", in_slots=(1,), out_slots=(2,), deps=(0,))], ext=(0,),
        flags={1: "r"}), ()),
    "cycle": (_graph([_node("a", in_slots=(0,), out_slots=(1,), deps=(1,)),
                      _node("b", in_slots=(1,), out_slots=(2,), deps=(0,))],
                     ext=(0,)), ()),
    "dead node": (_graph(
        [_node("dead", in_slots=(0,), out_slots=(1,)),
         _node("sync", kind="sync", deps=(0,)),
         _node("live", in_slots=(0,), out_slots=(2,))], ext=(0,),
        outputs=(2,)), ()),
}


@pytest.mark.parametrize("case", sorted(HAZARDS))
def test_verify_graph_findings_equal_the_reference(case):
    graph, donate = HAZARDS[case]
    got = tanalyze.verify_graph(graph, donate=donate)
    want = janalyze.verify_graph(graph, donate=donate)
    assert [(f.code, f.nodes) for f in got] == [(f.code, f.nodes) for f in want]
    # the messages too, but for the aliasing note, whose reference wording
    # names XLA's buffer reuse
    assert [f.message for f in got if "alias" not in f.message] == \
        [f.message for f in want if "alias" not in f.message]
    if case != "donation on the ordered path":
        assert got


def _captured(core, array, seed_race):
    ctx = core.Context(core.Device(core.EGPU_16T)) if core is jcore else \
        core.Context(core.Device(core.EGPU_16T), "cpu")
    q = core.CommandQueue(ctx, out_of_order=True)
    k = core.Kernel("scale", executor=lambda x: (x * 2.0,))
    add = core.Kernel("sum", executor=lambda a, b: (a + b,))
    ndr = core.NDRange((8,), (8,))
    dst = ctx.create_buffer(array(np.ones(8)))
    with q.capture() as graph:
        ev = q.enqueue_nd_range(k, ndr, (dst,))
        q.enqueue_write_buffer(dst, array(np.arange(8.0)))
        q.enqueue_nd_range(add, ndr, (ev.outputs[0], dst))
    if seed_race == "raw":
        graph.nodes[2] = dataclasses.replace(graph.nodes[2], deps=())
    elif seed_race == "war":
        graph.nodes[1] = dataclasses.replace(graph.nodes[1], deps=())
    graph._verify_memo.clear()
    return graph


@pytest.mark.parametrize("seed_race", [None, "raw", "war"])
def test_captured_graphs_verify_alike(seed_race):
    j = _captured(jcore, lambda a: jnp.asarray(a, jnp.float32), seed_race)
    t = _captured(tcore, lambda a: torch.tensor(a, dtype=torch.float32), seed_race)
    jf, tf = j.verify(), t.verify()
    assert [(f.code, f.message, f.nodes) for f in tf] == \
        [(f.code, f.message, f.nodes) for f in jf]
    assert bool(tf) == (seed_race is not None)
    assert t.verify() is t.verify()                 # memoized
    assert t._slot_flags == j._slot_flags


def test_repro_verify_raises_at_capture_seal(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")
    ctx = tcore.Context(tcore.Device(tcore.EGPU_16T), "cpu")
    q = tcore.CommandQueue(ctx)
    buf = ctx.create_buffer(torch.ones(8))
    k = tcore.Kernel("scale", executor=lambda x: (x * 2.0,))
    with pytest.raises(tanalyze.GraphVerifyError, match="raw-race"):
        with q.capture() as graph:
            ev = q.enqueue_nd_range(k, tcore.NDRange((8,), (8,)), (buf,))
            q.enqueue_nd_range(k, tcore.NDRange((8,), (8,)), ev.outputs)
            graph.nodes[1] = dataclasses.replace(graph.nodes[1], deps=())


# ---------------------------------------------------------------------------
# runtime options the serving stack calls
# ---------------------------------------------------------------------------
def _two_stage_graph():
    ctx = tcore.Context(tcore.Device(tcore.EGPU_16T), "cpu")
    q = tcore.CommandQueue(ctx)
    k = tcore.Kernel("scale", executor=lambda x: (x * 2.0,))
    add = tcore.Kernel("add", executor=lambda x, c: (x + c,))
    x, c = ctx.create_buffer(torch.ones(4)), ctx.create_buffer(torch.full((4,), 3.0))
    with q.capture() as graph:
        ev = q.enqueue_nd_range(k, tcore.NDRange((4,), (4,)), (x,))
        q.enqueue_nd_range(add, tcore.NDRange((4,), (4,)), (ev.outputs[0], c))
    return ctx, graph


def test_donated_buffers_are_consumed_and_guarded():
    ctx, graph = _two_stage_graph()
    fresh = tcore.Buffer(torch.full((4,), 5.0))
    (out,) = graph.launch_prefix([fresh], donate=(0,))
    assert torch.equal(out.data, torch.full((4,), 13.0)) and fresh.consumed
    with pytest.raises(RuntimeError, match="consumed"):
        fresh.read()
    with pytest.raises(RuntimeError, match="consumed"):
        graph.launch_prefix([fresh])
    with pytest.raises(ValueError, match="caller-supplied"):
        graph.launch_prefix([torch.ones(4)], donate=(1,))
    with pytest.raises(ValueError, match="explicit launch inputs"):
        graph.launch(donate=(0,))
    # donation changes no bits: the same launch without it
    (again,) = graph.launch_prefix([torch.full((4,), 5.0)])
    assert torch.equal(again.data, out.data)
    assert graph.verify(donate=(0,)) == ()


def test_queue_events_false_books_nothing():
    ctx, graph = _two_stage_graph()
    q = tcore.CommandQueue(ctx)
    graph.launch(queue=q, queue_events=False)
    assert q.events == ()
    graph.launch(queue=q)
    assert len(q.events) == len(graph.nodes)


def test_stage_n_inputs_takes_the_leading_outputs():
    """``Stage.n_inputs`` feeds a stage only the first outputs of the one
    before (the reference's wiring, ``apu.py:46``)."""
    k_pair = tcore.Kernel("pair", executor=lambda x: (x, x * 3.0))
    k_one = tcore.Kernel("one", executor=lambda x: x + 1.0)
    stages = [tcore.Stage(k_pair), tcore.Stage(k_one, n_inputs=1)]
    outs, _ = tcore.APU(tcore.EGPU_16T, device="cpu").offload(stages, (torch.ones(3),))
    assert torch.equal(outs[0].data, torch.full((3,), 2.0))
    with pytest.raises(ValueError):
        tcore.APU(tcore.EGPU_16T, device="cpu").offload(
            [tcore.Stage(k_pair), tcore.Stage(k_one)], (torch.ones(3),))


# ---------------------------------------------------------------------------
# fault draws and lane prices
# ---------------------------------------------------------------------------
LANES = ("0:e-gpu-16t", "1:e-gpu-8t", "solo")


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2 ** 31 - 1])
def test_fault_decisions_equal_the_reference(seed):
    kw = dict(p_launch_fail=0.3, p_latency_spike=0.4, latency_spike_s=2e-4,
              blackouts=())
    plans = {k: v[2].FaultPlan(seed=seed, **{
        **kw, "blackouts": (v[2].Blackout("solo", 3, 2),)})
        for k, v in PACKAGES.items()}
    grid = list(itertools.product(LANES, range(12)))
    got = [dataclasses.asdict(plans["torch"].draw(l, i)) for l, i in grid]
    want = [dataclasses.asdict(plans["jax"].draw(l, i)) for l, i in grid]
    assert got == want
    assert (plans["torch"].injected_failures, plans["torch"].injected_spikes) == \
        (plans["jax"].injected_failures, plans["jax"].injected_spikes)
    breakdown = dict(compute=1e3, transfer=2e2, startup=50.0, scheduling=30.0,
                     freq_hz=1e8)
    assert dataclasses.asdict(tserve.apply_spike(
        tcore.PhaseBreakdown(**breakdown), 2e-4)) == dataclasses.asdict(
        jserve.apply_spike(jcore.PhaseBreakdown(**breakdown), 2e-4))


@pytest.mark.parametrize("cfg_name,t_now,busy,energy,n_req", [
    ("EGPU_16T", 0.0, 0.0, 1e-6, 4), ("EGPU_8T", 1e-3, 3e-3, 5e-7, 2),
    ("EGPU_4T", 2e-3, 1e-3, 0.0, 1)])
def test_lane_prices_equal_the_reference(cfg_name, t_now, busy, energy, n_req):
    prices = {}
    for key, (core, _, serve, _) in PACKAGES.items():
        kw = {} if core is jcore else {"device": "cpu"}
        w = serve.QueueWorker(getattr(core, cfg_name), **kw)
        w.modeled_busy_until = busy
        fused = core.PhaseBreakdown(compute=2e4, transfer=5e3, startup=4e2,
                                    scheduling=3e2, freq_hz=getattr(core, cfg_name).freq_hz)
        p = w.price(fused, energy, t_now, n_requests=n_req)
        prices[key] = (dataclasses.asdict(p), w.idle_power_w,
                       w.current_power_w(t_now))
    assert prices["torch"] == prices["jax"]
    budgets = [v[2].PowerBudget(lane_mw=28.0, fleet_mw=35.0) for v in PACKAGES.values()]
    assert dataclasses.asdict(budgets[0]) == dataclasses.asdict(budgets[1])
    with pytest.raises(ValueError, match="at least one"):
        tserve.PowerBudget()
