"""Sharded serving of the port (``repro_torch.serve.ShardedWorker``) held
against the JAX package's, case by case after ``tests/test_sharded_serve.py``.

The scenarios (``tests/sharded_scenarios.py``) run on a virtual clock
through the port on a CPU mesh of one position and of two (the CPU stands
at both), and through the JAX package in one subprocess with two forced
host devices.  For each:

* the outputs are bit-equal to the plain lane's;
* the routing across mixed lanes, the batch counts and every modeled
  ``ServeReport`` field ``==`` the JAX package's (shards, mesh axes, mesh
  utilization and the shard-scaled modeled seconds among them);
* the cache misses equal JAX's, with no collision between sharded and
  plain entries.

TinyBio at the paper's size served on a 2-position lane is bit-equal to the
plain lane, with one cache entry per lane and the batch split in two.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.core.machine import PhaseBreakdown as JPhaseBreakdown
from repro_torch.core.machine import PhaseBreakdown
from repro_torch.distributed.sharding import SERVE_RULES, LocalMesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import sharded_scenarios as sc  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401


class _Pending:
    """The JAX subprocess's scenario results, read when a test first needs
    them: the subprocess runs while the port's own cases do."""

    def __init__(self, proc):
        self.proc, self.value = proc, None

    def __getitem__(self, key):
        if self.value is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self.value = json.loads(out.strip().splitlines()[-1])
        return self.value[key]


@pytest.fixture(scope="module", autouse=True)
def jax_runs():
    """Every scenario through the JAX package, 2 forced host devices, in a
    subprocess started with the module's first test."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "sharded_scenarios.py")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield _Pending(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _equal_outs(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def test_tinybio_sharded_bit_identical():
    """The paper's TinyBio bucket (65,536 samples, batch 2) through a
    2-position lane: bit-identical to the plain lane, one entry per lane in
    the shared cache (a collision would read as 1 miss + 1 hit), and the
    batch really split in two."""
    from repro_torch.apps.tinybio import synth_signal, tinybio_stages
    stages, _ = tinybio_stages(tcore.EGPU_16T, 0, "cpu")
    n = 65_536
    sigs = [torch.from_numpy(synth_signal(n, seed=s)) for s in (3, 4)]
    cache = tserve.GraphCache(capacity=8)

    def serve(worker):
        srv = tserve.Server(stages, workers=(worker,), bucket_sizes=(n,),
                            max_batch=2, device="cpu")
        srv.cache = cache
        rids = [srv.submit(s) for s in sigs]
        srv.flush()
        return [srv.result(r) for r in rids], srv

    plain, _ = serve(tserve.QueueWorker(tcore.EGPU_16T, name="single",
                                        device="cpu"))
    sharded, srv = serve(tserve.ShardedWorker(
        tcore.EGPU_16T, tserve.data_mesh(2, device="cpu"), name="mesh"))
    for a, b in zip(plain, sharded):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert cache.stats()["misses"] == 2
    assert cache.stats()["hits"] == 0
    assert cache.stats()["evictions"] == 0
    qs = srv.report().queues[0]
    assert qs.shards == 2
    assert dict(qs.mesh_utilization) == {"data": 1.0}
    (graph,) = [g for k, g in cache._graphs.items() if k[2] is not None]
    assert len(worker_plan(srv, graph).launches) == 2


def worker_plan(srv, graph):
    (worker,) = srv.dispatcher.workers
    return worker._plan(graph)


# ---------------------------------------------------------------------------
# one position
# ---------------------------------------------------------------------------
def test_one_device_mesh_serves_and_reports(jax_runs):
    got = sc.one("torch")
    rep = got["report"]
    for out, x in zip(got["outs"], sc.requests(4)):
        assert out[0].shape == x.shape
    (qs,) = rep["queues"]
    assert qs["shards"] == 1
    assert qs["mesh_axes"] == [["data", 1]]
    assert dict(qs["mesh_utilization"]) == {"data": 1.0}
    assert rep["mesh_utilization"] == {"data": 1.0}
    assert "mesh data=1" in got["summary"]
    assert rep == jax_runs["one"]["report"]
    assert got["summary"] == jax_runs["one"]["summary"]


def test_sharded_and_plain_cache_entries_never_collide(jax_runs):
    """Same pipeline, same bucket, shared cache: the sharded lane's
    placement keys a separate entry; the warm replays hit their own."""
    got = sc.collide("torch")["stats"]
    assert got == jax_runs["collide"]["stats"]
    assert got[1]["misses"] == 2 and got[1]["entries"] == 2
    assert got[3]["misses"] == 2 and got[3]["hits"] >= 2


def test_placement_distinguishes_mesh_and_rules():
    mesh = tserve.data_mesh(1, device="cpu")
    w1 = tserve.ShardedWorker(tcore.EGPU_16T, mesh, name="a")
    w2 = tserve.ShardedWorker(tcore.EGPU_16T, tserve.data_mesh(
        1, device="cpu"), name="b")
    assert w1.apu.placement == w2.apu.placement    # same mesh layout: share
    w3 = tserve.ShardedWorker(tcore.EGPU_16T, mesh, name="c",
                              rules=SERVE_RULES.with_seq_sharding(True))
    assert w3.apu.placement != w1.apu.placement
    w4 = tserve.ShardedWorker(tcore.EGPU_16T, tserve.data_mesh(
        2, device="cpu"), name="d")
    assert w4.apu.placement != w1.apu.placement
    assert tserve.QueueWorker(tcore.EGPU_16T, name="e",
                              device="cpu").apu.placement is None
    assert tcore.APU(tcore.EGPU_16T, device="cpu").placement is None
    assert tserve.mesh_signature(mesh) == (("data",), (1,), ("cpu",))
    assert tserve.BATCH_AXIS == jserve.BATCH_AXIS


def test_shard_breakdown_scales_only_work_phases():
    kw = dict(startup=100.0, scheduling=50.0, transfer=40.0, compute=200.0,
              freq_hz=1e6)
    pb = PhaseBreakdown(**kw)
    sb = tserve.shard_breakdown(pb, 2)
    assert sb.startup == 100.0 and sb.scheduling == 50.0
    assert sb.transfer == 20.0 and sb.compute == 100.0
    assert tserve.shard_breakdown(pb, 1) is pb
    for n in (2, 3, 7):
        j = jserve.shard_breakdown(JPhaseBreakdown(**kw), n)
        t = tserve.shard_breakdown(pb, n)
        assert (t.startup, t.scheduling, t.transfer, t.compute,
                t.total_s) == (j.startup, j.scheduling, j.transfer,
                               j.compute, j.total_s)


def test_sharded_worker_rejects_bad_mesh():
    with pytest.raises(TypeError):
        tserve.ShardedWorker(tcore.EGPU_16T, mesh="not-a-mesh")
    with pytest.raises(ValueError):
        tserve.data_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        tserve.ShardedWorker(tcore.EGPU_16T,
                             LocalMesh(np.empty((0,), object), ("data",)))
    # the card by default, and no fallback to the CPU without one
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.data_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.data_mesh(1)


def test_sharded_lane_blackout_reroutes_bit_identical(jax_runs):
    got = sc.blackout("torch")
    rep = got["report"]
    assert rep["n_shed"] == 0 and rep["n_dispatch_failures"] == 0
    assert rep["n_retries"] >= 1
    per = {q["name"]: q for q in rep["queues"]}
    assert per["mesh"]["launch_failures"] == 2
    assert per["mesh"]["batches"] >= 1          # recovered after the window
    assert per["plain"]["batches"] >= 1
    _equal_outs(got["outs"], got["ref_outs"])
    assert rep == jax_runs["blackout"]["report"]


# ---------------------------------------------------------------------------
# two positions
# ---------------------------------------------------------------------------
def test_two_shard_results_bit_identical_and_modeled_scaled(jax_runs):
    got = sc.two("torch")
    _equal_outs(got["plain"]["outs"], got["sharded"]["outs"])
    plain = got["plain"]["report"]["queues"][0]["modeled_s"]
    sharded = got["sharded"]["report"]["queues"][0]["modeled_s"]
    # transfer+compute halve, startup+scheduling don't: strictly between
    assert plain / 2 < sharded < plain
    assert got["sharded"]["report"]["queues"][0]["shards"] == 2
    for key in ("plain", "sharded"):
        assert got[key]["report"] == jax_runs["two"][key]["report"]


def test_divisibility_fallback_replicates_odd_capacity(jax_runs):
    """max_batch=3 on a 2-position data axis: 3 % 2 != 0, so the batch
    axis falls back to replication (one launch, full results, honest
    utilization 0.5)."""
    got = sc.odd("torch")
    for out, x in zip(got["outs"], sc.requests(3)):
        assert out[0].shape == x.shape
    (qs,) = got["report"]["queues"]
    assert qs["shards"] == 2                  # the lane still spans 2
    assert dict(qs["mesh_utilization"])["data"] == pytest.approx(0.5)
    assert got["report"]["mesh_utilization"]["data"] == pytest.approx(0.5)
    assert got["report"] == jax_runs["odd"]["report"]


def test_dispatcher_routes_mixed_plain_and_sharded_lanes(jax_runs):
    got = sc.mixed("torch")
    rep = got["report"]
    per = {q["name"]: q for q in rep["queues"]}
    assert per["plain"]["batches"] + per["mesh2"]["batches"] == 10
    assert per["mesh2"]["batches"] > per["plain"]["batches"] >= 1
    assert rep["mesh_utilization"] == {"data": 1.0}
    assert rep == jax_runs["mixed"]["report"]
    assert got["cache"] == jax_runs["mixed"]["cache"]


def test_const_axes_shard_model_parallel_stage_args(jax_runs):
    """A constant tagged with a divisible logical axis is stored split over
    'model' and gathered before each launch: the results are the whole
    constant's, and the lane's 'model' axis reads fully used."""
    got = sc.model_parallel("torch")
    _equal_outs(got["outs"], got["ref_outs"])
    (qs,) = got["report"]["queues"]
    assert dict(qs["mesh_utilization"])["model"] == pytest.approx(1.0)
    assert got["report"] == jax_runs["model_parallel"]["report"]


def test_const_axes_store_blocks_and_launch_once_a_shard():
    """The plan behind a launch: a (data=2) lane cuts the batch in two and
    derives one graph a position; a tagged constant is held as one block
    a position (never whole), and the cached graph counts one miss."""
    stages = sc.stages("torch", n=1)
    mesh = LocalMesh(np.full((2, 2), "cpu", object), ("data", "model"))
    worker = tserve.ShardedWorker(tcore.EGPU_16T, mesh, name="grid",
                                  const_axes=(("mlp", None),))
    srv = tserve.Server(stages, workers=(worker,), bucket_sizes=(8,),
                        max_batch=2, device="cpu")
    xs = sc.requests(2)
    rids = [srv.submit(torch.as_tensor(x)) for x in xs]
    srv.flush()
    (graph,) = srv.cache._graphs.values()
    plan = worker._plan(graph)
    assert plan.shards == 2 and len(plan.launches) == 2
    assert [(r.start, r.stop) for r, _pos, _g in plan.launches] == [(0, 1),
                                                                    (1, 2)]
    assert [pos for _r, pos, _g in plan.launches] == [(0, 0), (1, 0)]
    parts, _slices, shape = plan.const_parts[0]
    assert shape == (8, 8) and {b.shape for b in parts.values()} == {(4, 8)}
    assert plan.axis_factor == {"data": 2, "model": 2}
    in_specs, out_specs, shards, factor = worker.shardings_for(graph)
    assert in_specs == (("data",), ("model",)) and shards == 2
    assert out_specs == (("data",),) and factor == plan.axis_factor
    assert srv.cache.misses == 1
    ref = tserve.Server(stages, workers=(tcore.EGPU_16T,), bucket_sizes=(8,),
                        max_batch=2, device="cpu")
    ref_rids = [ref.submit(torch.as_tensor(x)) for x in xs]
    ref.flush()
    for a, b in zip(rids, ref_rids):
        assert torch.equal(srv.result(a)[0], ref.result(b)[0])


def test_report_fields_are_the_jax_fields():
    """The scenarios compare every field: both packages' reports have the
    same ones."""
    assert ([f.name for f in dataclasses.fields(tserve.ServeReport)]
            == [f.name for f in dataclasses.fields(jserve.ServeReport)])
    assert ([f.name for f in dataclasses.fields(tserve.QueueStats)]
            == [f.name for f in dataclasses.fields(jserve.QueueStats)])
