"""The port's decode-engine fronts against the JAX package's, on the CPU.

``Server(engine=...)`` with ``submit_decode`` / ``stream``, the asyncio
HTTP ingress (``EngineHTTPServer``) over a loopback socket, and the
modeled accounting: every ``DecodeEngine.stats()`` field, every
``EngineRoofline`` field, every ``ServeReport`` engine field and the
engine's published metrics ``==`` the JAX engine's on the same workload.
Also the ``ndranges=`` argument the engine prices its graphs with:
``APU.offload(ndranges=)`` and ``GraphCache.get_or_capture(ndranges=)``
reports ``==`` the JAX package's for one non-default NDRange.

Models: ``qwen2.5-3b``, ``rwkv6-3b``, ``deepseek-v2-236b`` (MLA + MoE)
and ``moonshot-v1-16b-a3b`` (attention + MoE) at ``.reduced()`` size,
float32, the JAX package's parameters carried across with
``tree_from_jax``.
Tolerances: none — tokens bit for bit, modeled numbers ``==``.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
from repro.configs import ARCHS as J_ARCHS
from repro.models import init_params as j_init_params
from repro.models import model_spec as j_model_spec
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Tracer as JTracer
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro_torch import configs
from repro_torch.models.convert import tree_from_jax
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.train.serve import greedy_generate

PROMPT, NEW = 12, 4
FAMILIES = ["qwen2.5-3b", "rwkv6-3b", "deepseek-v2-236b",
            "moonshot-v1-16b-a3b"]
ENGINE_FIELDS = ("engine_steps", "engine_tokens", "engine_prefill_s_modeled",
                 "engine_decode_s_modeled", "engine_tokens_per_s_modeled",
                 "engine_slot_occupancy", "engine_bytes_per_step",
                 "engine_mem_bound_fraction")


def _setup(arch, batch, prompt_len=PROMPT, seed=1):
    jcfg = J_ARCHS[arch].reduced()
    cfg = configs.get(arch).reduced()
    jparams = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    tree = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                         device="cpu")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return cfg, jcfg, jparams, tree, prompts


class VClock:
    """A virtual clock both servers read, so every modeled timestamp is
    the machine model's."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _served(pkg, arch, n_req, slots, max_new=NEW, traced=False):
    """(server, engine, rids, streamed tokens of rid 0, tracer) after
    n_req requests submitted up front, one streamed, the rest flushed."""
    cfg, jcfg, jparams, tree, prompts = _setup(arch, n_req)
    clock = VClock()
    if pkg == "jax":
        tracer = JTracer() if traced else None
        eng = jserve.DecodeEngine(jcfg, jparams, num_slots=slots,
                                  max_len=PROMPT + max_new + 1)
        srv = jserve.Server((), workers=(), engine=eng, tracer=tracer,
                            clock=clock)
    else:
        tracer = Tracer() if traced else None
        eng = tserve.DecodeEngine(cfg, tree, num_slots=slots,
                                  max_len=PROMPT + max_new + 1, device="cpu")
        srv = tserve.Server((), workers=(), engine=eng, tracer=tracer,
                            clock=clock)
    rids = []
    for i in range(n_req):
        clock.t += 1e-4
        rids.append(srv.submit_decode(prompts[i], max_new=max_new))
    streamed = list(srv.stream(rids[0]))
    srv.flush()
    return srv, eng, rids, streamed, tracer, prompts


@pytest.mark.parametrize("arch", FAMILIES)
def test_server_engine_streaming_front(arch):
    """submit_decode/stream round-trip: bit-identical results (to
    greedy_generate and to the JAX server), slot churn across more requests
    than slots, exactly one terminal span per rid."""
    srv, eng, rids, streamed, tracer, prompts = _served(
        "torch", arch, 3, 2, traced=True)
    jsrv, _, jrids, jstreamed, _, _ = _served("jax", arch, 3, 2)
    ref = greedy_generate(eng.model, prompts, NEW, PROMPT + NEW + 1).numpy()
    assert streamed == [int(t) for t in ref[0]] == jstreamed
    for i, (rid, jrid) in enumerate(zip(rids, jrids)):
        (got,) = srv.result(rid)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref[i])
        np.testing.assert_array_equal(got, np.asarray(jsrv.result(jrid)[0]))
    rep = srv.report()
    # decode steps produce NEW-1 tokens/request (token 1 is prefill's)
    assert rep.engine_tokens == 3 * (NEW - 1)
    assert rep.engine_steps > 0 and rep.engine_tokens_per_s_modeled > 0
    assert 0.0 < rep.engine_slot_occupancy <= 1.0
    assert "engine" in rep.summary()
    assert eng.cache.misses == 2
    # every accepted rid terminates in exactly one result/shed span
    for rid in rids:
        root = tracer.request_root(rid)
        terms = [s for s in tracer.children(root)
                 if s.name in ("result", "shed")]
        assert len(terms) == 1
    assert tracer.validate_request_trees(rids) == []


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_accounting_equals_jax(arch):
    """Every stats(), EngineRoofline and ServeReport engine field, and the
    published engine and server metrics, == the JAX engine's on the same
    staggered workload (5 requests over 2 slots, a virtual clock)."""
    srv, eng, _, _, _, _ = _served("torch", arch, 5, 2, max_new=5)
    jsrv, jeng, _, _, _, _ = _served("jax", arch, 5, 2, max_new=5)
    assert eng.stats() == jeng.stats()
    roof, jroof = eng.roofline(), jeng.roofline()
    assert dataclasses.asdict(roof) == dataclasses.asdict(jroof)
    for prop in ("bytes_per_step", "min_step_s", "mem_bound_fraction"):
        assert getattr(roof, prop) == getattr(jroof, prop)
    rep, jrep = srv.report(), jsrv.report()
    for name in ENGINE_FIELDS:
        assert getattr(rep, name) == getattr(jrep, name), name
    for name in ("n_requests", "n_shed", "n_deadline_violations",
                 "goodput_per_s_modeled", "fleet_energy_j",
                 "fleet_idle_energy_j", "avg_fleet_power_w", "cache"):
        assert getattr(rep, name) == getattr(jrep, name), name
    assert [dataclasses.asdict(q) for q in rep.queues] == \
        [dataclasses.asdict(q) for q in jrep.queues]
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    eng.publish_metrics(reg)
    jeng.publish_metrics(jreg)
    assert reg.snapshot() == jreg.snapshot()
    assert srv.publish_metrics().snapshot() == \
        jsrv.publish_metrics().snapshot()


def test_server_without_an_engine_and_admission():
    cfg, _, _, tree, prompts = _setup("qwen2.5-3b", 3)
    eng = tserve.DecodeEngine(cfg, tree, num_slots=1, max_len=PROMPT + NEW,
                              device="cpu")
    srv = tserve.Server((), workers=(), engine=eng, max_pending=1)
    assert srv.device.type == "cpu" and srv.dispatcher.workers == [eng.worker]
    with pytest.raises(ValueError, match="max_len"):
        srv.submit_decode(prompts[0], max_new=NEW + 1)
    with pytest.raises(ValueError, match="max_new"):
        srv.submit_decode(prompts[0], max_new=0)
    srv.submit_decode(prompts[0], max_new=2)       # slotted at once
    srv.submit_decode(prompts[1], max_new=2)       # waits for the slot
    with pytest.raises(tserve.AdmissionError, match="max_pending"):
        srv.submit_decode(prompts[2], max_new=2)
    assert srv.n_shed == 1


def test_http_ingress_smoke():
    """The asyncio front door streams the same bits over chunked HTTP,
    answers /healthz, and 400 on a bad body."""
    cfg, _, _, tree, prompts = _setup("qwen2.5-3b", 2)
    max_len = PROMPT + NEW + 1
    eng = tserve.DecodeEngine(cfg, tree, num_slots=2, max_len=max_len,
                              device="cpu")
    ref = greedy_generate(eng.model, prompts, NEW, max_len).numpy()
    srv = tserve.Server((), workers=(), engine=eng)
    front = tserve.EngineHTTPServer(srv)

    async def request(host, port, raw):
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(raw)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        status = int(head.split(b" ")[1])
        if status != 200 or b"chunked" not in head:
            body = await reader.read()
            writer.close()
            return status, json.loads(body)
        toks = []
        while True:
            n = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if n == 0:
                break
            toks.append(int((await reader.readexactly(n + 2))[:-2]))
        writer.close()
        return status, toks

    def post(prompt, max_new):
        body = json.dumps({"prompt": [int(t) for t in prompt],
                           "max_new": max_new}).encode()
        return (b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)

    async def run():
        host, port = await front.start()
        try:
            results = await asyncio.gather(
                *[request(host, port, post(prompts[i], NEW))
                  for i in range(2)])
            bad = await request(host, port, post([], NEW))
            health = await request(host, port,
                                   b"GET /healthz HTTP/1.1\r\n\r\n")
            return results, bad, health
        finally:
            await front.stop()

    results, bad, health = asyncio.run(run())
    for i, (status, toks) in enumerate(results):
        assert status == 200
        assert toks == [int(t) for t in ref[i]]
    assert bad[0] == 400
    assert health == (200, {"status": "ok", "slots": 2,
                            "steps": eng.n_steps, "tokens": eng.n_tokens})
    with pytest.raises(ValueError, match="engine"):
        tserve.EngineHTTPServer(tserve.Server((), device="cpu"))


def test_offload_and_get_or_capture_take_ndranges():
    """A non-default NDRange prices the offload's report (graph and eager)
    and keys the cache entry exactly as the JAX package's."""
    rng = np.random.default_rng(0)
    a = rng.integers(-64, 64, (64, 64)).astype(np.int32)
    b = rng.integers(-64, 64, (64, 64)).astype(np.int32)
    cp = {"m": 64, "n": 64, "k": 64}
    jndr = [jcore.NDRange((4096,), (64,))]
    tndr = [tcore.NDRange((4096,), (64,))]
    jstage = jcore.Stage(jcore.Program.build(jcore.EGPU_16T).create_kernel(
        "gemm"), counts_params=cp)
    tstage = tcore.Stage(tcore.Program.build(tcore.EGPU_16T).create_kernel(
        "gemm"), counts_params=cp)
    for mode in ("graph", "eager"):
        (jout,), jrep = jcore.APU(jcore.EGPU_16T).offload(
            [jstage], (jnp.asarray(a), jnp.asarray(b)), jndr, mode=mode)
        (tout,), trep = tcore.APU(tcore.EGPU_16T, device="cpu").offload(
            [tstage], (a, b), tndr, mode=mode)
        np.testing.assert_array_equal(tout.data.numpy(), np.asarray(jout.data))
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep), mode
        _, default = tcore.APU(tcore.EGPU_16T, device="cpu").offload(
            [tstage], (a, b), mode=mode)
        assert dataclasses.asdict(default) != dataclasses.asdict(trep)
    cache, jcache = tserve.GraphCache(), jserve.GraphCache()
    apu = tcore.APU(tcore.EGPU_16T, device="cpu")
    japu = jcore.APU(jcore.EGPU_16T)
    inputs = (torch.from_numpy(a), torch.from_numpy(b))
    graph, hit = cache.get_or_capture(apu, [tstage], inputs, ndranges=tndr)
    jgraph, jhit = jcache.get_or_capture(
        japu, [jstage], (jnp.asarray(a), jnp.asarray(b)), ndranges=jndr)
    assert not hit and not jhit
    (fused, energy), (jfused, jenergy) = (graph.fused_modeled(),
                                          jgraph.fused_modeled())
    assert (dataclasses.asdict(fused), energy) == \
        (dataclasses.asdict(jfused), jenergy)
    assert cache.key_for(apu, [tstage], inputs, tndr)[-1] == \
        jcache.key_for(japu, [jstage], (a, b), jndr)[-1] == \
        (((4096,), (64,)),)
    assert cache.get_or_capture(apu, [tstage], inputs, tndr) == (graph, True)
    _, hit = cache.get_or_capture(apu, [tstage], inputs)
    assert not hit and cache.stats()["misses"] == 2
