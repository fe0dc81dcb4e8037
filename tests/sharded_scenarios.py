"""Sharded-serving scenarios run the same way through either package's
``Server`` (``pkg`` is ``"jax"`` or ``"torch"``), on a virtual clock, so the
modeled ``ServeReport`` fields of the two compare with ``==``.

``tests/test_torch_sharded_serve.py`` runs each scenario through the port
on a CPU mesh of one or two positions, and through the JAX package in one
subprocess with two forced host devices (``python sharded_scenarios.py``
prints every scenario's JSON).  The cases are those of
``tests/test_sharded_serve.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

MEASURED = ("wall_s", "requests_per_s", "goodput_per_s")
D = 8


class VClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _mods(pkg):
    if pkg == "jax":
        import jax.numpy as jnp
        import repro.core as core
        import repro.serve as serve
        from repro.kernels.gemm.ref import counts, gemm_ref
        return core, serve, jnp.asarray, counts, gemm_ref, {}
    import torch
    import repro_torch.core as core
    import repro_torch.serve as serve
    from repro_torch.kernels.gemm.ref import counts, gemm_ref
    return core, serve, torch.as_tensor, counts, gemm_ref, {"device": "cpu"}


def stages(pkg, n=2, d=D, seed=0):
    core, _serve, arr, counts, gemm_ref, _extra = _mods(pkg)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, d)) * 0.2).astype(np.float32)
    if pkg == "jax":
        import jax.numpy as jnp

        def mlp(x, w):
            return jnp.maximum(gemm_ref(x, w), 0.0)
    else:
        import torch

        def mlp(x, w):
            return torch.clamp_min(gemm_ref(x, w), 0.0)
    kern = core.Kernel("mlp", executor=mlp,
                       counts=lambda **kw: counts(m=d, n=d, k=d))
    return [core.Stage(kern, consts=(arr(w),), n_inputs=1) for _ in range(n)]


def requests(n, d=D, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(3, d + 1)), d)).astype(
        np.float32) for _ in range(n)]


def data_mesh(pkg, n):
    serve = _mods(pkg)[1]
    return serve.data_mesh(n) if pkg == "jax" else serve.data_mesh(
        n, device="cpu")


def grid_mesh(pkg, shape, names):
    if pkg == "jax":
        import jax
        from jax.sharding import Mesh
        devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        return Mesh(devs, names)
    from repro_torch.distributed.sharding import LocalMesh
    devs = np.empty(shape, object)
    devs[...] = "cpu"
    return LocalMesh(devs, names)


def modeled(rep) -> dict:
    """Every ServeReport field but the host-clock ones, as JSON gives it."""
    d = {k: v for k, v in dataclasses.asdict(rep).items()
         if k not in MEASURED}
    return json.loads(json.dumps(d))


def _serve(pkg, stages_, workers, xs, clock, cache=None, **kw):
    serve, arr, extra = _mods(pkg)[1], _mods(pkg)[2], _mods(pkg)[5]
    srv = serve.Server(stages_, workers=workers, clock=clock, **kw, **extra)
    if cache is not None:
        srv.cache = cache
    rids = []
    for i, x in enumerate(xs):
        clock.t = 1e-4 * i
        rids.append(srv.submit(arr(x)))
    clock.t = 1e-4 * len(xs) + 1e-2
    srv.flush()
    outs = [[np.asarray(o) for o in srv.result(r)] for r in rids]
    return srv, outs


def one(pkg):
    core, serve = _mods(pkg)[:2]
    worker = serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 1),
                                 name="mesh1")
    srv, outs = _serve(pkg, stages(pkg), (worker,), requests(4), VClock(),
                       bucket_sizes=(8,), max_batch=2)
    rep = srv.report()
    return {"report": modeled(rep), "summary": rep.summary(), "outs": outs}


def collide(pkg):
    core, serve = _mods(pkg)[:2]
    st = stages(pkg)
    cache = serve.GraphCache(capacity=8)
    plain = serve.QueueWorker(core.EGPU_16T, name="plain", **_mods(pkg)[5])
    sharded = serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 1),
                                  name="mesh")
    stats = []
    for _round in range(2):
        for workers in ((plain,), (sharded,)):
            _serve(pkg, st, workers, requests(2), VClock(), cache=cache,
                   bucket_sizes=(8,), max_batch=2)
            stats.append(dict(cache.stats(), entries=len(cache)))
    return {"stats": stats}


def two(pkg):
    core, serve = _mods(pkg)[:2]
    st = stages(pkg, n=3)
    out = {}
    for key, worker in (
            ("plain", serve.QueueWorker(core.EGPU_16T, name="p",
                                        **_mods(pkg)[5])),
            ("sharded", serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 2),
                                            name="s"))):
        srv, outs = _serve(pkg, st, (worker,), requests(8), VClock(),
                           bucket_sizes=(8,), max_batch=2)
        out[key] = {"report": modeled(srv.report()), "outs": outs}
    return out


def odd(pkg):
    core, serve = _mods(pkg)[:2]
    worker = serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 2), name="odd")
    srv, outs = _serve(pkg, stages(pkg), (worker,), requests(3), VClock(),
                       bucket_sizes=(8,), max_batch=3)
    return {"report": modeled(srv.report()), "outs": outs}


def mixed(pkg):
    core, serve = _mods(pkg)[:2]
    plain = serve.QueueWorker(core.EGPU_16T, name="plain", **_mods(pkg)[5])
    sharded = serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 2),
                                  name="mesh2")
    srv, outs = _serve(pkg, stages(pkg), (plain, sharded), requests(20),
                       VClock(), bucket_sizes=(8,), max_batch=2,
                       max_in_flight=2)
    return {"report": modeled(srv.report()), "cache": srv.cache.stats(),
            "outs": outs}


def model_parallel(pkg):
    core, serve = _mods(pkg)[:2]
    worker = serve.ShardedWorker(core.EGPU_16T,
                                 grid_mesh(pkg, (1, 2), ("data", "model")),
                                 name="mp", const_axes=((None, "mlp"),))
    st = stages(pkg, n=1)
    srv, outs = _serve(pkg, st, (worker,), requests(2), VClock(),
                       bucket_sizes=(8,), max_batch=2)
    ref, ref_outs = _serve(pkg, st, (core.EGPU_16T,), requests(2), VClock(),
                           bucket_sizes=(8,), max_batch=2)
    return {"report": modeled(srv.report()), "outs": outs,
            "ref_outs": ref_outs}


def blackout(pkg):
    core, serve = _mods(pkg)[:2]
    plan = serve.FaultPlan(seed=serve.env_seed(11),
                           blackouts=(serve.Blackout("mesh", start=0,
                                                     length=2),))
    mesh_lane = serve.ShardedWorker(core.EGPU_16T, data_mesh(pkg, 1),
                                    name="mesh", fault_plan=plan)
    plain_lane = serve.QueueWorker(core.EGPU_16T, name="plain",
                                   fault_plan=plan, **_mods(pkg)[5])
    st = stages(pkg)
    srv, outs = _serve(pkg, st, (mesh_lane, plain_lane), requests(12),
                       VClock(), bucket_sizes=(8,), max_batch=2,
                       breaker_threshold=2, breaker_cooldown=1)
    ref, ref_outs = _serve(pkg, st, (core.EGPU_16T,), requests(12), VClock(),
                           bucket_sizes=(8,), max_batch=2)
    return {"report": modeled(srv.report()), "outs": outs,
            "ref_outs": ref_outs}


SCENARIOS = {"one": one, "collide": collide, "two": two, "odd": odd,
             "mixed": mixed, "model_parallel": model_parallel,
             "blackout": blackout}


def _drop_outs(x):
    if isinstance(x, dict):
        return {k: _drop_outs(v) for k, v in x.items()
                if k not in ("outs", "ref_outs")}
    return x


if __name__ == "__main__":
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    assert len(jax.devices()) == 2, jax.devices()
    names = sys.argv[1:] or list(SCENARIOS)
    print(json.dumps({n: _drop_outs(SCENARIOS[n]("jax")) for n in names}))
