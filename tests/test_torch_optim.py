"""AdamW and the schedules against the JAX package's, and the port's
versions of the optimizer checks of ``tests/test_substrate.py``.

Tolerances: the schedules run the JAX code's f32 operations one 0-d op at a
time, so ``wsd_schedule`` and ``constant_schedule`` equal JAX's at every
step; ``cosine_schedule``'s cosine is XLA's own approximation, one f32 ulp
from the port's at some steps.  ``adamw_update`` does the same f32 update
math term by term over a numpy-seeded tree: parameters within 1e-6 of their
largest magnitude after three steps (sums of squares in another order give
the global norm's last bit), bf16 moments within one bf16 ulp (an f32
moment a bit off can round to the neighbouring bf16 value) plus 1e-6 of the
largest, the metrics within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import schedule as jschedule
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               constant_schedule, cosine_schedule,
                               global_norm, wsd_schedule)
from repro_torch.optim import schedule as tschedule

BF16_ULP = 2.0 ** -7


@pytest.mark.parametrize("name,args,kw,steps", [
    ("wsd_schedule", (3e-4, 1000), {}, 1002),
    ("wsd_schedule", (1.0, 1000), dict(warmup_steps=100, decay_frac=0.2), 1002),
    ("wsd_schedule", (3e-3, 150), {}, 152),
    ("constant_schedule", (1e-3,), {}, 10)])
def test_schedules_equal_jax_step_for_step(name, args, kw, steps):
    ours, ref = getattr(tschedule, name)(*args, **kw), getattr(
        jschedule, name)(*args, **kw)
    for s in range(steps):
        lr = ours(s)
        assert lr.dtype == torch.float32 and lr.shape == ()
        assert float(lr) == float(np.float32(ref(jnp.int32(s)))), s
        assert float(ours(torch.tensor(s, dtype=torch.int32))) == float(lr)


def test_cosine_schedule_within_an_ulp_of_jax():
    ours = cosine_schedule(2.0, 100, warmup_steps=10, final_scale=0.1)
    ref = jschedule.cosine_schedule(2.0, 100, warmup_steps=10,
                                    final_scale=0.1)
    for s in range(102):
        want = np.float32(ref(jnp.int32(s)))
        assert abs(float(ours(s)) - float(want)) <= float(np.spacing(want))
    assert float(ours(10)) == pytest.approx(2.0)
    assert float(ours(100)) == pytest.approx(0.2, rel=1e-2)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": {"b": rng.standard_normal((3, 5)).astype(np.float32),
                       "scale": rng.standard_normal((5,)).astype(np.float32)},
            "emb": rng.standard_normal((4, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_jax(clip):
    params = map_tree(torch.tensor, _tree(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    state, jstate = adamw_init(params), j_adamw_init(jparams)
    cfg, jcfg = AdamWConfig(clip_norm=clip), JAdamWConfig(clip_norm=clip)
    for step in range(3):
        grads = _tree(10 + step)
        lr = wsd_schedule(1e-2, 10)(step + 3)
        _, state, m = adamw_update(params, map_tree(torch.tensor, grads),
                                   state, lr, cfg)
        jparams, jstate, jm = j_adamw_update(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            jnp.float32(float(lr)), jcfg)
        for key in ("grad_norm", "clip_scale"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert state["step"].dtype == torch.int32
    jflat = {jax.tree_util.keystr(p): np.asarray(x, np.float32) for p, x in
             jax.tree_util.tree_flatten_with_path(
                 {"params": jparams, "m": jstate["m"], "v": jstate["v"]})[0]}
    for name, tree in (("params", params), ("m", state["m"]),
                       ("v", state["v"])):
        for path, leaf in leaves_with_path(tree):
            want = jflat[f"['{name}']" + path]
            got = leaf.float().numpy()
            tol = 1e-6 * np.abs(want).max()
            if name != "params":
                assert leaf.dtype == torch.bfloat16
                tol = tol + BF16_ULP * np.maximum(np.abs(got), np.abs(want))
            assert (np.abs(got - want) <= tol).all(), (name, path)


def test_global_norm():
    tree = _tree(1)
    want = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                       for _, a in leaves_with_path(tree)))
    assert float(global_norm(map_tree(torch.tensor, tree))) == pytest.approx(
        want, rel=1e-6)


def _run_quadratic(moment_dtype, steps=300):
    """min ||w - target||^2 from zero (the JAX test's problem)."""
    target = torch.linspace(-1.0, 1.0, 16)
    params = {"w": torch.zeros(16)}
    state = adamw_init(params)
    cfg = AdamWConfig(moment_dtype=moment_dtype, weight_decay=0.0)
    for _ in range(steps):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state, _ = adamw_update(params, g, state, 0.05, cfg)
    assert state["m"]["w"].dtype == moment_dtype
    return float(((params["w"] - target) ** 2).sum())


def test_adamw_converges():
    assert _run_quadratic(torch.bfloat16) < 1e-3


def test_bf16_moments_match_fp32_convergence():
    l_bf16 = _run_quadratic(torch.bfloat16)
    l_f32 = _run_quadratic(torch.float32)
    assert l_bf16 < 10 * max(l_f32, 1e-9) + 1e-6


def test_grad_clipping_bounds_update():
    params = {"w": torch.tensor([0.0])}
    state = adamw_init(params)
    _, _, metrics = adamw_update(params, {"w": torch.tensor([1e6])}, state,
                                 1e-3, AdamWConfig(clip_norm=1.0,
                                                   weight_decay=0.0))
    assert float(metrics["clip_scale"]) < 1e-5
    assert float(metrics["grad_norm"]) == pytest.approx(1e6, rel=1e-3)


def test_weight_decay_only_on_matrices():
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = adamw_init(params)
    g = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    new, _, _ = adamw_update(params, g, state, 0.1, AdamWConfig(weight_decay=0.1))
    assert new is params                      # updated in place
    assert float(new["w"][0, 0]) < 1.0        # decayed
    assert float(new["b"][0]) == pytest.approx(1.0)   # not decayed


def test_constant_schedule_and_moments_live_by_their_params():
    assert float(constant_schedule(0.5)(7)) == 0.5
    params = {"a": torch.zeros(3, dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state["m"]["a"].dtype == torch.bfloat16
    assert state["step"].device.type == "cpu" and int(state["step"]) == 0
