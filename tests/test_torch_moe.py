"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Inputs come from numpy with a seed; the parameters are the JAX package's
``init_params`` of ``moe_spec`` for a ``reduced()`` config, plus seeded
noise, carried over as tensors.  Two configs: moonshot-v1-16b-a3b's (no
shared experts) and deepseek-v2-236b's (two shared experts).

Tolerances, stated with the arithmetic behind them:

* routing (the slot of every assignment, hence which assignments capacity
  drops and where the kept ones land): equal, given the same router
  logits — including logits with exact ties (the lower expert index
  first, as ``jax.lax.top_k``); the f32 combine weights within 1e-6 of
  the largest (the softmax's sum in another order);
* f32 outputs and aux losses: within 1e-5 of the largest magnitude (the
  same products, summed in another order);
* bf16 outputs: within one bf16 ulp of each value plus 1e-5 of the largest
  magnitude.  The bf16 inputs are dyadic (a few bits each), so the router
  logits are exact in both frameworks and the routing is the same; only
  the expert products' f32 sums round in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as jmoe
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.models import moe

BF16_ULP = 2.0 ** -7
ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")


def _cfgs(arch, **changes):
    cfg = dataclasses.replace(configs.get(arch).reduced(), **changes)
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **changes)
    return cfg, jcfg


def _params(jcfg, seed, dyadic=False):
    """(JAX tree of arrays, the same as a dict of tensors)."""
    tree = j_init_params(jmoe.moe_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
        if dyadic:                          # 4 fraction bits, |w| < 1
            a = np.clip(np.round(a * 16) / 16, -0.9375, 0.9375)
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map(leaf, tree)
    as_torch = jax.tree_util.tree_map(torch.from_numpy, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), as_torch


def _x(shape, seed, dyadic=False):
    x = np.random.default_rng(seed).standard_normal(shape)
    if dyadic:                              # 2 fraction bits
        x = np.clip(np.round(x * 4) / 4, -2, 2)
    return x.astype(np.float32)


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _within_bf16_ulp(got, want, rtol=1e-5):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    tol = (BF16_ULP * np.maximum(np.abs(got), np.abs(want))
           + rtol * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()


def _j_route(logits, jcfg, c):
    """The JAX layer's routing of each group: (slot, weight, aux)."""
    g, d = logits.shape[1], 1

    def one(ll):
        _, slot, weight, _, aux = jmoe._route_group(
            jnp.zeros((g, d), jnp.float32), ll, jcfg, c)
        return slot, weight, aux

    return jax.vmap(one)(jnp.asarray(logits))


def test_spec_and_capacity_are_the_references():
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        full = configs.get(arch)
        for c_, jc in ((cfg, jcfg), (full, J_ARCHS[arch])):
            spec = moe.moe_spec(c_, stacked=3)
            jspec = jmoe.moe_spec(jc, stacked=3)
            assert jax.tree_util.tree_map(
                dataclasses.asdict, jspec,
                is_leaf=lambda s: hasattr(s, "axes")) == jax.tree_util.tree_map(
                dataclasses.asdict, spec,
                is_leaf=lambda s: hasattr(s, "axes"))
            for g in (1, 7, 64, 256, 1000):
                assert moe.capacity(c_, g) == jmoe.capacity(jc, g)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_routing_is_the_references_exactly(arch, capacity_factor):
    """Slots (which assignments are kept, and where), combine weights and
    aux losses, given the same logits, over several groups (of 400 tokens:
    capacity's floor of 8 slots an expert keeps every assignment of a
    small group)."""
    cfg, jcfg = _cfgs(arch, capacity_factor=capacity_factor)
    logits = _x((3, 400, cfg.n_experts), 1)
    c = moe.capacity(cfg, 400)
    slot, weight, aux = moe.route(torch.from_numpy(logits), cfg, c,
                                  with_aux=True)
    jslot, jweight, jaux = _j_route(logits, jcfg, c)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    _close(weight.numpy(), np.asarray(jweight), 1e-6)
    _close(aux.numpy(), np.asarray(jaux), 1e-6)
    dropped = int((slot == cfg.n_experts * c).sum())
    if capacity_factor < 1:        # as tests/test_models.py: most drop
        assert dropped > slot.numel() // 2
    assert torch.equal(weight == 0, slot == cfg.n_experts * c)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_breaks_exact_ties_as_jax_top_k(arch):
    """Router logits with exact ties (bf16 logits tie often): the lower
    expert index comes first, so both the experts kept and the order of
    the combine's sum are JAX's."""
    cfg, jcfg = _cfgs(arch, capacity_factor=0.5)
    rng = np.random.default_rng(2)
    # each row draws from 3 distinct values: many exact ties per row
    logits = rng.choice(np.array([-1.0, 0.5, 2.0], np.float32),
                        size=(2, 24, cfg.n_experts))
    c = moe.capacity(cfg, 24)
    slot, weight, _ = moe.route(torch.from_numpy(logits), cfg, c)
    jslot, jweight, _ = _j_route(logits, jcfg, c)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    _close(weight.numpy(), np.asarray(jweight), 1e-6)
    vals, idx = moe.top_k(torch.from_numpy(logits), cfg.top_k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group_size", [None, 4, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_apply_moe_f32_matches_the_reference(arch, group_size,
                                             capacity_factor):
    """One group per sequence (None: at capacity factor 0.1 most of its
    assignments drop), several per sequence (4) and one a token (1, the
    decode engine's); shared experts in deepseek's."""
    cfg, jcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, p = _params(jcfg, 3)
    x = _x((2, 96, cfg.d_model), 4)
    y, aux = moe.apply_moe(p, torch.from_numpy(x), cfg, group_size=group_size,
                           with_aux=True)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, group_size=group_size)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y.numpy(), jy, 1e-5)
    _close(aux.numpy(), jaux, 1e-5)
    y2, none = moe.apply_moe(p, torch.from_numpy(x), cfg,
                             group_size=group_size)
    assert none is None and torch.equal(y, y2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group_size", [None, 1])
def test_apply_moe_bf16_matches_the_reference(arch, group_size):
    cfg, jcfg = _cfgs(arch, dtype="bfloat16")
    jp, p = _params(jcfg, 5, dyadic=True)
    x = _x((2, 16, cfg.d_model), 6, dyadic=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, aux = moe.apply_moe(p, xb, cfg, group_size=group_size, with_aux=True)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                              group_size=group_size)
    assert y.dtype == torch.bfloat16
    # the same routing: logits are exact in both frameworks
    xg = xb.reshape(-1, group_size or 16, cfg.d_model)
    logits = moe.router_logits(xg, p["router"].to(torch.bfloat16))
    jlogits = jnp.einsum("ngd,de->nge", jnp.asarray(x, jnp.bfloat16).reshape(
        xg.shape), jp["router"].astype(jnp.bfloat16))
    np.testing.assert_array_equal(logits.float().numpy(),
                                  np.asarray(jlogits, np.float32))
    _within_bf16_ulp(y.float().numpy(), np.asarray(jy, np.float32))
    _close(aux.numpy(), jaux, 1e-5)


def test_combine_adds_the_k_rows_in_order_from_zero():
    """Each token's k weighted rows are added 0 .. k-1 from zero, rounding
    each sum to the rows' dtype (XLA's serial scatter-add); a dropped
    assignment adds its zero row."""
    y = torch.tensor([[[1.0, 2.0], [2 ** -8, 3.0], [2 ** -8, -1.0]]],
                     dtype=torch.bfloat16)                 # (1, E*c=3, 2)
    slot = torch.tensor([[0, 1, 2, 3]])                    # 3 = dummy row
    weight = torch.tensor([[1.0, 1.0, 1.0, 0.5]])
    out = moe.combine(y, slot, weight, k=2)                # 2 tokens
    # token 0: (0 + 1) + 2**-8 rounds to 1 in bf16; token 1: 2**-8 + 0
    assert out.tolist() == [[[1.0, 5.0], [2 ** -8, -1.0]]]


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_runs_on_meta_tensors(arch):
    """No data-dependent shape anywhere (no bincount, nonzero or mask
    indexing): the engine's capture runs the layer on ``meta`` tensors."""
    cfg, jcfg = _cfgs(arch)
    _, p = _params(jcfg, 7)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                else {n: t.to("meta") for n, t in v.items()})
            for k, v in p.items()}
    x = torch.empty((3, 10, cfg.d_model), device="meta")
    for gs in (None, 1, 5):
        y, aux = moe.apply_moe(meta, x, cfg, group_size=gs, with_aux=True)
        assert y.device.type == "meta" and y.shape == x.shape
        assert aux.shape == (2,)


def test_group_size_must_split_the_tokens():
    cfg, jcfg = _cfgs("moonshot-v1-16b-a3b")
    _, p = _params(jcfg, 8)
    with pytest.raises(ValueError, match="groups of 7"):
        moe.apply_moe(p, torch.zeros(2, 5, cfg.d_model), cfg, group_size=7)


def test_router_logits_are_fixed_shape_products(monkeypatch):
    """The router's product runs on chunks of ROUTER_ROWS token rows (the
    last padded), so a token's logits are the same bits in any batch; its
    values are the plain product's."""
    shapes = []
    real = torch.matmul

    def spy(a, b):
        shapes.append(tuple(a.shape))
        return real(a, b)

    x = torch.from_numpy(_x((3, 300, 16), 11))
    router = torch.from_numpy(_x((16, 8), 12))
    monkeypatch.setattr(moe.torch, "matmul", spy)
    got = moe.router_logits(x, router)
    monkeypatch.undo()
    assert shapes == [(moe.ROUTER_ROWS, 16)] * 4          # 900 rows -> 4
    assert got.shape == (3, 300, 8)
    _close(got.numpy(), (x @ router).numpy(), 1e-6)
    # a token's row alone and in the batch: the same bits
    alone = moe.router_logits(x[1:2, 7:8], router)
    assert torch.equal(alone[0, 0], got[1, 7])
