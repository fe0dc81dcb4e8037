"""Training the MoE and MLA stacks of the port against the JAX package's, on
the CPU: moonshot-v1-16b-a3b (attention + MoE) and deepseek-v2-236b (a dense
MLA first layer, then MLA + MoE with shared experts).

The configs are ``reduced()`` (float32): moonshot with two MoE layers,
deepseek with its dense first layer and two MLA + MoE layers.  The JAX
package initialises each model, every leaf gets seeded numpy noise, and the
same numpy tree goes to both packages (the port's through
``tree_from_jax``); batches come from the shared data pipeline (4 x 32
tokens: one routing group a sequence).  Two capacities: the config's
default (1.25), at which these batches drop assignments in every MoE layer,
and 8.0, at which nothing drops (``tests/test_mini_mesh.py``'s setting).

The routing is compared first, exactly: every MoE layer's slots (each
assignment's row in its group's buffer, the dummy row for a dropped one)
equal the JAX layer's on the JAX model's own inputs.  Then the training
rule of ``PERF.md`` section 2: loss, ``ce``, ``load_balance`` and
``router_z`` within 1e-5 relative, every leaf's gradient within 1e-4 of
that leaf's largest magnitude (the same f32 arithmetic in another
summation order).  Within the port, bit for bit: the remat policies
``none`` / ``dots`` / ``full`` (loss, aux and every gradient).
Microbatches: 2 against 1, the metrics within 1e-5 relative and the
gradient norm within 1e-3 (``tests/test_torch_train.py``'s rule; the aux
losses are means over routing groups, which a microbatch splits in
whole).  One ``make_train_step`` step against the JAX step: the metrics
within 1e-4 relative, the learning rate equal, each parameter within 1e-5
of its leaf's largest magnitude plus 3 % of the learning rate (Adam scales
a near-zero gradient's rounding noise to about one lr: the rule of
``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.models.params import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro.optim import wsd_schedule as j_wsd_schedule
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import (Transformer, bind_grads,
                                            check_trainable, forward)
from repro_torch.optim import adamw_init, wsd_schedule
from repro_torch.train.step import TrainConfig, make_train_step, value_and_grad

ARCHS = {"moonshot-v1-16b-a3b": 2, "deepseek-v2-236b": 3}   # n_layers
CAPACITY = {"default": None, "no drops": 8.0}


def _cfgs(name, capacity=None, **kw):
    changes = dict(n_layers=ARCHS[name], **kw)
    if capacity is not None:
        changes["capacity_factor"] = capacity
    return (dataclasses.replace(configs.get(name).reduced(), **changes),
            dataclasses.replace(jconfigs.ARCHS[name].reduced(), **changes))


def _numpy_tree(jcfg, seed=0):
    tree = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _batch(cfg, jcfg, step=0, b=4, s=32):
    return JSyntheticLMData(JDataConfig(b, s, cfg.vocab, seed=0),
                            jcfg).batch_at(step)


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(cfg, tree, batch, microbatches=1):
    params = tree_from_jax(tree, device="cpu")
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    metrics = value_and_grad(model, grads, map_tree(torch.from_numpy, batch),
                             cfg, microbatches)
    return metrics, grads


def _port_slots(monkeypatch, cfg, tree, batch):
    """Every MoE layer's routing slots in the port's training forward."""
    slots = []
    route = moe_mod.route

    def recording(logits, cfg_, c, *, with_aux=False):
        out = route(logits, cfg_, c, with_aux=with_aux)
        slots.append((out[0].numpy().copy(), c))
        return out

    monkeypatch.setattr(moe_mod, "route", recording)
    with torch.no_grad():
        forward(tree_from_jax(tree, device="cpu"),
                map_tree(torch.from_numpy, batch), cfg)
    monkeypatch.setattr(moe_mod, "route", route)
    return slots


def _jax_slots(monkeypatch, jcfg, tree, batch):
    """The same from the JAX forward (jitted), each layer's slots from
    ``_route_group`` on that layer's own inputs, sent to the host in layer
    order by an ordered callback."""
    slots = []
    apply_moe = j_transformer.apply_moe

    def recording(p, x, cfg_, *, group_size=None):
        b, s, d = x.shape
        g = group_size or s
        c = j_moe.capacity(cfg_, g)
        xg = x.reshape((b * s) // g, g, d)
        dt = jnp.dtype(cfg_.dtype)
        logits = jnp.einsum("ngd,de->nge", xg.astype(dt),
                            p["router"].astype(dt))
        _, slot, _, _, _ = jax.vmap(
            lambda xx, ll: j_moe._route_group(xx, ll, cfg_, c))(xg, logits)
        jax.debug.callback(lambda sl: slots.append((np.asarray(sl), c)), slot,
                           ordered=True)
        return apply_moe(p, x, cfg_, group_size=group_size)

    monkeypatch.setattr(j_transformer, "apply_moe", recording)
    jax.block_until_ready(jax.jit(lambda t, bt: j_forward(t, bt, jcfg))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}))
    jax.effects_barrier()
    monkeypatch.setattr(j_transformer, "apply_moe", apply_moe)
    return slots


def test_the_three_families_are_trainable():
    for name in ("moonshot-v1-16b-a3b", "deepseek-v2-236b", "hubert-xlarge"):
        check_trainable(configs.get(name))
        check_trainable(configs.get(name).reduced())


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_loss_aux_and_every_gradient_match_jax(monkeypatch, arch,
                                                       capacity):
    cfg, jcfg = _cfgs(arch, CAPACITY[capacity])
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    # the routing first: every MoE layer's slots equal the JAX layer's
    ours = _port_slots(monkeypatch, cfg, tree, batch)
    theirs = _jax_slots(monkeypatch, jcfg, tree, batch)
    moe_layers = sum(m == "moe" for m in cfg.mlp_pattern) * cfg.n_groups
    assert len(ours) == len(theirs) == moe_layers
    dropped = 0
    for (a, c), (b, jc) in zip(ours, theirs):
        assert c == jc
        np.testing.assert_array_equal(a, b)
        dropped += int((a == cfg.n_experts * c).sum())
    assert (dropped > 0) == (capacity == "default"), dropped

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_train_loss(p, jbatch, jcfg), has_aux=True))(tree)
    metrics, grads = _grads(cfg, tree, batch)
    assert metrics.keys() == jm.keys()
    for key in metrics:
        assert float(metrics[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                    abs=1e-30), key
    assert float(metrics["load_balance"]) > 0 and float(metrics["router_z"]) > 0
    want = _jflat(jg)
    for path, g in leaves_with_path(grads):
        ref = want[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)
    # the expert weights, the router and the shared experts all get a
    # gradient (a dropped assignment's slot gets none)
    for path, g in leaves_with_path(grads):
        if "['mlp']" in path and "['blocks']" in path:
            assert float(g.abs().max()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_bits(arch):
    cfg, jcfg = _cfgs(arch)
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    runs = {remat: _grads(dataclasses.replace(cfg, remat=remat), tree, batch)
            for remat in ("none", "dots", "full")}
    m0, g0 = runs["none"]
    for remat in ("dots", "full"):
        m, g = runs[remat]
        for key in m0:
            assert torch.equal(m[key], m0[key]), (remat, key)
        for (path, a), (_, b) in zip(leaves_with_path(g), leaves_with_path(g0)):
            assert torch.equal(a, b), (remat, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_the_full_batch(arch):
    cfg, jcfg = _cfgs(arch)
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    (m1, g1), (m2, g2) = (_grads(cfg, tree, batch, k) for k in (1, 2))
    for key in m1:
        assert float(m2[key]) == pytest.approx(float(m1[key]), rel=1e-5), key
    norm = [_grad_norm(g) for g in (g1, g2)]
    assert norm[1] == pytest.approx(norm[0], rel=1e-3)


def _grad_norm(grads):
    return float(torch.sqrt(sum((g.double() ** 2).sum()
                                for _, g in leaves_with_path(grads))))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    cfg, jcfg = _cfgs(arch, remat="none")
    tree = _numpy_tree(jcfg, seed=1)
    lr = 1e-2
    jstep = jax.jit(j_make_train_step(
        jcfg, JTrainConfig(peak_lr=lr, total_steps=20, remat="none"),
        j_wsd_schedule(lr, 20)))
    step = make_train_step(cfg, TrainConfig(peak_lr=lr, total_steps=20,
                                            remat="none"),
                           wsd_schedule(lr, 20))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
    params = tree_from_jax(tree, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    lr_sum = 0.0
    for i in range(2):          # WSD's first step has lr 0: the second moves
        batch = _batch(cfg, jcfg, step=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, map_tree(torch.from_numpy, batch))
        assert m.keys() == jm.keys()
        assert float(m["lr"]) == float(jm["lr"])
        for key in m:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4,
                                                  abs=1e-30), key
        lr_sum += float(m["lr"])
    assert lr_sum > 0
    want = _jflat(jstate["params"])
    for path, p in leaves_with_path(params):
        ref = want[path]
        np.testing.assert_allclose(p.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max() + 0.03 * lr_sum,
                                   err_msg=path)
