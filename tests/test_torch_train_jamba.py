"""Training jamba-1.5-large-398b (``mamba`` blocks over the selective scan
with dense and MoE MLPs, and an ``attn`` + MoE layer) in the port against
the JAX package, on the CPU.

* The config is ``reduced()`` (float32, d_model 128, Mamba d_inner 256,
  d_state 16) cut to the first four layers of its period of 8, as
  ``chip_smoke.py`` cuts jamba: mamba + dense, mamba + MoE, mamba + dense,
  attn + MoE, so every (block, mlp) pair of the arch trains.  The whole
  period is not a yardstick in f32: there a relative change of 1e-7 in
  the parameters moves the JAX package's own gradients by 3.3e-4 of a
  leaf's largest magnitude (``a_log``; its router z-loss is 35), more
  than the rule's 1e-4, so two f32 summation orders part by that much;
  at four layers the same change moves them by 3.8e-5 (``PYTHONPATH=src
  python tests/test_torch_train_jamba.py`` prints both).  The JAX package
  initialises the cut, every leaf gets seeded numpy noise, and the same
  numpy tree goes to both packages; the batch is the shared pipeline's
  (4 x 32 tokens: one routing group a sequence).
* The routing first, exactly: every MoE layer's slots equal the JAX
  layer's on the JAX model's own inputs.  Then the training rule of
  ``PERF.md`` section 2: loss, ``ce``, ``load_balance`` and ``router_z``
  within 1e-5 relative, every leaf's gradient within 1e-4 of that leaf's
  largest magnitude; after two AdamW steps (WSD: the first has lr 0)
  metrics within 1e-4 relative and parameters within 1e-5 of each leaf's
  largest magnitude plus 3 % of the learning rates summed; the remat
  policies bit for bit within the port.  Every leaf of a mamba block gets a
  gradient (``a_log``, ``dt_bias``, ``d_skip`` and the conv among them).
* The launcher's ``--smoke --device cpu`` run of jamba prints "done" with
  finite losses.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]
ARCH = "jamba-1.5-large-398b"


#: layers of the cut: the period's first four
N_LAYERS = 4


def _cut(cfg):
    return dataclasses.replace(
        cfg, n_layers=N_LAYERS, block_pattern=cfg.block_pattern[:N_LAYERS],
        mlp_pattern=cfg.mlp_pattern[:N_LAYERS])


def _cfgs():
    return (_cut(configs.get(ARCH).reduced()),
            _cut(jconfigs.ARCHS[ARCH].reduced()))


def _numpy_tree(jcfg, seed=0):
    tree = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _batch(cfg, jcfg, step=0):
    return JSyntheticLMData(JDataConfig(4, 32, cfg.vocab, seed=0),
                            jcfg).batch_at(step)


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(cfg, tree, batch):
    params = tree_from_jax(tree, device="cpu")
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    metrics = value_and_grad(model, grads, map_tree(torch.from_numpy, batch),
                             cfg)
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


def test_jamba_is_trainable():
    cfg = _cfgs()[0]
    for c in (configs.get(ARCH), configs.get(ARCH).reduced(), cfg):
        check_trainable(c)
    pairs = set(zip(cfg.block_pattern, cfg.mlp_pattern))
    assert {("mamba", "dense"), ("mamba", "moe"), ("attn", "moe")} <= pairs


def test_routing_slots_match_jax(monkeypatch):
    cfg, jcfg = _cfgs()
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    ours = _port_slots(monkeypatch, cfg, tree, batch)
    theirs = _jax_slots(monkeypatch, jcfg, tree, batch)
    moe_layers = sum(m == "moe" for m in cfg.mlp_pattern) * cfg.n_groups
    assert len(ours) == len(theirs) == moe_layers
    for (a, c), (b, jc) in zip(ours, theirs):
        assert c == jc
        np.testing.assert_array_equal(a, b)


def test_loss_and_every_gradient_match_jax():
    cfg, jcfg = _cfgs()
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
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
    got = dict(leaves_with_path(grads))
    assert got.keys() == want.keys()
    for path, g in got.items():
        ref = want[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "dt_bias", "a_log", "d_skip", "out_proj"):
        assert float(grads["blocks"]["pos1"]["block"][name].abs().max()) > 0, name


def test_two_train_steps_match_jax():
    cfg, jcfg = _cfgs()
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


def test_remat_policies_give_the_same_bits():
    cfg, jcfg = _cfgs()
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    runs = {remat: _grads(dataclasses.replace(cfg, remat=remat), tree, batch)
            for remat in ("none", "dots", "full")}
    m0, g0 = runs["none"]
    for remat in ("dots", "full"):
        m, g = runs[remat]
        assert torch.equal(m["loss"], m0["loss"]), remat
        for (path, a), (_, b) in zip(leaves_with_path(g), leaves_with_path(g0)):
            assert torch.equal(a, b), (remat, path)


def test_trainer_cli_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "done" in out.stdout
    first = float(out.stdout.split("first loss ")[1].split()[0])
    last = float(out.stdout.split("last loss ")[1].split()[0])
    assert math.isfinite(first) and math.isfinite(last)


def _jax_conditioning(n_layers, eps=1e-7):
    """How far a relative change of ``eps`` in the parameters (numpy seed
    5) moves the JAX package's own gradients of the first ``n_layers``
    layers of the period, as the tests draw them: {leaf: change / max |g|}."""
    jcfg = dataclasses.replace(
        jconfigs.ARCHS[ARCH].reduced(), n_layers=n_layers,
        block_pattern=jconfigs.ARCHS[ARCH].reduced().block_pattern[:n_layers],
        mlp_pattern=jconfigs.ARCHS[ARCH].reduced().mlp_pattern[:n_layers])
    tree = _numpy_tree(jcfg)
    jbatch = {k: jnp.asarray(v)
              for k, v in _batch(_cfgs()[0], jcfg).items()}
    grad = jax.jit(jax.grad(lambda p: j_train_loss(p, jbatch, jcfg)[0]))
    rng = np.random.default_rng(5)
    moved = jax.tree_util.tree_map(
        lambda a: (a * (1 + eps * rng.standard_normal(a.shape))
                   ).astype(np.float32), tree)
    g0, g1 = _jflat(grad(tree)), _jflat(grad(moved))
    return {p: float(np.abs(g1[p] - g0[p]).max() / np.abs(g0[p]).max())
            for p in g0}


if __name__ == "__main__":
    # the cut's reason: PYTHONPATH=src python tests/test_torch_train_jamba.py
    for n in (8, N_LAYERS):
        worst = sorted(((v, p) for p, v in _jax_conditioning(n).items()),
                       reverse=True)[:3]
        print(f"first {n} layers: gradient change / max |g| under a 1e-7 "
              f"relative change of the parameters: "
              + ", ".join(f"{v:.3g} {p}" for v, p in worst))
