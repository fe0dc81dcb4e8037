"""The FSDP weight gather (``cfg.fsdp_gather_weights``, on by default) in an
unsharded bf16 train step, in the port against the JAX package, on the CPU.

The gather casts each f32 master of two or more dims (per layer; expert
weights excepted) to the compute dtype before the layer reads it, on one
device too, as the JAX package's ``_gather_group_params`` does.  A leaf that
a block reads in f32 (rwkv's ``u_bonus``, mamba's ``a_log``) is then read
rounded to bf16, and its gradient comes back through the cast: every entry
is a bf16 value.  The f32 train tests cannot see this (the cast is skipped
in an f32 compute dtype), so here reduced rwkv6-3b (the cut of
``tests/test_torch_train_rwkv.py``) and jamba-1.5-large-398b's first layer
(mamba + dense, as ``chip_smoke.py`` phase 11i cuts it) take the loss's
gradient in bf16 compute from the same numpy tree in both packages:

* the leaves whose gradient is all bf16 values are the same in both;
* among them are the f32-read leaves, whose gradient has other values when
  the port's step runs with ``fsdp_gather_weights=False`` (so the check
  fails without the cast).
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
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import train_loss as j_train_loss
from repro_torch import configs
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import Transformer, bind_grads
from repro_torch.train.step import value_and_grad

#: each arch's cut, and the leaves its blocks read in f32
CASES = {
    "rwkv6-3b": (dict(n_layers=2, rwkv_head_dim=64), ("u_bonus",)),
    "jamba-1.5-large-398b": (None, ("a_log",)),
}


def _cfgs(arch):
    cut, _ = CASES[arch]
    out = []
    for cfg in (configs.get(arch).reduced(), jconfigs.ARCHS[arch].reduced()):
        if cut is None:                      # jamba: its first layer
            cut = dict(n_layers=1, block_pattern=cfg.block_pattern[:1],
                       mlp_pattern=cfg.mlp_pattern[:1])
        out.append(dataclasses.replace(cfg, dtype="bfloat16", **cut))
    return out


def _numpy_tree(jcfg):
    tree = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _all_bf16(g: np.ndarray) -> bool:
    t = torch.from_numpy(np.array(g, np.float32))
    return bool(torch.equal(t.to(torch.bfloat16).float(), t))


def _port_grads(cfg, tree, batch):
    params = tree_from_jax(tree, device="cpu")
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    value_and_grad(model, grads, map_tree(torch.from_numpy, batch), cfg)
    return {p: g.numpy() for p, g in leaves_with_path(grads)}


@pytest.mark.parametrize("arch", list(CASES))
def test_bf16_gradients_come_through_the_gather_as_in_jax(arch):
    cfg, jcfg = _cfgs(arch)
    assert cfg.fsdp_gather_weights and jcfg.fsdp_gather_weights
    tree = _numpy_tree(jcfg)
    batch = JSyntheticLMData(JDataConfig(4, 32, cfg.vocab, seed=0),
                             jcfg).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: j_train_loss(p, jbatch, jcfg)[0]))(tree)
    want = {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = _port_grads(cfg, tree, batch)
    assert got.keys() == want.keys()
    cast = {p: _all_bf16(g) for p, g in got.items()}
    assert cast == {p: _all_bf16(g) for p, g in want.items()}

    ungathered = _port_grads(dataclasses.replace(
        cfg, fsdp_gather_weights=False), tree, batch)
    for name in CASES[arch][1]:
        paths = [p for p in got if p.endswith(f"['{name}']")]
        assert paths, name
        for p in paths:
            assert cast[p] and np.abs(got[p]).max() > 0, p
            assert not _all_bf16(ungathered[p]), p
