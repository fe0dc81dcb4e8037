"""Training paligemma-3b (the vision frontend, an ``attn`` + GeGLU stack with
tied embeddings and heads of 256) in the port against the JAX package, on
the CPU.

* The plain flash-attention gradient at Dk = Dv = 256 (paligemma's heads,
  which the card's backward kernels take since they run (256, 256)) against
  ``jax.grad`` of the JAX package's XLA path, in f32: causal and not, MQA,
  a ragged S over the blocks; within 1e-5 of each gradient's largest
  magnitude (the same f32 arithmetic in another order).
* The config is ``reduced()`` (float32, d_model 128, 4 query heads over one
  kv head) with 2 layers and ``head_dim`` 256, so the attention runs at
  paligemma's own head dims; the JAX package initialises it, every leaf
  gets seeded numpy noise, and the same numpy tree goes to both packages.
  The batch is the shared pipeline's, {"tokens", "labels" (B, S), "patches"
  (B, P, 1152)}: P patch rows prepended, whose logits take no loss.
* The training rule of ``PERF.md`` section 2: loss and metrics within 1e-5
  relative, every leaf's gradient (the frontend's ``proj`` and the tied
  embedding included) within 1e-4 of that leaf's largest magnitude; after
  two AdamW steps (WSD: the first has lr 0) metrics within 1e-4 relative
  and parameters within 1e-5 of each leaf's largest magnitude plus 3 % of
  the learning rates summed; the remat policies bit for bit within the
  port.  The tied embedding's gradient is the sum of its two uses' (the
  token lookup and the logits), as ``jax.grad`` adds them.
* The launcher's ``--smoke --device cpu`` run of paligemma-3b prints
  "done" with finite losses.
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
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro.optim import wsd_schedule as j_wsd_schedule
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import (Transformer, bind_grads,
                                            check_trainable)
from repro_torch.optim import adamw_init, wsd_schedule
from repro_torch.train.step import TrainConfig, make_train_step, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
ARCH = "paligemma-3b"
GRAD_RTOL = 1e-5


def _cfgs():
    cut = dict(n_layers=2, head_dim=256)
    return (dataclasses.replace(configs.get(ARCH).reduced(), **cut),
            dataclasses.replace(jconfigs.ARCHS[ARCH].reduced(), **cut))


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


def _qkv(seed, b, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)))


@pytest.mark.parametrize("causal,h,kvh,s,bq,bk", [
    (True, 4, 1, 40, 16, 16),       # MQA, S ragged over the blocks
    (True, 8, 1, 24, 512, 512),     # paligemma's group of 8, one block
    (True, 2, 2, 33, 16, 8),        # MHA, ragged
    (False, 4, 1, 32, 512, 16),     # non-causal MQA over kv blocks
    (False, 2, 2, 20, 512, 512)])
def test_plain_gradient_at_256_matches_jax_grad_of_the_xla_path(causal, h, kvh,
                                                                s, bq, bk):
    q, k, v = _qkv(s + h, 2, h, kvh, s, 256)
    dout = _qkv(s + h + 1, 2, h, kvh, s, 256)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, causal=causal, bq=bq, bk=bk).backward(dout)

    def loss(q_, k_, v_):
        o = j_flash(q_, k_, v_, causal=causal, bq=bq, bk=bk, impl="xla")
        return jnp.sum(o * jnp.asarray(dout.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for got, ref in zip(leaves, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_256_routes_to_the_tensor_cores_in_bf16(dtype, route):
    """The card's backward takes (256, 256): bf16 on ``wgmma`` (the forward
    too), f32 on the CUDA cores."""
    assert (256, 256) in fa.BWD_PAIRS and (256, 256) in fa.BWD_MMA_PAIRS
    assert (256, 256) in fa.MMA_HEAD_DIMS
    assert fa.bwd_route(dtype, 256) == route == fa.bwd_route(dtype, 256, 256)


def test_paligemma_is_trainable():
    for cfg in (configs.get(ARCH), configs.get(ARCH).reduced(), _cfgs()[0]):
        check_trainable(cfg)
    assert "vision" in transformer.FRONTENDS


def test_the_vision_batch_is_the_jax_pipelines():
    cfg, jcfg = _cfgs()
    ours = SyntheticLMData(DataConfig(4, 32, cfg.vocab, seed=0),
                           cfg).batch_at(3)
    theirs = JSyntheticLMData(JDataConfig(4, 32, cfg.vocab, seed=0),
                              jcfg).batch_at(3)
    assert ours.keys() == theirs.keys() == {"tokens", "labels", "patches"}
    assert ours["patches"].shape == (4, cfg.n_prefix_embed, 1152)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


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
    want = _jflat(jg)
    got = dict(leaves_with_path(grads))
    assert got.keys() == want.keys()
    for path, g in got.items():
        ref = want[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)
    # the frontend's projection learns from the text's loss through the
    # prefix; the tied embedding has no separate head
    assert set(dict(leaves_with_path(grads["frontend"]))) == {"['proj']"}
    assert float(grads["frontend"]["proj"].abs().max()) > 0
    assert "lm_head" not in grads["embed"]


def test_the_tied_embedding_adds_both_uses(monkeypatch):
    """The embedding's gradient is that of the token lookup plus that of
    the logits: each alone (the other use's weight detached) is non-zero,
    and their sum is the whole gradient (and so ``jax.grad``'s, above)."""
    cfg, jcfg = _cfgs()
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    whole = _grads(cfg, tree, batch)[1]["embed"]["embedding"]

    def detached(fn):
        return lambda p, *args: fn({"embedding": p["embedding"].detach()},
                                   *args)

    parts = []
    for name in ("embed_tokens", "logits_from_hidden"):
        with monkeypatch.context() as m:
            m.setattr(transformer, name, detached(getattr(transformer, name)))
            parts.append(_grads(cfg, tree, batch)[1]["embed"]["embedding"])
    logits_only, lookup_only = parts
    tokens = np.unique(batch["tokens"])
    unused = np.setdiff1d(np.arange(cfg.vocab), tokens)
    assert float(lookup_only[unused].abs().max()) == 0.0
    assert float(lookup_only[tokens].abs().min()) > 0
    assert float(logits_only[unused].abs().min()) > 0
    torch.testing.assert_close(logits_only + lookup_only, whole, rtol=0,
                               atol=1e-6 * float(whole.abs().max()))


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
