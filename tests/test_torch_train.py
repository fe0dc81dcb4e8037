"""The port's training path against the JAX package's, on the CPU.

The JAX package initialises each model; every leaf then gets seeded numpy
noise and the same numpy tree goes to both packages (the port's through
``tree_from_jax``).  Configs are ``reduced()`` (float32) with 2 layers, for
stablelm-1.6b (LayerNorm with bias, qkv bias, partial rotary), minicpm-2b
(tied embeddings, ``scale_emb``, depth-scaled residuals, scaled logits)
and qwen2.5-3b (GQA); batches from the shared data pipeline.

Tolerances, measured on these inputs and stated with a margin:

* loss within 1e-5 relative, hidden states within 1e-5 of their largest
  magnitude, every leaf's gradient within 1e-4 of that leaf's largest
  magnitude (measured up to 3e-6): the same f32 arithmetic in another
  summation order;
* after three train steps (AdamW, bf16 moments, WSD): metrics within 1e-4
  relative, the learning rate equal; parameters within 1e-5 of each leaf's
  largest magnitude plus 3 % of the learning rates summed over the steps.
  Adam scales every update to about lr whatever the gradient's size, so a
  last-bit difference of a near-zero gradient or a bf16 moment one ulp
  apart moves a parameter by a fraction of lr (measured up to 1.5 %); a
  wrong term of the update moves it by about lr.  The key bias ``bk`` is
  held only to 2 x that sum (its steps' size): its gradient is zero in
  exact arithmetic (softmax ignores a shift common to a query's scores),
  so each package's steps follow its own rounding noise;
* microbatches 4 against 1: the JAX test's tolerance
  (``tests/test_integration.py``), grad norm 1e-3 relative and parameters
  rtol 1e-2 + atol 1e-4, here on every leaf;
* within the port, bit for bit: remat ``none`` / ``dots`` / ``full``, and
  the checkpoint-restart run against the uninterrupted one.
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
from repro.models.params import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro.optim import wsd_schedule as j_wsd_schedule
from repro.train.serve import make_prefill_step as j_make_prefill_step
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.launch.train import train_loop
from repro_torch.models.convert import params_from_jax, tree_from_jax
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import (Transformer, bind_grads,
                                            check_trainable, forward,
                                            train_loss)
from repro_torch.optim import adamw_init, wsd_schedule
from repro_torch.train.serve import make_prefill_step
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step, value_and_grad)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm-1.6b", "minicpm-2b", "qwen2.5-3b")


def _cfgs(name, n_layers=2):
    return (dataclasses.replace(configs.get(name).reduced(), n_layers=n_layers),
            dataclasses.replace(jconfigs.ARCHS[name].reduced(),
                                n_layers=n_layers))


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


def _grads(cfg, params, batch, microbatches=1):
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    metrics = value_and_grad(model, grads, map_tree(torch.from_numpy, batch),
                             cfg, microbatches)
    return metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_every_gradient_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: j_train_loss(p, jbatch, jcfg), has_aux=True)(tree)
    params = tree_from_jax(tree, device="cpu")
    metrics, grads = _grads(cfg, params, batch)
    assert metrics.keys() == jm.keys() == {"ce", "load_balance", "router_z",
                                           "loss"}
    for key in metrics:
        assert float(metrics[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                    abs=1e-30)
    want = _jflat(jg)
    for path, g in leaves_with_path(grads):
        ref = want[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)
    hidden, aux = forward(tree_from_jax(tree, device="cpu"),
                          map_tree(torch.from_numpy, batch), cfg)
    jhidden, jaux = j_forward(tree, jbatch, jcfg)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jhidden)).max())
    assert torch.equal(aux, torch.zeros(2))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    tree = _numpy_tree(jcfg, seed=1)
    tcfg = TrainConfig(peak_lr=1e-2, total_steps=20, remat="none")
    jtcfg = JTrainConfig(peak_lr=1e-2, total_steps=20, remat="none")
    jstep = jax.jit(j_make_train_step(jcfg, jtcfg, j_wsd_schedule(1e-2, 20)))
    step = make_train_step(cfg, tcfg, wsd_schedule(1e-2, 20))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
    params = tree_from_jax(tree, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(cfg, jcfg, step=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, map_tree(torch.from_numpy, batch))
        assert m.keys() == jm.keys()
        assert float(m["lr"]) == float(jm["lr"])
        for key in m:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4,
                                                  abs=1e-30), key
        lr_sum += float(m["lr"])
    assert state["params"] is params                 # updated in place
    assert int(state["opt"]["step"]) == 3
    want = _jflat(jstate["params"])
    for path, p in leaves_with_path(params):
        ref = want[path]
        steps = 2.0 if path.endswith("['bk']") else 0.03
        np.testing.assert_allclose(
            p.numpy(), ref, rtol=0,
            atol=1e-5 * np.abs(ref).max() + steps * lr_sum, err_msg=path)


def test_microbatches_match_the_full_batch():
    cfg, jcfg = _cfgs("qwen2.5-3b")
    tree = _numpy_tree(jcfg)
    batch = map_tree(torch.from_numpy, _batch(cfg, jcfg, b=8))
    out = []
    for k in (1, 4):
        tcfg = TrainConfig(microbatches=k, remat="none")
        params = tree_from_jax(tree, device="cpu")
        state = {"params": params, "opt": adamw_init(params)}
        state, m = make_train_step(cfg, tcfg, wsd_schedule(1e-3, 10))(state,
                                                                     batch)
        out.append((state, m))
    (s1, m1), (s4, m4) = out
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]),
                                                   rel=1e-3)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for (path, a), (_, b) in zip(leaves_with_path(s1["params"]),
                                 leaves_with_path(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2, atol=1e-4,
                                   err_msg=path)
    # a batch that does not split into k equal slices is refused, as JAX's
    # reshape to (k, B // k, ...) refuses it
    with pytest.raises(ValueError, match="microbatches"):
        tcfg = TrainConfig(microbatches=4, remat="none")
        params = tree_from_jax(tree, device="cpu")
        make_train_step(cfg, tcfg, wsd_schedule(1e-3, 10))(
            {"params": params, "opt": adamw_init(params)},
            map_tree(torch.from_numpy, _batch(cfg, jcfg, b=10)))


def test_remat_policies_give_the_same_bits():
    cfg, jcfg = _cfgs("stablelm-1.6b", n_layers=3)
    tree = _numpy_tree(jcfg)
    batch = _batch(cfg, jcfg)
    runs = {}
    for remat in ("none", "dots", "full"):
        rcfg = dataclasses.replace(cfg, remat=remat)
        runs[remat] = _grads(rcfg, tree_from_jax(tree, device="cpu"), batch)
    (m0, g0) = runs["none"]
    for remat in ("dots", "full"):
        m, g = runs[remat]
        assert torch.equal(m["loss"], m0["loss"]), remat
        for (path, a), (_, b) in zip(leaves_with_path(g), leaves_with_path(g0)):
            assert torch.equal(a, b), (remat, path)
    with pytest.raises(ValueError, match="remat"):
        _grads(dataclasses.replace(cfg, remat="some"),
               tree_from_jax(tree, device="cpu"), batch)


def test_checkpoint_restart_continuity(tmp_path):
    """Killed at step 16 (after the step-16 checkpoint) and resumed, the
    run's losses are the uninterrupted run's, bit for bit."""
    cfg = configs.get("stablelm-1.6b").reduced()
    tcfg = TrainConfig(peak_lr=1e-3, total_steps=30, remat="none")
    kw = dict(steps=24, global_batch=4, seq_len=32, seed=1, device="cpu")
    _, gold = train_loop(cfg, tcfg, **kw)
    ck = dict(ckpt_dir=str(tmp_path / "ck"), ckpt_every=8)
    with pytest.raises(SystemExit) as exc:
        train_loop(cfg, tcfg, simulate_failure=16, **ck, **kw)
    assert exc.value.code == 42
    _, resumed = train_loop(cfg, tcfg, **ck, **kw)
    assert len(resumed) == 24 - 17
    assert resumed == gold[17:]


def test_trainer_cli_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "done" in out.stdout
    first = float(out.stdout.split("first loss ")[1].split()[0])
    assert math.isfinite(first)


def test_train_state_defaults_to_the_card_and_bf16_params():
    cfg = configs.get("qwen2.5-3b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_train_state(cfg, TrainConfig(), 0)
    state = init_train_state(cfg, TrainConfig(param_dtype="bfloat16"), 0,
                             device="cpu")
    assert all(t.dtype == torch.bfloat16
               for _, t in leaves_with_path(state["params"]))
    data = JSyntheticLMData(JDataConfig(2, 16, cfg.vocab), None).batch_at(0)
    state, m = make_train_step(cfg, TrainConfig(param_dtype="bfloat16",
                                                remat="none"),
                               wsd_schedule(1e-3, 10))(
        state, map_tree(torch.from_numpy, data))
    assert math.isfinite(float(m["loss"]))
    assert all(t.dtype == torch.bfloat16
               for _, t in leaves_with_path(state["params"]))


@pytest.mark.parametrize("arch,item", [
    ("rwkv6-3b", "7b"), ("jamba-1.5-large-398b", "7c")])
def test_untrained_families_raise_naming_the_roadmap(arch, item):
    cfg = configs.get(arch).reduced()
    for call in (lambda: check_trainable(cfg),
                 lambda: train_loss({}, {}, cfg),
                 lambda: make_train_step(cfg, TrainConfig(), None),
                 lambda: init_train_state(cfg, TrainConfig(), 0,
                                          device="meta")):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md queue 1, step {item}"):
            call()


def test_paligemma_trains_through_every_entry_point():
    """The entry points that refuse rwkv6-3b and jamba take paligemma-3b
    (the vision frontend; its heads of 256 on the (256, 256) flash backward
    on the card): a finite loss from its image + text batch."""
    cfg = configs.get("paligemma-3b").reduced()
    jcfg = jconfigs.ARCHS["paligemma-3b"].reduced()
    check_trainable(cfg)
    step = make_train_step(cfg, TrainConfig(remat="none"),
                           wsd_schedule(1e-3, 10))
    state = init_train_state(cfg, TrainConfig(), 0, device="cpu")
    assert state["params"]["frontend"]["proj"].shape == (1152, cfg.d_model)
    state, m = step(state, map_tree(torch.from_numpy, _batch(cfg, jcfg)))
    assert math.isfinite(float(m["loss"]))
    loss, _ = train_loss(state["params"],
                         map_tree(torch.from_numpy, _batch(cfg, jcfg, 1)), cfg)
    assert math.isfinite(float(loss))



def test_hubert_encode_matches_jax():
    cfg, jcfg = _cfgs("hubert-xlarge")
    tree = _numpy_tree(jcfg)
    frames = np.random.default_rng(2).standard_normal(
        (2, 64, 512)).astype(np.float32)
    want = np.asarray(j_make_prefill_step(jcfg, 64)(
        tree, {"frames": jnp.asarray(frames)}))
    got = make_prefill_step(cfg, 64)(params_from_jax(cfg, tree, device="cpu"),
                                     {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
