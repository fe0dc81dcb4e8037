"""Training hubert-xlarge (the audio frontend, a bidirectional ``attn`` +
dense stack) in the port against the JAX package, on the CPU, and the
trainer's command line for each family this slice trains.

The config is ``reduced()`` (float32, 2 layers); the JAX package
initialises it, every leaf gets seeded numpy noise, and the same numpy tree
goes to both packages.  The batch is the shared pipeline's audio batch,
{"frames" (B, S, 512), "labels" (B, S)}: per-frame cluster targets.  The
training rule of ``PERF.md`` section 2: loss and metrics within 1e-5
relative, every leaf's gradient (the frontend's adapter and LayerNorm
included) within 1e-4 of that leaf's largest magnitude; the remat policies
bit for bit within the port.  The launcher's ``--smoke --device cpu`` run
of moonshot-v1-16b-a3b, deepseek-v2-236b and hubert-xlarge prints "done"
with finite losses.
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
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import train_loss as j_train_loss
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import Transformer, bind_grads
from repro_torch.train.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
ARCH = "hubert-xlarge"


def _setup():
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), n_layers=2)
    jcfg = dataclasses.replace(jconfigs.ARCHS[ARCH].reduced(), n_layers=2)
    tree = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)
    batch = JSyntheticLMData(JDataConfig(4, 32, cfg.vocab, seed=0),
                             jcfg).batch_at(0)
    return cfg, jcfg, tree, batch


def _grads(cfg, tree, batch):
    params = tree_from_jax(tree, device="cpu")
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    metrics = value_and_grad(model, grads, map_tree(torch.from_numpy, batch),
                             cfg)
    return metrics, grads


def test_the_audio_batch_is_the_jax_pipelines():
    cfg, jcfg, _, _ = _setup()
    ours = SyntheticLMData(DataConfig(4, 32, cfg.vocab, seed=0), cfg).batch_at(3)
    theirs = JSyntheticLMData(JDataConfig(4, 32, cfg.vocab, seed=0),
                              jcfg).batch_at(3)
    assert ours.keys() == theirs.keys() == {"frames", "labels"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_loss_and_every_gradient_match_jax():
    cfg, jcfg, tree, batch = _setup()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_train_loss(p, jbatch, jcfg), has_aux=True))(tree)
    metrics, grads = _grads(cfg, tree, batch)
    assert metrics.keys() == jm.keys()
    for key in metrics:
        assert float(metrics[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                    abs=1e-30), key
    assert float(metrics["load_balance"]) == float(metrics["router_z"]) == 0.0
    want = {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for path, g in leaves_with_path(grads):
        ref = want[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)
    frontend = dict(leaves_with_path(grads["frontend"]))
    assert set(frontend) == {"['proj']", "['ln_scale']", "['ln_bias']"}
    assert all(float(g.abs().max()) > 0 for g in frontend.values())


def test_remat_policies_give_the_same_bits():
    cfg, _, tree, batch = _setup()
    runs = {remat: _grads(dataclasses.replace(cfg, remat=remat), tree, batch)
            for remat in ("none", "dots", "full")}
    m0, g0 = runs["none"]
    for remat in ("dots", "full"):
        m, g = runs[remat]
        assert torch.equal(m["loss"], m0["loss"]), remat
        for (path, a), (_, b) in zip(leaves_with_path(g), leaves_with_path(g0)):
            assert torch.equal(a, b), (remat, path)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "hubert-xlarge"])
def test_trainer_cli_smoke(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "done" in out.stdout
    first = float(out.stdout.split("first loss ")[1].split()[0])
    last = float(out.stdout.split("last loss ")[1].split()[0])
    assert math.isfinite(first) and math.isfinite(last)
