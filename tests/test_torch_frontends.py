"""The port's modality frontends (``repro_torch.models.frontends``) and
paligemma's image + text serving path against the JAX package's, on the
CPU.

Inputs come from numpy ``default_rng(seed)`` and the same arrays go to both
packages; parameters are the JAX package's init plus seeded noise.

Tolerances: embeddings within 1e-5 of the output's largest magnitude (a f32
product in another summation order: the rule of
``tests/test_torch_models.py``), the sinusoidal table within 1e-4 (XLA's
``exp`` of the frequencies differs from PyTorch's in the last bit, which a
position of 300 turns into an angle 3e-5 off); prefill logits within 1e-4
and decode logits within 1e-2 of the largest magnitude (that file's
rules); greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models.params import init_params as j_init_params
from repro.models.transformer import embed_inputs as j_embed_inputs
from repro.models.transformer import model_spec as j_model_spec
from repro.train.serve import make_decode_step as j_make_decode_step
from repro.train.serve import make_prefill_step as j_make_prefill_step
from repro_torch import configs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import frontends, layers
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import leaves_with_path, map_tree
from repro_torch.models.transformer import (Transformer, cache_struct,
                                            embed_inputs, model_spec)
from repro_torch.train.serve import make_decode_step, make_prefill_step

PALIGEMMA = "paligemma-3b"
HUBERT = "hubert-xlarge"


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _frontend_params(cfg, seed):
    tree = _noisy(j_init_params(jfrontends.frontend_spec(cfg),
                                jax.random.PRNGKey(0)), seed)
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


# -- the frontends ------------------------------------------------------------------
@pytest.mark.parametrize("name", [PALIGEMMA, HUBERT, "qwen2.5-3b"])
def test_frontend_spec_and_feature_dim_match_the_reference(name):
    for cfg in (configs.get(name), configs.get(name).reduced()):
        got, want = frontends.frontend_spec(cfg), jfrontends.frontend_spec(cfg)
        assert list(got) == list(want)
        for k in got:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
        assert frontends.feature_dim(cfg) == jfrontends.feature_dim(cfg)
    assert frontends.VISION_FEATURE_DIM == jfrontends.VISION_FEATURE_DIM
    assert frontends.AUDIO_FEATURE_DIM == jfrontends.AUDIO_FEATURE_DIM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_vision_matches_the_reference(dtype):
    cfg = dataclasses.replace(configs.get(PALIGEMMA).reduced(), dtype=dtype)
    pt, pj = _frontend_params(cfg, 1)
    patches = np.random.default_rng(2).standard_normal(
        (3, cfg.n_prefix_embed, frontends.VISION_FEATURE_DIM)
    ).astype(np.float32)
    got = frontends.embed_vision(pt, torch.from_numpy(patches), cfg)
    want = jfrontends.embed_vision(pj, jnp.asarray(patches), cfg)
    assert got.shape == want.shape == (3, cfg.n_prefix_embed, cfg.d_model)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    # bf16: one bf16 rounding of a f32 sum in another order
    _close(got.float(), want.astype(jnp.float32),
           1e-5 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("s", [1, 7, 50])
def test_embed_audio_matches_the_reference(s):
    cfg = configs.get(HUBERT).reduced()
    pt, pj = _frontend_params(cfg, 3)
    frames = np.random.default_rng(4).standard_normal(
        (2, s, frontends.AUDIO_FEATURE_DIM)).astype(np.float32)
    got = frontends.embed_audio(pt, torch.from_numpy(frames), cfg)
    want = jfrontends.embed_audio(pj, jnp.asarray(frames), cfg)
    assert got.shape == want.shape == (2, s, cfg.d_model)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("seq,d,offset", [(1, 8, 0), (50, 128, 0),
                                          (9, 1280, 300)])
def test_sinusoidal_positions_match_the_reference(seq, d, offset):
    _close(layers.sinusoidal_positions(seq, d, offset),
           jlayers.sinusoidal_positions(seq, d, offset), 1e-4)


# -- paligemma's stack ------------------------------------------------------------------
def _paligemma(n_layers=2):
    return dataclasses.replace(configs.get(PALIGEMMA).reduced(),
                               n_layers=n_layers)


def test_model_holds_the_frontend_and_round_trips_it():
    cfg = _paligemma()
    tree = _noisy(j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0)), 5)
    model = params_from_jax(cfg, tree, device="cpu")
    assert np.array_equal(model.frontend["proj"].numpy(),
                          tree["frontend"]["proj"])
    back = dict(leaves_with_path(params_to_numpy(model)))
    flat = dict(leaves_with_path(tree))
    assert list(back) == list(flat)
    assert all(np.array_equal(back[p], a) for p, a in flat.items())
    half = Transformer(dataclasses.replace(cfg, dtype="bfloat16"),
                       map_tree(torch.from_numpy, tree))
    assert half.frontend["proj"].dtype == torch.bfloat16


def test_embed_inputs_prepends_the_patches_as_the_reference():
    cfg = _paligemma()
    tree = _noisy(j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0)), 6)
    model = params_from_jax(cfg, tree, device="cpu")
    rng = np.random.default_rng(7)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, 5)),
              "patches": rng.standard_normal(
                  (2, cfg.n_prefix_embed, 1152)).astype(np.float32)}
    got = embed_inputs(model, {k: torch.from_numpy(v)
                               for k, v in inputs.items()})
    want = j_embed_inputs(jax.tree_util.tree_map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in inputs.items()}, cfg)
    assert got.shape == want.shape == (2, cfg.n_prefix_embed + 5, cfg.d_model)
    _close(got, want, 1e-5)
    # text alone: the tokens' embeddings, no prefix
    text = embed_inputs(model, {"tokens": torch.from_numpy(inputs["tokens"])})
    assert torch.equal(text, got[:, cfg.n_prefix_embed:])


def test_inputs_the_port_does_not_take_raise():
    cfg = _paligemma(1)
    model = Transformer(cfg, map_tree(
        lambda s: torch.zeros(s.shape), model_spec(cfg)))
    with pytest.raises(ValueError, match="no audio frontend"):
        embed_inputs(model, {"tokens": torch.zeros(1, 2, dtype=torch.long),
                             "frames": torch.zeros(1, 2, 512)})
    qwen = dataclasses.replace(configs.get("qwen2.5-3b").reduced(), n_layers=1)
    text_model = Transformer(qwen, map_tree(
        lambda s: torch.zeros(s.shape), model_spec(qwen)))
    with pytest.raises(ValueError, match="no vision frontend"):
        make_prefill_step(qwen, 16)(text_model, {
            "tokens": torch.zeros(1, 2, dtype=torch.long),
            "patches": torch.zeros(1, 8, 1152)})


def test_serving_steps_take_patches_as_the_reference():
    """paligemma served as ``tests/test_arch_smoke.py`` drives the JAX
    package: ``make_prefill_step`` on {tokens, patches}, then greedy
    ``make_decode_step(return_logits=False)`` from position P + S, the
    tokens of each step fed to the next."""
    cfg = _paligemma(3)
    tree = _noisy(j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0)), 8)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    rng = np.random.default_rng(9)
    s, max_len, steps = 12, 32, 6
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, s)).astype(np.int32),
              "patches": rng.standard_normal(
                  (2, cfg.n_prefix_embed, 1152)).astype(np.float32)}
    before = dict(LAUNCHES)
    jlogits, jcache = j_make_prefill_step(cfg, max_len)(
        jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    logits, cache = make_prefill_step(cfg, max_len)(
        model, {k: torch.from_numpy(v) for k, v in inputs.items()})
    _close(logits, jlogits, 1e-4)
    pos = cfg.n_prefix_embed + s
    assert cache["pos0"]["k"][:, :, :, pos - 1].any()
    assert not cache["pos0"]["k"][:, :, :, pos:].any()
    jstep = j_make_decode_step(cfg, return_logits=False)
    step = make_decode_step(cfg, return_logits=False)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    got, want = [tok], [jtok]
    for i in range(steps):
        jtok, jcache = jstep(jparams, jcache, jtok, pos + i)
        tok, cache = step(model, cache, tok, pos + i)
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.stack([np.asarray(w) for w in want], 1))
    assert LAUNCHES == before                  # the CPU runs no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_shapes_on_meta(dtype):
    """paligemma at its published widths and depth (18 layers, 8 heads over
    one kv head of 256) on ``meta`` tensors, no weights drawn: 256 patch
    rows and 64 tokens fill P + S = 320 cache rows, and a decode step
    follows."""
    cfg = dataclasses.replace(configs.get(PALIGEMMA), dtype=dtype)
    model = Transformer(cfg, map_tree(
        lambda sp: torch.empty(sp.shape, device="meta"), model_spec(cfg)))
    assert len(model.layers) == 18
    inputs = {"tokens": torch.zeros((4, 64), dtype=torch.long, device="meta"),
              "patches": torch.zeros((4, 256, 1152), device="meta")}
    logits, cache = make_prefill_step(cfg, 512)(model, inputs)
    assert logits.shape == (4, cfg.vocab_padded) and logits.device.type == "meta"
    want = cache_struct(cfg, 4, 512)["pos0"]
    for name in ("k", "v"):
        assert cache["pos0"][name].shape == want[name].shape == (18, 4, 1, 512,
                                                                 256)
        assert cache["pos0"][name].dtype == torch.bfloat16
    tok, cache = make_decode_step(cfg, return_logits=False)(
        model, cache, torch.zeros(4, dtype=torch.int32, device="meta"), 320)
    assert tok.shape == (4,) and tok.dtype == torch.int32
