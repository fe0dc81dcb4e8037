"""The MoE and MLA stacks of the port (moonshot-v1-16b-a3b: attention + MoE;
deepseek-v2-236b: a dense MLA first layer, then MLA + MoE with shared
experts) against the JAX package's, on the CPU; and ``init_params``'s
sliced draw of the leaves too large to draw whole.

The configs are ``reduced()`` (float32), deepseek's also with two MoE
groups (``n_layers=3``).  The JAX package initialises each model, every
leaf gets seeded numpy noise, and the same numpy tree goes to both
packages (to the port through ``params_from_jax``).

Tolerances, as ``tests/test_torch_models.py`` states them: prefill logits
within 1e-4 of the largest magnitude; decode logits, teacher-forced from
the JAX package's greedy tokens, within 1e-2 (the bf16 cache's rounding
feeds every later score); the bf16 caches within one bf16 ulp plus 1e-5 of
their largest magnitude after the prefill (1e-2 after decode steps);
greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.params import init_params as j_init_params
from repro.models.transformer import cache_axes as j_cache_axes
from repro.models.transformer import cache_struct as j_cache_struct
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import prefill as j_prefill
from repro.train.serve import greedy_generate as j_greedy_generate
from repro_torch import configs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import params as params_mod
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import (draw_rows, init_params,
                                       leaves_with_path)
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import (Transformer, cache_axes,
                                            cache_struct, decode_step,
                                            init_cache, model_spec, moe_group,
                                            prefill)
from repro_torch.train.serve import greedy_generate

ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")
PREFILL_RTOL = 1e-4
DECODE_RTOL = 1e-2
BF16_ULP = 2.0 ** -7

CASES = {
    "moonshot-v1-16b-a3b": lambda: configs.get(
        "moonshot-v1-16b-a3b").reduced(),
    "moonshot 2 groups": lambda: dataclasses.replace(
        configs.get("moonshot-v1-16b-a3b").reduced(), n_layers=2),
    "deepseek-v2-236b": lambda: configs.get("deepseek-v2-236b").reduced(),
    "deepseek 2 groups": lambda: dataclasses.replace(
        configs.get("deepseek-v2-236b").reduced(), n_layers=3),
}
PROMPT_LEN, MAX_LEN, STEPS = 24, 40, 4


def _numpy_tree(cfg, seed):
    tree = j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _within_bf16_ulp(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    tol = (BF16_ULP * np.maximum(np.abs(got), np.abs(want))
           + rtol * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()


def _caches_close(tcache, jcache, rtol):
    flat = dict(leaves_with_path(tcache))
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert list(flat) == sorted(jflat)
    for path, got in flat.items():
        assert got.dtype == torch.bfloat16, path
        _within_bf16_ulp(got.float().numpy(),
                         np.asarray(jflat[path], np.float32), rtol)


# -- specs, parameters, caches ------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_spec_matches_the_reference_spec(name, reduced):
    cfg = configs.get(name)
    if reduced:
        cfg = cfg.reduced()
    jspec = j_model_spec(cfg)
    jleaves = {jax.tree_util.keystr(p): s for p, s in
               jax.tree_util.tree_flatten_with_path(
                   jspec, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    leaves = dict(leaves_with_path(model_spec(cfg)))
    assert list(leaves) == list(jleaves)
    for path, s in leaves.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jleaves[path]), path


@pytest.mark.parametrize("case", ["moonshot 2 groups", "deepseek 2 groups"])
def test_params_from_jax_round_trips_layer0_and_the_experts(case):
    cfg = CASES[case]()
    tree = _numpy_tree(cfg, 0)
    model = params_from_jax(cfg, tree, device="cpu")
    back = params_to_numpy(model)
    flat, flat_back = dict(leaves_with_path(tree)), dict(leaves_with_path(back))
    assert list(flat) == list(flat_back)
    for path, a in flat.items():
        assert flat_back[path].dtype == np.float32
        assert np.array_equal(flat_back[path], a), path
    mlp = tree["blocks"]["pos0"]["mlp"]
    assert mlp["wi"].shape == (2, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    # scanned layer 1 holds group 1 of the stacked 4-D expert leaves
    assert np.array_equal(model.layers[1]["mlp"]["wi"].numpy(), mlp["wi"][1])
    if cfg.first_layer_dense:
        assert len(model.layers) == cfg.n_layers - 1
        assert np.array_equal(model.layer0["mlp"]["wi"].numpy(),
                              tree["layer0"]["mlp"]["wi"])
        assert np.array_equal(model.layers[0]["mlp"]["shared"]["wo"].numpy(),
                              mlp["shared"]["wo"][0])
    else:
        assert model.layer0 is None


def test_model_keeps_the_leaves_jax_reads_in_f32():
    """In bf16: matmul weights, the router and the experts in bf16; norms
    and MLA's q_norm, kv_norm, wk_b and wv_b (read in f32 by the JAX
    block) in f32; leaves of a tree already in bf16 are views of it."""
    cfg = dataclasses.replace(configs.get("deepseek-v2-236b").reduced(),
                              dtype="bfloat16")
    tree = init_params(model_spec(cfg), 0, dtype=torch.bfloat16, device="cpu")
    model = Transformer(cfg, tree)
    f32 = ("norm", "wk_b", "wv_b")
    for name, p in model.named_parameters():
        want = torch.float32 if any(k in name for k in f32) else torch.bfloat16
        assert p.dtype == want, name
    wi = tree["blocks"]["pos0"]["mlp"]["wi"]
    assert model.layers[0]["mlp"]["wi"].data_ptr() == wi.data_ptr()


@pytest.mark.parametrize("name", ARCHS)
def test_cache_layout_matches_the_reference(name):
    cfg = configs.get(name).reduced()
    got = dict(leaves_with_path(cache_struct(cfg, 2, 16)))
    want = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(j_cache_struct(cfg, 2, 16))[0]}
    assert list(got) == sorted(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).replace("torch.", "") == str(want[path].dtype)
    assert cache_axes(cfg) == j_cache_axes(cfg)
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert all(not t.any() for _, t in leaves_with_path(cache))


# -- the serving path -----------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_and_greedy_match_the_reference(case):
    cfg = CASES[case]()
    tree = _numpy_tree(cfg, 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    prompt = np.random.default_rng(6).integers(
        0, cfg.vocab, (2, PROMPT_LEN)).astype(np.int32)
    before = dict(LAUNCHES)

    jlogits, jcache = j_prefill(jparams, {"tokens": jnp.asarray(prompt)}, cfg,
                                MAX_LEN)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompt)},
                            MAX_LEN)
    assert logits.shape == (2, cfg.vocab_padded)
    _close(logits.numpy(), jlogits, PREFILL_RTOL)
    _caches_close(cache, jcache, 1e-5)

    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for i in range(STEPS):
        jlogits, jcache = j_decode_step(jparams, jcache, jnp.asarray(tok),
                                        PROMPT_LEN + i, cfg)
        logits, cache = decode_step(model, cache, torch.from_numpy(tok),
                                    PROMPT_LEN + i)
        _close(logits.numpy(), jlogits, DECODE_RTOL)
        _caches_close(cache, jcache, DECODE_RTOL)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)

    want = np.asarray(j_greedy_generate(jparams, cfg, jnp.asarray(prompt),
                                        STEPS + 1, MAX_LEN))
    got = greedy_generate(model, prompt, STEPS + 1, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert LAUNCHES == before                  # the CPU runs no kernel


def test_decode_step_routes_one_group_per_slot_when_asked():
    """The engine's step passes ``moe_group_size=1``: each row's token is a
    routing group of its own, so each row gets the routing of that row
    stepped alone (what the JAX engine's per-slot vmap computes).  Below 32
    sequences the JAX stack's own rule gives the same groups, so the same
    bits.  With a zero router every token ties on every expert and picks
    experts 0 and 1 (the lower index first); at 144 rows the rule's groups
    of 9 tokens overflow those experts' capacity of 8, so the rule drops
    the assignments of every ninth row that groups of one keep.  Logits of
    a row in the batch and alone are held within 1e-5 of max |logit| (the
    CPU's products may sum otherwise at another row count); a dropped row's
    differ by far more."""
    cfg = CASES["deepseek 2 groups"]()
    tree = _numpy_tree(cfg, 9)
    tree["blocks"]["pos0"]["mlp"]["router"][...] = 0.0
    model = params_from_jax(cfg, tree, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (144, 8)))
    tokens = torch.arange(144) % cfg.vocab

    def step(rows, group_size):
        _, cache = prefill(model, {"tokens": prompts[rows]}, 16)
        return decode_step(model, cache, tokens[rows], 8,
                           moe_group_size=group_size)[0]

    few = slice(0, 3)
    assert torch.equal(step(few, None), step(few, 1))
    assert moe_group("decode", 144, 1) == 9 and capacity(cfg, 9) == 8
    every = slice(0, 144)
    rule, ours = step(every, None), step(every, 1)
    for row in (0, 8, 143):           # row 8: dropped in the rule's group 0
        alone = step(slice(row, row + 1), 1)[0]
        tol = 1e-5 * float(alone.abs().max())
        assert float((ours[row] - alone).abs().max()) <= tol
        gap = float((rule[row] - alone).abs().max())
        assert gap > 1e3 * tol if row % 9 == 8 else gap <= tol


# -- init_params: leaves too large to draw whole ----------------------------------
def test_the_served_models_draw_every_leaf_whole_but_the_experts():
    """qwen2.5-3b's and rwkv6-3b's leaves (at most 811.6 M elements) are
    drawn whole, so their weights are the ones earlier runs served;
    moonshot's stacked experts (8.86 G elements each) are drawn in 48
    slices, deepseek's 4-layer cut's in 3 x 160."""
    for name in ("qwen2.5-3b", "rwkv6-3b"):
        spec = model_spec(configs.get(name))
        assert all(draw_rows(s.shape) == 1 for _, s in leaves_with_path(spec))
    moon = model_spec(configs.get("moonshot-v1-16b-a3b"))
    sliced = {p: draw_rows(s.shape) for p, s in leaves_with_path(moon)
              if draw_rows(s.shape) > 1}
    assert sliced == {f"['blocks']['pos0']['mlp']['{w}']": 48
                      for w in ("wg", "wi", "wo")}
    deep = model_spec(dataclasses.replace(configs.get("deepseek-v2-236b"),
                                          n_layers=4))
    assert {draw_rows(s.shape) for _, s in leaves_with_path(deep)} == {1, 480}
    assert draw_rows((3, 5)) == 1 and draw_rows(()) == 1


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """With the slice size lowered, a leaf below it keeps the values of the
    whole draw, and a leaf above it has its shape and dtype, repeats for a
    seed, and has the spec's scale (on the CPU its slices continue one
    generator stream, so they happen to give the whole draw's values; the
    card's generator does not promise that)."""
    cfg = configs.get("moonshot-v1-16b-a3b").reduced()
    spec = model_spec(cfg)
    whole = init_params(spec, 3, device="cpu")
    monkeypatch.setattr(params_mod, "DRAW_SLICE", 40_000)
    sliced = init_params(spec, 3, device="cpu")
    again = init_params(spec, 3, dtype=torch.bfloat16, device="cpu")
    flat_w, flat_s = dict(leaves_with_path(whole)), dict(leaves_with_path(sliced))
    flat_b = dict(leaves_with_path(again))
    n_sliced = 0
    for path, s in leaves_with_path(spec):
        got = flat_s[path]
        assert tuple(got.shape) == s.shape and got.dtype == torch.float32
        assert flat_b[path].dtype == torch.bfloat16
        assert torch.equal(flat_b[path], got.to(torch.bfloat16)), path
        if got.numel() <= 40_000:
            assert torch.equal(got, flat_w[path]), path
        else:
            n_sliced += 1
            assert abs(float(got.std()) / s.scale - 1) < 0.05, path
            assert abs(float(got.mean())) < 0.05 * s.scale, path
            # each slice is its own draw: no two leading rows repeat
            rows = got.reshape(draw_rows(s.shape), -1)
            assert not torch.equal(rows[0], rows[1])
    assert n_sliced >= 3
