"""The port's LM serving path against the JAX package's, on the CPU.

The JAX package initialises each model (``init_params(model_spec(cfg),
PRNGKey(0))``); every leaf then gets seeded numpy noise (so biases and norm
scales are nonzero and not 1) and the same numpy tree goes to both
packages: to JAX as arrays, to the port through ``params_from_jax``.  The
configs are ``reduced()`` (float32) with 3 layers, and a "qwen geometry"
config with qwen2.5-3b's heads (16 over 2 kv heads of 128, d_model 2048) at
a narrow MLP and vocabulary.

Tolerances, measured on these inputs and stated with a margin:

* layers, prefill logits and the prefill cache: the same f32 arithmetic in
  another summation order, 1e-4 of the output's largest magnitude for
  logits and for a recurrent state (jamba's mamba layers, f32); the bf16
  cache to within one bf16 ulp (a f32 key that differs in
  its last bits can round to the neighbouring bf16 value) plus 1e-5 of the
  cache's largest magnitude (a small key is a sum of larger terms);
* decode logits and the rows decode writes into the cache, teacher-forced
  from the JAX package's greedy tokens: 1e-2 of the largest magnitude
  (measured up to 3.8e-3 on the qwen geometry), because the bf16 cache
  rounding above feeds every later score;
* greedy tokens: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.params import init_params as j_init_params
from repro.models.transformer import cache_axes as j_cache_axes
from repro.models.transformer import cache_struct as j_cache_struct
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import prefill as j_prefill
from repro.train.serve import greedy_generate as j_greedy_generate
from repro_torch import configs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import attention, layers, rwkv
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import (init_params, leaves_with_path,
                                       map_tree, param_bytes)
from repro_torch.models.transformer import (Transformer, cache_axes,
                                            cache_struct, decode_step,
                                            init_cache, model_spec, prefill,
                                            train_loss)
from repro_torch.train.serve import (greedy_generate, make_decode_step,
                                     make_prefill_step)

ARCHS = ("qwen2.5-3b", "stablelm-1.6b", "minicpm-2b")
PREFILL_RTOL = 1e-4
DECODE_RTOL = 1e-2
BF16_ULP = 2.0 ** -7


def _reduced(name, **changes):
    return dataclasses.replace(configs.get(name).reduced(), **changes)


def _qwen_geometry():
    return dataclasses.replace(configs.get("qwen2.5-3b"), n_layers=2, d_ff=256,
                               vocab=512, dtype="float32")


def _numpy_tree(cfg, seed):
    """The JAX package's init, plus seeded noise on every leaf."""
    tree = j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _within_bf16_ulp(got, want, rtol=1e-5):
    """One bf16 ulp of each value, plus the error of the sum that made it
    (``rtol`` of the tensor's scale: a small key is a sum of larger terms)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    tol = (BF16_ULP * np.maximum(np.abs(got), np.abs(want))
           + rtol * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()


def _caches_close(tcache, jcache, rtol=1e-5):
    """A KV cache (bf16) within one bf16 ulp plus ``rtol``; a recurrent
    state (mamba's conv window and ssm state) in the JAX state's dtypes,
    within ``max(rtol, PREFILL_RTOL)`` of its largest magnitude (the
    logits' rule: a layer's state carries every earlier layer's sums)."""
    for pos in jcache:
        if not isinstance(jcache[pos], dict):
            for got, want in zip(tcache[pos], jcache[pos]):
                assert str(got.dtype).replace("torch.", "") == str(want.dtype)
                _close(got.float().numpy(), np.asarray(want, np.float32),
                       max(rtol, PREFILL_RTOL))
            continue
        for name in ("k", "v"):
            got = tcache[pos][name]
            assert got.dtype == torch.bfloat16
            _within_bf16_ulp(got.float().numpy(),
                             jcache[pos][name].astype(jnp.float32), rtol)


# -- configs ------------------------------------------------------------------
def test_configs_are_the_reference_configs():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        jcfg = jconfigs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.vocab_padded == jcfg.vocab_padded
        assert cfg.param_count() == jcfg.param_count()
    assert configs.cells(True) == jconfigs.cells(True)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    # qwen2.5-3b at full width: 3.086 G parameters
    assert configs.get("qwen2.5-3b").param_count() == 3_085_697_024
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b"])
def test_unported_archs_raise_naming_the_roadmap(name):
    """jamba's stack is built (it serves), but its training, a
    ``mamba_scan`` backward kernel, is not ported: ROADMAP.md queue 1 step
    7c."""
    cfg = configs.get(name).reduced()
    assert "mamba" in cfg.block_pattern and "blocks" in model_spec(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*step 7c"):
        train_loss({}, {}, cfg)


# -- params -------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS + ("mistral-large-123b", "rwkv6-3b",
                                          "jamba-1.5-large-398b",
                                          "paligemma-3b"))
def test_spec_matches_the_reference_spec(name):
    cfg = configs.get(name).reduced()
    jspec = j_model_spec(cfg)
    jleaves = {jax.tree_util.keystr(p): s for p, s in
               jax.tree_util.tree_flatten_with_path(
                   jspec, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    leaves = dict(leaves_with_path(model_spec(cfg)))
    assert list(leaves) == list(jleaves)
    for path, s in leaves.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jleaves[path]), path
    from repro.models.params import param_bytes as j_param_bytes
    assert param_bytes(model_spec(cfg)) == j_param_bytes(jspec)


def test_params_from_jax_consumes_every_leaf_and_round_trips():
    cfg = _reduced("qwen2.5-3b", n_layers=3)
    tree = _numpy_tree(cfg, 0)
    model = params_from_jax(cfg, tree, device="cpu")
    assert len(model.layers) == 3
    back = params_to_numpy(model)
    flat = dict(leaves_with_path(tree))
    flat_back = dict(leaves_with_path(back))
    assert list(flat) == list(flat_back)
    for path, a in flat.items():
        assert flat_back[path].dtype == np.float32
        assert np.array_equal(flat_back[path], a), path
    # layer 1 holds group 1 of the stacked leaves
    assert np.array_equal(model.layers[1]["block"]["bk"].numpy(),
                          tree["blocks"]["pos0"]["block"]["bk"][1])


def test_params_from_jax_raises_on_leaves_it_does_not_take():
    cfg = _reduced("qwen2.5-3b")
    tree = _numpy_tree(cfg, 0)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["blocks"]["pos0"]["block"]["rogue"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not consumed.*rogue"):
        params_from_jax(cfg, extra, device="cpu")
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["final_norm"]["scale"]
    with pytest.raises(ValueError, match="missing.*final_norm"):
        params_from_jax(cfg, missing, device="cpu")
    wrong = jax.tree_util.tree_map(lambda a: a, tree)
    wrong["blocks"]["pos0"]["mlp"]["wi"] = wrong["blocks"]["pos0"]["mlp"]["wi"][:, :, :7]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg, wrong, device="cpu")


def test_init_params_is_seeded_and_follows_the_spec():
    cfg = _reduced("stablelm-1.6b")
    spec = model_spec(cfg)
    a = init_params(spec, 7, device="cpu")
    b = init_params(spec, 7, device="cpu")
    c = init_params(spec, 8, device="cpu")
    la, lb, lc = (dict(leaves_with_path(t)) for t in (a, b, c))
    for path, s in leaves_with_path(spec):
        assert tuple(la[path].shape) == s.shape and la[path].dtype == torch.float32
        assert torch.equal(la[path], lb[path])
        if s.init == "normal":
            assert not torch.equal(la[path], lc[path])
            assert abs(float(la[path].std()) / s.scale - 1) < 0.2, path
        elif s.init == "ones":
            assert bool((la[path] == 1).all())
        else:
            assert bool((la[path] == 0).all())
    half = init_params(spec, 7, dtype=torch.bfloat16, device="cpu")
    for path, t in leaves_with_path(half):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, la[path].to(torch.bfloat16))


def test_init_params_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is usable")
    spec = model_spec(_reduced("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(spec, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(_reduced("qwen2.5-3b"), _numpy_tree(_reduced("qwen2.5-3b"), 0))
    assert init_params(spec, 0, device="cpu")["embed"]["embedding"].device.type == "cpu"


def test_init_cache_defaults_to_the_card():
    """init_cache, like init_params and params_from_jax, puts the cache on
    the card unless the caller asks for the CPU."""
    cfg = _reduced("qwen2.5-3b")
    if torch.cuda.is_available():
        assert init_cache(cfg, 1, 8)["pos0"]["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(configs.get("rwkv6-3b").reduced(), 1, 8)
    assert init_cache(cfg, 1, 8, device="cpu")["pos0"]["k"].device.type == "cpu"
    assert init_cache(cfg, 1, 8, device="meta")["pos0"]["k"].device.type == "meta"


def test_model_keeps_weights_in_the_compute_dtype_and_norms_in_f32():
    cfg = _reduced("stablelm-1.6b", dtype="bfloat16")
    model = Transformer(cfg, init_params(model_spec(cfg), 0, device="cpu"))
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
        assert not p.requires_grad


# -- layers -------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_layers_match_the_reference(name):
    cfg = _reduced(name, vocab=500, logit_scale_base=(
        64 if name == "minicpm-2b" else 0))
    tree = _numpy_tree(cfg, 1)
    model = params_from_jax(cfg, tree, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    blk = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["pos0"])
    lay = model.layers[0]
    # norms (RMS for qwen and minicpm, Layer for stablelm)
    _close(layers.apply_norm(lay["norm1"], xt, cfg),
           jlayers.apply_norm(blk["norm1"], xj, cfg), 1e-6)
    # gated MLP
    _close(layers.apply_mlp(lay["mlp"], xt, cfg),
           jlayers.apply_mlp(blk["mlp"], xj, cfg), 1e-6)
    # rotary: full (qwen, minicpm) or 25 % (stablelm) of each head
    hx = rng.standard_normal((2, cfg.n_heads, 12, cfg.head_dim)).astype(np.float32)
    pos = np.arange(5, 17)
    _close(layers.apply_rotary(torch.from_numpy(hx), torch.from_numpy(pos),
                               cfg.rope_theta, cfg.rotary_pct),
           jlayers.apply_rotary(jnp.asarray(hx), jnp.asarray(pos),
                                cfg.rope_theta, cfg.rotary_pct), 1e-6)
    np.testing.assert_array_equal(
        layers.rope_frequencies(32, cfg.rope_theta).numpy(),
        np.asarray(jlayers.rope_frequencies(32, cfg.rope_theta)))
    # embedding (minicpm: scale_emb 12) and logits (pad mask past vocab 500;
    # minicpm: logit_scale_base)
    toks = rng.integers(0, cfg.vocab, (2, 12))
    _close(layers.embed_tokens(model.embed, torch.from_numpy(toks), cfg),
           jlayers.embed_tokens(tree["embed"], jnp.asarray(toks), cfg), 0)
    got = layers.logits_from_hidden(model.embed, xt, cfg).numpy()
    want = np.asarray(jlayers.logits_from_hidden(tree["embed"], xj, cfg))
    assert (got[..., cfg.vocab:] == -1e30).all()
    _close(got[..., :cfg.vocab], want[..., :cfg.vocab], 1e-6)
    assert layers.residual_scale(cfg) == jlayers.residual_scale(cfg)
    # the attention block over the whole sequence
    _close(attention.attend_full(lay["block"], xt, cfg),
           jattn.attend_full(blk["block"], xj, cfg), 1e-5)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "rwkv6-3b"])
def test_out_of_range_token_ids_follow_the_jax_gather(name):
    """A negative id wraps once (id + V), then ids clamp to [0, V - 1], V the
    embedding's rows (vocab_padded), as the JAX gather does."""
    cfg = _reduced(name, n_layers=1)
    tree = _numpy_tree(cfg, 12)
    model = params_from_jax(cfg, tree, device="cpu")
    v = cfg.vocab_padded
    toks = np.array([[-1, v, v + 7, 0, -v, -v - 3, 5]], dtype=np.int32)
    jemb = jax.tree_util.tree_map(jnp.asarray, tree["embed"])
    got = layers.embed_tokens(model.embed, torch.from_numpy(toks), cfg)
    want = jlayers.embed_tokens(jemb, jnp.asarray(toks), cfg)
    _close(got, want, 0)
    table = tree["embed"]["embedding"]
    np.testing.assert_array_equal(
        got[0, :3].numpy(), table[[v - 1, v - 1, v - 1]])
    # the hidden state at the end of the stack, through both packages
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jlogits, _ = j_prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, 16)
    logits, _ = prefill(model, {"tokens": torch.from_numpy(toks)}, 16)
    _close(logits.numpy(), jlogits, PREFILL_RTOL)


def test_gelu_and_ungated_mlp_match_the_reference():
    cfg = _reduced("stablelm-1.6b", act="gelu")
    tree = _numpy_tree(cfg, 3)
    model = params_from_jax(cfg, tree, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    blk = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["pos0"])
    _close(layers.apply_mlp(model.layers[0]["mlp"], torch.from_numpy(x), cfg),
           jlayers.apply_mlp(blk["mlp"], jnp.asarray(x), cfg), 1e-6)
    ungated = dataclasses.replace(cfg, gated_mlp=False)
    p = {k: torch.from_numpy(v) for k, v in blk["mlp"].items() if k != "wg"}
    _close(layers.apply_mlp(p, torch.from_numpy(x), ungated),
           jlayers.apply_mlp({k: jnp.asarray(v) for k, v in blk["mlp"].items()
                              if k != "wg"}, jnp.asarray(x), ungated), 1e-6)


# -- the serving path ---------------------------------------------------------
SERVE_CASES = {
    "qwen2.5-3b": lambda: _reduced("qwen2.5-3b", n_layers=3),
    "stablelm-1.6b": lambda: _reduced("stablelm-1.6b", n_layers=3),
    "minicpm-2b": lambda: _reduced("minicpm-2b", n_layers=3),
    "qwen-geometry": _qwen_geometry,
    # mamba and attention layers, dense and MoE MLPs: all 8 positions of the
    # period (mamba x3, attn, mamba x4)
    "jamba-1.5-large-398b": lambda: configs.get(
        "jamba-1.5-large-398b").reduced(),
    # the vision frontend: 8 patch rows prepended to the prompt
    "paligemma-3b": lambda: _reduced("paligemma-3b", n_layers=3),
}
PROMPT_LEN, MAX_LEN, STEPS = 24, 40, 4


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_prefill_decode_and_greedy_match_the_reference(case):
    cfg = SERVE_CASES[case]()
    tree = _numpy_tree(cfg, 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab, (2, PROMPT_LEN)).astype(np.int32)
    inputs = {"tokens": prompt}
    prefix = 0
    if cfg.frontend == "vision":
        prefix = cfg.n_prefix_embed
        inputs["patches"] = rng.standard_normal(
            (2, prefix, 1152)).astype(np.float32)
    before = dict(LAUNCHES)

    jlogits, jcache = j_prefill(
        jparams, {k: jnp.asarray(v) for k, v in inputs.items()}, cfg, MAX_LEN)
    logits, cache = prefill(
        model, {k: torch.from_numpy(v) for k, v in inputs.items()}, MAX_LEN)
    assert logits.shape == (2, cfg.vocab_padded) and logits.dtype == torch.float32
    _close(logits.numpy(), jlogits, PREFILL_RTOL)
    _caches_close(cache, jcache)
    filled = prefix + PROMPT_LEN
    for c in cache.values():
        if isinstance(c, dict):
            assert c["k"][:, :, :, filled - 1].any()
            assert not c["k"][:, :, :, filled:].any()

    # decode, teacher-forced from the reference's greedy tokens
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for i in range(STEPS):
        jlogits, jcache = j_decode_step(jparams, jcache, jnp.asarray(tok),
                                        filled + i, cfg)
        logits, cache = decode_step(model, cache, torch.from_numpy(tok),
                                    filled + i)
        _close(logits.numpy(), jlogits, DECODE_RTOL)
        _caches_close(cache, jcache, DECODE_RTOL)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)

    want = np.asarray(j_greedy_generate(jparams, cfg, jnp.asarray(prompt),
                                        STEPS + 1, MAX_LEN))
    got = greedy_generate(model, prompt, STEPS + 1, MAX_LEN)
    assert got.dtype == torch.int32 and got.shape == (2, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert LAUNCHES == before                  # the CPU runs no kernel


def test_steps_and_their_fast_path():
    cfg = _reduced("qwen2.5-3b")
    model = params_from_jax(cfg, _numpy_tree(cfg, 7), device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (3, 10)))
    logits, cache = make_prefill_step(cfg, 16)(model, {"tokens": prompt})
    tok = torch.argmax(logits, -1).to(torch.int32)
    fast = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    nxt, lg, cache = make_decode_step(cfg)(model, cache, tok, 10)
    nxt_fast, fast = make_decode_step(cfg, return_logits=False)(model, fast, tok, 10)
    assert nxt.dtype == torch.int32 and torch.equal(nxt, nxt_fast)
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    assert torch.equal(cache["pos0"]["k"], fast["pos0"]["k"])
    other = params_from_jax(_reduced("minicpm-2b"), _numpy_tree(
        _reduced("minicpm-2b"), 0), device="cpu")
    with pytest.raises(ValueError, match="made for"):
        make_decode_step(cfg)(other, cache, tok, 11)
    # an encoder's prefill step is its encode (tests/test_torch_train.py
    # holds it against the JAX package's)
    hubert = configs.get("hubert-xlarge").reduced()
    encode = make_prefill_step(hubert, 16)
    frames = torch.zeros(1, 5, 512)
    logits = encode(Transformer(hubert, map_tree(
        lambda s: torch.zeros(s.shape), model_spec(hubert))), {"frames": frames})
    assert logits.shape == (1, 5, hubert.vocab_padded)


def test_decode_clamps_the_cache_write_at_max_len():
    """pos == max_len writes the last cache row, as
    jax.lax.dynamic_update_slice clamps the start index."""
    cfg = _reduced("qwen2.5-3b")
    tree = _numpy_tree(cfg, 9)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    max_len = 8
    jlogits, jcache = j_prefill(jparams, {"tokens": jnp.asarray(prompt)}, cfg, max_len)
    _, cache = prefill(model, {"tokens": torch.from_numpy(prompt)}, max_len)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jl, jcache = j_decode_step(jparams, jcache, jnp.asarray(tok), max_len, cfg)
    kept = cache["pos0"]["k"][:, :, :, :max_len - 1].clone()
    logits, cache = decode_step(model, cache, torch.from_numpy(tok), max_len)
    _close(logits.numpy(), jl, DECODE_RTOL)
    _caches_close(cache, jcache, DECODE_RTOL)
    assert torch.equal(cache["pos0"]["k"][:, :, :, :max_len - 1], kept)


def test_cache_struct_and_axes_match_the_reference():
    cfg = _reduced("qwen2.5-3b", n_layers=3)
    got = cache_struct(cfg, 4, 64)
    want = j_cache_struct(cfg, 4, 64)
    for name in ("k", "v"):
        t = got["pos0"][name]
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == want["pos0"][name].shape
    assert cache_axes(cfg) == j_cache_axes(cfg)
    zero = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert zero["pos0"]["k"].shape == (3, 2, 2, 16, 32)
    assert not zero["pos0"]["v"].any()
    jk = attention.cache_from_prefill(cfg, torch.ones(2, 2, 5, 32),
                                      torch.ones(2, 2, 5, 32), 16)
    want_k = jattn.cache_from_prefill(cfg, jnp.ones((2, 2, 5, 32)),
                                      jnp.ones((2, 2, 5, 32)), 16)["k"]
    np.testing.assert_array_equal(jk["k"].float().numpy(),
                                  np.asarray(want_k.astype(jnp.float32)))


def test_init_kv_cache_and_init_rwkv_state_default_to_the_card():
    """init_kv_cache and init_rwkv_state follow init_cache: the card unless
    the caller asks for the CPU (or ``meta`` for shapes alone)."""
    qwen, rwkv_cfg = _reduced("qwen2.5-3b"), configs.get("rwkv6-3b").reduced()
    if torch.cuda.is_available():
        assert attention.init_kv_cache(qwen, 1, 8)["k"].device.type == "cuda"
        assert all(t.device.type == "cuda"
                   for t in rwkv.init_rwkv_state(rwkv_cfg, 1))
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        attention.init_kv_cache(qwen, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rwkv.init_rwkv_state(rwkv_cfg, 1)
    for dev in ("cpu", "meta"):
        cache = attention.init_kv_cache(qwen, 1, 8, device=dev)
        assert {t.device.type for t in cache.values()} == {dev}
        state = rwkv.init_rwkv_state(rwkv_cfg, 1, device=dev)
        assert {t.device.type for t in state} == {dev}
    assert attention.kv_cache_struct(qwen, 1, 8)["k"].device.type == "meta"
