"""The port's Mamba block (``repro_torch.models.mamba``) and jamba's hybrid
stack against the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: ``mamba_scan`` takes its
XLA body (the chunked associative scan) off the TPU, which the port's
plain version mirrors; the decode step is the plain one-step recurrence in
both packages.  Inputs come from numpy ``default_rng(seed)`` and the same
arrays go to both packages; parameters are the JAX package's init plus
seeded noise (so ``a_log``, ``dt_bias`` and the conv bias are not their
constants).

Tolerances: the block's outputs, its ssm state and the conv window within
1e-5 of the output's largest magnitude (f32 in another summation order:
the rule of ``tests/test_torch_models.py``); the conv window's dtype and
shape exactly; softplus and the causal conv, elementwise, within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models.params import init_params as j_init_params
from repro.models.transformer import cache_axes as j_cache_axes
from repro.models.transformer import cache_struct as j_cache_struct
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import prefill as j_prefill
from repro.serve import DecodeEngine as JDecodeEngine
from repro_torch import configs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import mamba
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import init_params, leaves_with_path, map_tree
from repro_torch.models.transformer import (Transformer, cache_axes,
                                            cache_struct, decode_step,
                                            init_cache, model_spec, prefill)
from repro_torch.serve import DecodeEngine

JAMBA = "jamba-1.5-large-398b"
RTOL = 1e-5


def _cfg(**changes):
    return dataclasses.replace(configs.get(JAMBA).reduced(), **changes)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _block_params(cfg, seed):
    """One mamba block's parameters: the JAX init plus seeded noise, as
    numpy (the same arrays go to both packages)."""
    spec = jmamba.mamba_spec(cfg)
    tree = j_init_params(spec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)
                ).astype(np.float32) for k, v in tree.items()}


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _flat(tree, prefix=""):
    """{path: leaf} of a cache, paths as ``jax.tree_util.keystr`` writes
    them (dicts by sorted key, tuples by index)."""
    if isinstance(tree, dict):
        return {p: t for k in sorted(tree)
                for p, t in _flat(tree[k], f"{prefix}[{k!r}]").items()}
    if isinstance(tree, tuple):
        return {p: t for i, sub in enumerate(tree)
                for p, t in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _numpy_tree(cfg, seed):
    tree = j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


# -- the block --------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
def test_mamba_spec_matches_the_reference(reduced):
    cfg = configs.get(JAMBA)
    if reduced:
        cfg = cfg.reduced()
    for stacked in (0, 3):
        got = mamba.mamba_spec(cfg, stacked)
        want = jmamba.mamba_spec(cfg, stacked)
        assert list(got) == list(want)
        for k in got:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k
    if not reduced:                  # jamba's published widths
        spec = mamba.mamba_spec(cfg)
        assert spec["in_proj"].shape == (8192, 2 * 16384)
        assert spec["x_proj"].shape == (16384, 512 + 2 * 16)
        assert spec["a_log"].shape == (16384, 16)


def test_softplus_and_conv_match_the_reference():
    x = np.linspace(-40.0, 40.0, 801).astype(np.float32)
    _close(mamba.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), 1e-6)
    # above 20, F.softplus returns x itself; logaddexp(x, 0) does not
    big = np.float32(15.3)
    assert float(mamba.softplus(torch.tensor(big))) == float(
        jax.nn.softplus(jnp.float32(big)))
    rng = np.random.default_rng(0)
    for s in (1, 2, 3, 9):
        xs = rng.standard_normal((2, s, 24)).astype(np.float32)
        w = rng.standard_normal((4, 24)).astype(np.float32)
        b = rng.standard_normal(24).astype(np.float32)
        _close(mamba._conv1d_causal(*map(torch.from_numpy, (xs, w, b))),
               jmamba._conv1d_causal(*map(jnp.asarray, (xs, w, b))), 1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 12, 70])
def test_mamba_full_matches_the_reference(s):
    """Output, conv window and ssm state of the prefill, from sequences
    shorter than the window (the window zero-padded in front) to one past
    the plain scan's chunk of 64."""
    cfg = _cfg()
    pt, pj = _both(_block_params(cfg, 1))
    x = np.random.default_rng(2).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    out, (conv, ssm) = mamba.mamba_full(pt, torch.from_numpy(x), cfg,
                                        return_state=True)
    jout, (jconv, jssm) = jmamba.mamba_full(pj, jnp.asarray(x), cfg,
                                            return_state=True)
    _close(out, jout)
    assert conv.shape == jconv.shape == (2, cfg.mamba_d_conv - 1,
                                         cfg.mamba_d_inner)
    assert str(conv.dtype).replace("torch.", "") == str(jconv.dtype)
    assert ssm.dtype == torch.float32 and ssm.shape == jssm.shape
    _close(conv, jconv)
    _close(ssm, jssm)
    if s < cfg.mamba_d_conv - 1:
        assert not conv[:, :cfg.mamba_d_conv - 1 - s].any()
    _close(mamba.mamba_full(pt, torch.from_numpy(x), cfg), jout)


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_the_reference(conv_dtype):
    """Four steps from a random state; a bf16 conv window under the f32
    compute dtype comes back in f32 (JAX's promoted concatenate), in both
    packages."""
    cfg = _cfg()
    pt, pj = _both(_block_params(cfg, 3))
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((3, cfg.mamba_d_conv - 1,
                                cfg.mamba_d_inner)).astype(np.float32)
    ssm = rng.standard_normal((3, cfg.mamba_d_inner,
                               cfg.mamba_d_state)).astype(np.float32)
    state = (torch.from_numpy(conv).to(getattr(torch, conv_dtype)),
             torch.from_numpy(ssm))
    jstate = (jnp.asarray(conv).astype(conv_dtype), jnp.asarray(ssm))
    for _ in range(4):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        out, state = mamba.mamba_decode(pt, torch.from_numpy(x), state, cfg)
        jout, jstate = jmamba.mamba_decode(pj, jnp.asarray(x), jstate, cfg)
        _close(out, jout)
        for got, want in zip(state, jstate):
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            assert got.shape == want.shape
            _close(got, want)
    assert state[0].dtype == torch.float32


def test_decode_continues_the_prefill():
    """A prefill of S tokens then one decode step gives the prefill of S + 1
    tokens' last output and state (the scan and the step are one
    recurrence)."""
    cfg = _cfg()
    pt, _ = _both(_block_params(cfg, 5))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    _, st = mamba.mamba_full(pt, x[:, :8], cfg, return_state=True)
    out, (conv, ssm) = mamba.mamba_decode(pt, x[:, 8:], st, cfg)
    full, (conv9, ssm9) = mamba.mamba_full(pt, x, cfg, return_state=True)
    _close(out, full[:, 8:])
    _close(conv, conv9)
    _close(ssm, ssm9)


def test_state_init_defaults_to_the_card():
    cfg = _cfg()
    conv, ssm = mamba.init_mamba_state(cfg, 2, torch.bfloat16, device="cpu")
    assert conv.shape == (2, 3, cfg.mamba_d_inner) and conv.dtype == torch.bfloat16
    assert ssm.shape == (2, cfg.mamba_d_inner, 16) and ssm.dtype == torch.float32
    assert not conv.any() and not ssm.any()
    meta = mamba.mamba_state_struct(cfg, 2)
    assert all(t.device.type == "meta" for t in meta)
    want = jmamba.mamba_state_struct(cfg, 2)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in meta] \
        == [(s.shape, str(s.dtype)) for s in want]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mamba.init_mamba_state(cfg, 2)


# -- the stack --------------------------------------------------------------------
def test_model_keeps_the_leaves_jax_reads_in_f32():
    """In bf16: the projections and the conv in bf16; norms, a_log,
    dt_bias and d_skip (read in f32 by the JAX block) in f32."""
    cfg = _cfg(dtype="bfloat16")
    model = Transformer(cfg, init_params(model_spec(cfg), 0, device="cpu"))
    f32 = ("norm", "a_log", "dt_bias", "d_skip")
    for name, p in model.named_parameters():
        want = torch.float32 if any(k in name for k in f32) else torch.bfloat16
        assert p.dtype == want, name


def test_params_from_jax_round_trips_every_position():
    cfg = _cfg(n_layers=16)                     # two groups of the period
    tree = _numpy_tree(cfg, 0)
    model = params_from_jax(cfg, tree, device="cpu")
    assert len(model.layers) == 16
    back = params_to_numpy(model)
    flat, flat_back = dict(leaves_with_path(tree)), dict(leaves_with_path(back))
    assert list(flat) == list(flat_back)
    for path, a in flat.items():
        assert np.array_equal(flat_back[path], a), path
    # layer 9 is group 1 of position 1 (mamba, MoE)
    assert np.array_equal(model.layers[9]["block"]["a_log"].numpy(),
                          tree["blocks"]["pos1"]["block"]["a_log"][1])
    assert "router" in model.layers[9]["mlp"]


def test_cache_layout_matches_the_reference():
    cfg = _cfg()
    got = _flat(cache_struct(cfg, 2, 16))
    want = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(j_cache_struct(cfg, 2, 16))[0]}
    assert list(got) == sorted(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).replace("torch.", "") == str(want[path].dtype)
    assert cache_axes(cfg) == j_cache_axes(cfg)
    assert cache_axes(cfg)["pos0"] == (("layers", "batch", None, "mlp"),
                                       ("layers", "batch", "mlp", None))
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert all(not t.any() for t in _flat(cache).values())


def test_prefill_returns_the_conv_window_in_the_compute_dtype():
    """Under the f32 compute dtype with a bf16 cache, the JAX prefill
    returns the conv window in f32 (``mamba_full``'s ``.astype(dt)``) while
    ``init_cache`` makes it bf16; a decode step from the bf16 leaf returns
    a new f32 leaf (the promoted window) and writes the f32 ssm state in
    place.  The port does the same, and the decode engine seeds its
    persistent state at the step's own dtypes, as the JAX engine does."""
    cfg = _cfg()
    tree = _numpy_tree(cfg, 7)
    model = params_from_jax(cfg, tree, device="cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (2, 10))
    _, cache = prefill(model, {"tokens": torch.from_numpy(prompt)}, 16,
                       torch.bfloat16)
    _, jcache = j_prefill(jax.tree_util.tree_map(jnp.asarray, tree),
                          {"tokens": jnp.asarray(prompt)}, cfg, 16,
                          jnp.bfloat16)
    assert cache["pos0"][0].dtype == torch.float32
    assert jcache["pos0"][0].dtype == jnp.float32
    assert cache["pos3"]["k"].dtype == torch.bfloat16
    fresh = init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    assert fresh["pos0"][0].dtype == torch.bfloat16
    conv_leaf, ssm_leaf = fresh["pos0"]
    _, stepped = decode_step(model, fresh, torch.tensor([3, 4]), 0)
    assert stepped["pos0"][0].dtype == torch.float32
    assert stepped["pos0"][0] is not conv_leaf
    assert stepped["pos0"][1] is ssm_leaf and ssm_leaf.any()
    _, jstepped = j_decode_step(
        jax.tree_util.tree_map(jnp.asarray, tree),
        j_init_cache(cfg, 2, 16, jnp.bfloat16),
        jnp.asarray([3, 4], jnp.int32), 0, cfg)
    assert jstepped["pos0"][0].dtype == jnp.float32
    eng = DecodeEngine(cfg, map_tree(torch.from_numpy, tree), num_slots=2,
                       max_len=16, device="cpu")
    jeng = JDecodeEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                         num_slots=2, max_len=16)
    got = [str(t.dtype).replace("torch.", "") for t in eng._cache_structs()]
    assert got == [str(s.dtype) for s in jeng._cache_structs()]
    assert got.count("float32") == 14 and got.count("bfloat16") == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_shapes_on_meta(dtype):
    """jamba at its published widths, one period of 8 layers, on ``meta``
    tensors (no weights drawn): the prefill's logits and cache and a decode
    step's have the shapes and dtypes the cache struct names."""
    cfg = dataclasses.replace(configs.get(JAMBA), n_layers=8, dtype=dtype)
    model = Transformer(cfg, map_tree(
        lambda s: torch.empty(s.shape, device="meta"), model_spec(cfg)))
    before = dict(LAUNCHES)
    tokens = torch.zeros((2, 5), dtype=torch.long, device="meta")
    logits, cache = prefill(model, {"tokens": tokens}, 32)
    assert logits.shape == (2, cfg.vocab_padded) and logits.device.type == "meta"
    want = _flat(cache_struct(cfg, 2, 32))
    got = _flat(cache)
    assert list(got) == list(want)
    for path, t in got.items():
        assert t.shape == want[path].shape, path
        # the conv windows come back in the compute dtype, the rest in the
        # struct's (bf16 KV, f32 ssm state)
        conv = path.endswith("[0]")
        assert t.dtype == (getattr(torch, dtype) if conv
                           else want[path].dtype), path
    assert got["['pos0'][0]"].shape == (1, 2, 3, 16384)
    assert got["['pos0'][1]"].shape == (1, 2, 16384, 16)
    logits, cache = decode_step(model, cache, torch.zeros(
        2, dtype=torch.int32, device="meta"), 5)
    assert logits.shape == (2, cfg.vocab_padded)
    assert LAUNCHES == before


def test_narrow_products_run_on_fixed_row_chunks(monkeypatch):
    """``x_proj`` (Di -> dt_rank + 2N) and the attention's kv projections
    run as products of ``PRODUCT_ROWS`` token rows each, the last padded
    (on an H100 in bf16 the library's kernel for these narrow products
    changes with the row count, and a prompt served alone parted from its
    batch); their values are the plain product's, and a token's bits are
    the same alone and in a batch."""
    from repro_torch.models import attention, layers
    cfg = _cfg()
    pt, _ = _both(_block_params(cfg, 9))
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (3, 100, cfg.mamba_d_inner)).astype(np.float32))
    shapes = []
    real = torch.matmul

    def spy(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    delta, bmat, _ = mamba._ssm_inputs(pt, x, cfg)
    narrow = (cfg.mamba_d_inner, cfg.mamba_dt_rank + 2 * cfg.mamba_d_state)
    assert [s for s in shapes if s[1] == narrow] == [
        ((layers.PRODUCT_ROWS, cfg.mamba_d_inner), narrow)] * 2   # 300 rows
    shapes.clear()
    ap = {k: torch.randn(s.shape) for k, s in attention.attn_spec(cfg).items()}
    attention._project_qkv(ap, torch.randn(2, 5, cfg.d_model), cfg,
                           torch.arange(5))
    kv = (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
    assert [s for s in shapes if s[1] == kv] == [
        ((layers.PRODUCT_ROWS, cfg.d_model), kv)] * 2
    monkeypatch.undo()
    w = pt["x_proj"]
    got = layers.rows_matmul(x, w)
    assert got.shape == (3, 100, narrow[1])
    _close(got, (x @ w).numpy(), 1e-6)
    assert torch.equal(layers.rows_matmul(x[1:2, 7:9], w)[0], got[1, 7:9])
    assert layers.rows_matmul(x[:0], w).shape == (0, 100, narrow[1])
