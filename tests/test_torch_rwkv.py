"""rwkv6-3b serving in the port against the JAX package, on the CPU.

The op: the same numpy inputs, made from a seed, go through the JAX
``rwkv6_scan`` (its XLA chunked path, ``impl="xla"``, what JAX runs off a
TPU and what its serving path runs on every backend; the Pallas kernel in
interpret mode where the test says so) and its oracle, and through the
port's wrapper on CPU tensors, which runs the kernel's plain version
(``rwkv6_scan_plain``).  The same f32 arithmetic in another summation
order: 2e-5 of the output's largest magnitude.

The model: rwkv6-3b ``.reduced()`` (d_model 128, 4 heads of 32, 3 layers)
with the JAX package's initial parameters plus seeded numpy noise, carried
across with ``params_from_jax``.  In float32 prefill logits, every cache
leaf and decode logits agree within 1e-4 of their largest magnitude (the
same f32 arithmetic in another order); in bfloat16 within 5e-2, because a
sum that differs in its last f32 bits rounds to the neighbouring bf16
value in a few per cent of the activations (measured: one bf16 ulp on
2-6 % of a layer's outputs, 1.9-2.9 % of max |logit| after 3 layers).
Greedy tokens are equal in both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_scan_ref
from repro.kernels.rwkv6_scan.ref import rwkv6_step_ref as j_step_ref
from repro.models import rwkv as jrwkv
from repro.models.params import init_params as j_init_params
from repro.models.transformer import cache_axes as j_cache_axes
from repro.models.transformer import cache_struct as j_cache_struct
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import model_spec as j_model_spec
from repro.models.transformer import prefill as j_prefill
from repro.train.serve import greedy_generate as j_greedy_generate
from repro_torch import configs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_plain,
                                                rwkv6_scan_ref, rwkv6_step_ref)
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import COMPILED_D
from repro_torch.models import rwkv
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import init_params, leaves_with_path
from repro_torch.models.transformer import (Transformer, cache_axes,
                                            cache_struct, decode_step,
                                            init_cache, model_spec, prefill)
from repro_torch.train.serve import greedy_generate, make_decode_step

SCAN_RTOL = 2e-5
F32_RTOL = 1e-4
BF16_RTOL = 5e-2
PROMPT_LEN, MAX_LEN, STEPS = 24, 40, 4


def _scan_inputs(seed, b, h, t, d, with_state):
    """The ranges of tests/test_kernels.py: r/k/v/u at 0.3, w in [0.3, 0.8)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(b, h, t, d), f(b, h, t, d), f(b, h, t, d)
    w = (rng.random((b, h, t, d)) * 0.5 + 0.3).astype(np.float32)
    u = f(h, d)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32) if with_state else None
    return r, k, v, w, u, s0


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def _jj(a):
    return None if a is None else jnp.asarray(a)


# -- the op ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("t,with_state", [(45, False), (45, True), (64, True),
                                          (1, True)])
def test_plain_matches_jax_xla_and_the_oracle(d, t, with_state):
    r, k, v, w, u, s0 = _scan_inputs(d + t, 2, 3, t, d, with_state)
    y, s = rwkv6_scan(*map(_tt, (r, k, v, w, u)), _tt(s0))
    assert y.shape == (2, 3, t, d) and y.dtype == torch.float32
    assert s.shape == (2, 3, d, d) and s.dtype == torch.float32
    jy, js = j_scan(*map(_jj, (r, k, v, w, u)), _jj(s0), impl="xla")
    _close(y, jy, SCAN_RTOL)
    _close(s, js, SCAN_RTOL)
    ry, rs = j_scan_ref(*map(_jj, (r, k, v, w, u)), _jj(s0))
    _close(y, ry, SCAN_RTOL)
    _close(s, rs, SCAN_RTOL)
    oy, os_ = rwkv6_scan_ref(*map(_tt, (r, k, v, w, u)), _tt(s0))
    _close(oy, ry, SCAN_RTOL)
    _close(os_, rs, SCAN_RTOL)


def test_plain_matches_the_tpu_kernel_in_interpret_mode():
    """With no state the JAX op takes its Pallas kernel (interpret mode)."""
    r, k, v, w, u, _ = _scan_inputs(3, 1, 2, 64, 16, False)
    y, s = rwkv6_scan(*map(_tt, (r, k, v, w, u)))
    jy, js = j_scan(*map(_jj, (r, k, v, w, u)), impl="pallas")
    _close(y, jy, SCAN_RTOL)
    _close(s, js, SCAN_RTOL)


def test_zero_state_is_no_state_and_steps_chain():
    r, k, v, w, u, _ = _scan_inputs(4, 2, 2, 40, 16, False)
    args = tuple(map(_tt, (r, k, v, w, u)))
    y0, s0 = rwkv6_scan(*args)
    yz, sz = rwkv6_scan(*args, torch.zeros(2, 2, 16, 16))
    assert torch.equal(y0, yz) and torch.equal(s0, sz)
    # decode's chaining: a prefix, then one step at a time from its state
    y1, s1 = rwkv6_scan(*(a[:, :, :30] for a in args[:4]), args[4])
    ys = [y1]
    for i in range(30, 40):
        yi, s1 = rwkv6_scan(*(a[:, :, i:i + 1] for a in args[:4]), args[4], s1)
        ys.append(yi)
    _close(torch.cat(ys, 2), y0, SCAN_RTOL)
    _close(s1, s0, SCAN_RTOL)
    # the single-step oracle of both packages
    ry, rs = rwkv6_step_ref(*(a[:, :, 0] for a in args[:4]), args[4], s0)
    jy, js = j_step_ref(*(jnp.asarray(a[:, :, 0].numpy()) for a in args[:4]),
                        jnp.asarray(u), jnp.asarray(s0.numpy()))
    _close(ry, jy, SCAN_RTOL)
    _close(rs, js, SCAN_RTOL)


def test_bf16_inputs_keep_the_dtype_rule_of_the_jax_op():
    """r/k/v bf16 with an f32 w, as the model passes them: y comes back in
    bf16, within one bf16 ulp of the JAX op's (both round the same f32)."""
    r, k, v, w, u, s0 = _scan_inputs(5, 1, 2, 33, 32, True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y, s = rwkv6_scan(bf(r), bf(k), bf(v), *map(_tt, (w, u, s0)))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jy, js = j_scan(jb(r), jb(k), jb(v), *map(_jj, (w, u, s0)), impl="xla")
    g, want = y.float().numpy(), np.asarray(jy.astype(jnp.float32))
    scale = np.abs(want).max()
    assert (np.abs(g - want) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(want))
            + SCAN_RTOL * scale).all()
    _close(s, js, SCAN_RTOL)


def test_wrapper_checks_shapes_runs_meta_and_counts_no_cpu_launch():
    r, k, v, w, u, s0 = map(_tt, _scan_inputs(6, 1, 2, 8, 16, True))
    with pytest.raises(ValueError, match="do not fit"):
        rwkv6_scan(r, k, v, w, u[:, :8])
    with pytest.raises(ValueError, match="do not fit"):
        rwkv6_scan(r, k, v, w, u, s0[:, :, :8])
    before = dict(LAUNCHES)
    y, s = rwkv6_scan(*(x.to("meta") for x in (r, k, v, w, u, s0)))
    assert y.device.type == "meta" and y.shape == r.shape and s.shape == s0.shape
    rwkv6_scan(r, k, v, w, u, s0)
    assert LAUNCHES == before
    assert COMPILED_D == (32, 64)
    y, s = rwkv6_scan_plain(r[:, :, :0], k[:, :, :0], v[:, :, :0], w[:, :, :0],
                            u, s0)
    assert y.shape == (1, 2, 0, 16) and torch.equal(s, s0)


# -- the model -------------------------------------------------------------------
def _cfg(dtype="float32", n_layers=3):
    return dataclasses.replace(configs.get("rwkv6-3b").reduced(),
                               n_layers=n_layers, dtype=dtype)


def _numpy_tree(cfg, seed):
    """The JAX package's init, plus seeded noise on every leaf."""
    tree = j_init_params(j_model_spec(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                        ("bfloat16", BF16_RTOL)])
def test_prefill_decode_and_greedy_match_the_reference(dtype, rtol):
    cfg = _cfg(dtype)
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
    assert logits.shape == (2, cfg.vocab_padded) and logits.dtype == torch.float32
    _close(logits.numpy(), jlogits, rtol)

    def caches_close(tc, jc):
        assert len(tc["pos0"]) == len(jc["pos0"]) == 3
        for got, want in zip(tc["pos0"], jc["pos0"]):
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                   rtol)

    caches_close(cache, jcache)
    # decode, teacher-forced from the reference's greedy tokens; the cache
    # is written in place
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    leaves = [t.data_ptr() for t in cache["pos0"]]
    for i in range(STEPS):
        jlogits, jcache = j_decode_step(jparams, jcache, jnp.asarray(tok),
                                        PROMPT_LEN + i, cfg)
        logits, cache = decode_step(model, cache, torch.from_numpy(tok),
                                    PROMPT_LEN + i)
        _close(logits.numpy(), jlogits, rtol)
        caches_close(cache, jcache)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert [t.data_ptr() for t in cache["pos0"]] == leaves

    want = np.asarray(j_greedy_generate(jparams, cfg, jnp.asarray(prompt),
                                        STEPS + 1, MAX_LEN))
    got = greedy_generate(model, prompt, STEPS + 1, MAX_LEN)
    assert got.dtype == torch.int32 and got.shape == (2, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert LAUNCHES == before                  # the CPU runs no kernel


def test_blocks_match_the_reference_function_for_function():
    cfg = _cfg("bfloat16", n_layers=1)
    tree = _numpy_tree(cfg, 7)
    model = params_from_jax(cfg, tree, device="cpu")
    jblk = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                  tree["blocks"]["pos0"]["block"])
    tblk = model.layers[0]["block"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    lj, lt = jnp.asarray(last, jnp.bfloat16), torch.from_numpy(last).to(torch.bfloat16)

    def same(got, want):
        """bit for bit: the projections, the shifts and the mixes."""
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    same(rwkv._shift(xt, lt), jrwkv._shift(xj, lj))
    same(rwkv._heads(xt, 4, 32), jrwkv._heads(xj, 4, 32))
    xxt, xxj = rwkv._shift(xt) - xt, jrwkv._shift(xj) - xj
    # r, k, v, w, g: bf16 products summed in another order, so within one
    # bf16 ulp of each value (w, f32, follows its bf16 lora product)
    for got, want in zip(rwkv._mix_inputs(tblk, xt, xxt, cfg),
                         jrwkv._mix_inputs(jblk, xj, xxj, cfg)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert (np.abs(g - w) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
                + 1e-6 * np.abs(w).max()).all()
    same(rwkv.rwkv_channel_mix(tblk, xt, cfg, last_x=lt),
         jrwkv.rwkv_channel_mix(jblk, xj, cfg, last_x=lj))
    # the group norm uses the population variance
    y = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    _close(rwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale), 4,
                            32, cfg.norm_eps).numpy(),
           jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), 4, 32,
                             cfg.norm_eps), 1e-6)
    # the time mix (through the op's plain version) and the whole block
    _close(rwkv.rwkv_time_mix(tblk, xt, cfg).float().numpy(),
           jrwkv.rwkv_time_mix(jblk, xj, cfg).astype(jnp.float32), BF16_RTOL)
    _close(rwkv.rwkv_block(tblk, xt, cfg).float().numpy(),
           jrwkv.rwkv_block(jblk, xj, cfg).astype(jnp.float32), BF16_RTOL)


def test_model_keeps_the_leaves_the_jax_block_widens_in_f32():
    cfg = _cfg("bfloat16", n_layers=1)
    model = Transformer(cfg, init_params(model_spec(cfg), 0, device="cpu"))
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        want = (torch.float32 if "norm" in name or leaf in rwkv.F32_LEAVES
                else torch.bfloat16)
        assert p.dtype == want, name
    assert rwkv.F32_LEAVES == {"w0", "u_bonus", "ln_x"}
    # u_bonus keeps its f32 bits (bf16 would round them)
    tree = _numpy_tree(cfg, 9)
    m = params_from_jax(cfg, tree, device="cpu")
    np.testing.assert_array_equal(
        m.layers[0]["block"]["u_bonus"].numpy(),
        tree["blocks"]["pos0"]["block"]["u_bonus"][0])
    back = params_to_numpy(m)
    assert list(dict(leaves_with_path(back))) == list(dict(leaves_with_path(tree)))
    # a float32 model gives the JAX tree back exactly
    f32 = _cfg("float32", n_layers=2)
    tree = _numpy_tree(f32, 10)
    back = dict(leaves_with_path(params_to_numpy(
        params_from_jax(f32, tree, device="cpu"))))
    for path, a in leaves_with_path(tree):
        assert back[path].dtype == np.float32
        np.testing.assert_array_equal(back[path], a, err_msg=path)


def test_rwkv_cache_layout_matches_the_reference():
    cfg = _cfg(n_layers=3)
    got = cache_struct(cfg, 4, 64)
    want = j_cache_struct(cfg, 4, 64)
    assert len(got["pos0"]) == 3
    for t, s in zip(got["pos0"], want["pos0"]):
        assert t.device.type == "meta" and tuple(t.shape) == s.shape
        assert str(t.dtype).replace("torch.", "") == str(s.dtype)
    assert cache_axes(cfg) == j_cache_axes(cfg)
    zero = init_cache(cfg, 2, 16, device="cpu")
    jzero = j_init_cache(cfg, 2, 16)
    for t, s in zip(zero["pos0"], jzero["pos0"]):
        assert tuple(t.shape) == s.shape and not t.any()
        assert str(t.dtype).replace("torch.", "") == str(s.dtype)
    for t, s in zip(rwkv.rwkv_state_struct(cfg, 3),
                    jrwkv.rwkv_state_struct(cfg, 3)):
        assert t.device.type == "meta" and tuple(t.shape) == s.shape
        assert str(t.dtype).replace("torch.", "") == str(s.dtype)
    # max_len does not size the state
    assert [t.shape for t in init_cache(cfg, 2, 999, device="cpu")["pos0"]] == \
        [t.shape for t in zero["pos0"]]


def test_decode_from_a_zero_cache_equals_a_one_token_prefill():
    cfg = _cfg()
    model = params_from_jax(cfg, _numpy_tree(cfg, 11), device="cpu")
    tok = torch.tensor([3, 17], dtype=torch.int32)
    logits, _ = prefill(model, {"tokens": tok[:, None].long()}, 8)
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    nxt, dlogits, cache = make_decode_step(cfg)(model, cache, tok, 0)
    _close(dlogits.numpy(), logits.numpy(), F32_RTOL)
    assert torch.equal(nxt, torch.argmax(logits, -1).to(torch.int32))
    assert cache["pos0"][1].abs().sum() > 0           # the state moved
