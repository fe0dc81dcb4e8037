"""The model's decode attention through ``decode_attention`` with each row's
``lengths``, on the CPU.

On the card ``attend_decode`` launches the decode-attention kernel, each
row limited to its keys ``[0, pos + 1)``; here the wrapper runs the masked
plain version (``decode_attention_masked_ref``), which must be the step's
products as ``attend_decode`` computed them before (the copy below), bit
for bit, at lengths 1, mid and T with T no multiple of the kernel's key
tile.  Against the JAX package's ``attend_decode`` in f32 (projections,
cache write and attention): within 1e-5 of the largest magnitude (the same
f32 products summed in another order).  A row alone gets the bits of the
same row in a batch, and the wrapper propagates shapes on ``meta``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import attention as jattention
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.decode_attention import KEY_TILE
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_masked_ref)
from repro_torch.models import attention

T = 77                                   # no multiple of the key tile
LENGTHS = (1, 39, T)


def _old_products(q, k_cache, v_cache, pos, dt):
    """attend_decode's attention before the kernel: q (B, H, 1, hd), the
    cache (B, KVH, T, hd), pos (B,) -> o (B, 1, H * hd) in ``dt``."""
    b, h, _, hd = q.shape
    kvh, t = k_cache.shape[1], k_cache.shape[2]
    dtype = k_cache.dtype
    group = h // kvh
    qd = q[:, :, 0].reshape(b, kvh, group, hd).to(dtype)
    scale = hd ** -0.5
    s = torch.matmul(qd.float(), k_cache.float().transpose(-1, -2)) * scale
    valid = torch.arange(t) <= pos[:, None]
    s = torch.where(valid[:, None, None], s, -1e30)
    m = s.amax(-1, keepdim=True)
    pexp = torch.exp(s - m)
    l = pexp.sum(-1, keepdim=True)
    o = torch.matmul(pexp.to(dtype).float(), v_cache.float()) / l
    return o.reshape(b, 1, h * hd).to(dt)


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_the_cache_is_no_multiple_of_the_key_tile():
    assert T % KEY_TILE


@pytest.mark.parametrize("cache_dtype,dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("kvh,group", [(2, 4), (4, 1), (1, 8)])
def test_masked_plain_version_is_the_steps_products(cache_dtype, dt, kvh,
                                                    group):
    b, hd = len(LENGTHS), 32
    h = kvh * group
    q = _rand((b, h, 1, hd), 1)
    k = _rand((b, kvh, T, hd), 2).to(cache_dtype)
    v = _rand((b, kvh, T, hd), 3).to(cache_dtype)
    pos = torch.tensor(LENGTHS) - 1
    got = decode_attention(q[:, :, 0].to(cache_dtype), k, v,
                           scale=hd ** -0.5, lengths=pos.clamp(0, T - 1) + 1,
                           out_dtype=dt)
    assert got.dtype == dt and got.shape == (b, h, hd)
    assert torch.equal(got.reshape(b, 1, h * hd),
                       _old_products(q, k, v, pos, dt))


def _cfgs():
    cfg = configs.get("qwen2.5-3b").reduced()
    jcfg = J_ARCHS["qwen2.5-3b"].reduced()
    return cfg, jcfg


def _params(jcfg, seed):
    tree = j_init_params(jattention.attn_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("length", LENGTHS)
def test_attend_decode_matches_the_reference(length):
    cfg, jcfg = _cfgs()
    assert cfg.dtype == "float32"
    pj, pt = _params(jcfg, 4)
    b, kvh, hd = 2, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, T, hd)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, T, hd)).astype(np.float32)
    pos = length - 1
    y, cache = attention.attend_decode(
        pt, torch.from_numpy(x),
        {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())},
        pos, cfg)
    jy, jcache = jattention.attend_decode(
        pj, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        pos, jcfg)
    want = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0,
                                   atol=1e-5 * np.abs(kc).max())


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_a_row_alone_gets_the_bits_of_the_row_in_a_batch(cache_dtype):
    b, kvh, h, hd = 6, 2, 8, 64
    q = _rand((b, h, hd), 6).to(cache_dtype)
    k = _rand((b, kvh, T, hd), 7).to(cache_dtype)
    v = _rand((b, kvh, T, hd), 8).to(cache_dtype)
    lengths = torch.tensor([1, 20, 39, 50, 76, 77])
    full = decode_attention(q, k, v, lengths=lengths)
    for i in range(b):
        alone = decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                 lengths=lengths[i:i + 1])
        assert torch.equal(alone[0], full[i])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_meta_shapes(dt):
    q = torch.empty((4, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 2, 300, 64), dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(4, dtype=torch.int64, device="meta")
    out = decode_attention(q, k, k, lengths=lengths, out_dtype=dt)
    assert out.is_meta and out.shape == (4, 8, 64) and out.dtype == dt
    cfg = dataclasses.replace(configs.get("qwen2.5-3b").reduced(),
                              dtype="bfloat16")
    p = {name: torch.empty(s.shape, device="meta", dtype=torch.bfloat16)
         for name, s in attention.attn_spec(cfg).items()}
    cache = attention.kv_cache_struct(cfg, 4, 300)
    y, _ = attention.attend_decode(
        p, torch.empty((4, 1, cfg.d_model), dtype=torch.bfloat16,
                       device="meta"), cache,
        torch.empty(4, dtype=torch.int64, device="meta"), cfg)
    assert y.is_meta and y.shape == (4, 1, cfg.d_model)


def test_lengths_argument_rules():
    q, k = torch.zeros(2, 4, 32), torch.zeros(2, 2, 40, 32)
    with pytest.raises(ValueError, match="partial"):
        decode_attention(q, k, k, lengths=torch.ones(2, dtype=torch.int64),
                         partial=True)
    with pytest.raises(ValueError, match="batch of 2"):
        decode_attention(q, k, k, lengths=torch.ones(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="out_dtype"):
        decode_attention(q, k, k, out_dtype=torch.float16)
    before = dict(common.LAUNCHES)
    decode_attention(q, k, k, lengths=torch.full((2,), 40))
    assert common.LAUNCHES == before          # the plain version launches nothing


def test_the_masked_plain_version_at_full_length_is_the_jax_path():
    """Every key visible: the masked products and the registry family's
    plain version (the JAX signature, no lengths) agree in f32 within 1e-6
    of the largest magnitude (the same sums in another order)."""
    q, k, v = _rand((3, 8, 32), 13), _rand((3, 2, T, 32), 14), _rand(
        (3, 2, T, 32), 15)
    got = decode_attention_masked_ref(q, k, v, torch.full((3,), T))
    want = decode_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
