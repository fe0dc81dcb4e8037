"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's, on the CPU.

deepseek-v2-236b's ``reduced()`` config (4 heads, q_lora 64, kv_lora 32,
nope 32 + rope 16, v 32), float32, the JAX package's ``init_params`` of
``mla_spec`` plus seeded noise on every leaf; inputs from numpy with a
seed.  The JAX side runs its flash-attention wrapper as its own tests run
it on the CPU.

Tolerances:

* ``rms_norm_1d`` and ``mla_full`` (with and without the latents it
  returns for the cache): 1e-5 of the largest magnitude — the same f32
  products summed in another order;
* ``mla_decode`` over several steps against the JAX decode on the same
  bf16 cache: outputs within 1e-4 of the largest magnitude, and the rows it
  writes into the cache within one bf16 ulp plus 1e-5 of the largest (an
  f32 latent that differs in its last bits can round to the neighbouring
  bf16 value);
* a (B,) positions step against the scalar step at each row's position:
  ``torch.equal`` (logits and cache), the same arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.models import layers, mla

ARCH = "deepseek-v2-236b"
BF16_ULP = 2.0 ** -7


def _cfgs(**changes):
    return (dataclasses.replace(configs.get(ARCH).reduced(), **changes),
            dataclasses.replace(J_ARCHS[ARCH].reduced(), **changes))


def _params(jcfg, seed):
    tree = j_init_params(jmla.mla_spec(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _within_bf16_ulp(got, want, rtol=1e-5):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    tol = (BF16_ULP * np.maximum(np.abs(got), np.abs(want))
           + rtol * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()


def test_spec_and_rms_norm_1d_are_the_references():
    cfg, jcfg = _cfgs()
    for c_, jc in ((cfg, jcfg), (configs.get(ARCH), J_ARCHS[ARCH])):
        for stacked in (0, 3):
            spec = mla.mla_spec(c_, stacked)
            jspec = jmla.mla_spec(jc, stacked)
            assert {k: dataclasses.asdict(v) for k, v in spec.items()} == {
                k: dataclasses.asdict(v) for k, v in jspec.items()}
    x = _x((2, 5, 48), 1)
    scale = _x((48,), 2)
    _close(layers.rms_norm_1d(torch.from_numpy(x), torch.from_numpy(scale),
                              1e-5),
           jlayers.rms_norm_1d(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    # bf16 in, bf16 out (the norm itself in f32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.rms_norm_1d(xb, torch.from_numpy(scale), 1e-5)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("seq", [1, 17])
def test_mla_full_matches_the_reference(seq):
    cfg, jcfg = _cfgs()
    jp, p = _params(jcfg, 3)
    x = _x((2, seq, cfg.d_model), 4)
    y = mla.mla_full(p, torch.from_numpy(x), cfg)
    jy = jmla.mla_full(jp, jnp.asarray(x), jcfg)
    assert y.shape == x.shape
    _close(y.numpy(), jy, 1e-5)
    y2, (c_kv, k_rope) = mla.mla_full(p, torch.from_numpy(x), cfg,
                                      return_cache=True)
    jy2, (jc_kv, jk_rope) = jmla.mla_full(jp, jnp.asarray(x), jcfg,
                                          return_cache=True)
    assert torch.equal(y, y2)
    assert c_kv.shape == (2, seq, cfg.kv_lora_rank)
    assert k_rope.shape == (2, seq, cfg.qk_rope_head_dim)
    _close(c_kv.numpy(), jc_kv, 1e-5)
    _close(k_rope.numpy(), jk_rope, 1e-5)


def test_mla_decode_matches_the_reference_over_steps():
    """A prefill's latents padded into the bf16 cache, then four decode
    steps, each against the JAX decode on its own cache."""
    cfg, jcfg = _cfgs()
    jp, p = _params(jcfg, 5)
    prompt, max_len = 9, 16
    x = _x((2, prompt, cfg.d_model), 6)
    _, (c_kv, k_rope) = mla.mla_full(p, torch.from_numpy(x), cfg,
                                     return_cache=True)
    _, (jc_kv, jk_rope) = jmla.mla_full(jp, jnp.asarray(x), jcfg,
                                        return_cache=True)
    cache = mla.mla_cache_from_prefill(cfg, c_kv, k_rope, max_len)
    jcache = jmla.mla_cache_from_prefill(jcfg, jc_kv, jk_rope, max_len)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.bfloat16) for k, v in jcache.items()}
    assert not cache["c_kv"][:, prompt:].any()
    for step in range(4):
        xs = _x((2, 1, cfg.d_model), 10 + step)
        pos = prompt + step
        y, cache = mla.mla_decode(p, torch.from_numpy(xs), cache, pos, cfg)
        jy, jcache = jmla.mla_decode(jp, jnp.asarray(xs), jcache, pos, jcfg)
        _close(y.numpy(), jy, 1e-4)
        for name in ("c_kv", "k_rope"):
            _within_bf16_ulp(cache[name][:, :pos + 1].float().numpy(),
                             np.asarray(jcache[name][:, :pos + 1], np.float32))
        assert not cache["c_kv"][:, pos + 1:].any()


def test_mla_decode_per_row_positions_bit_equal_and_on_meta():
    """A (B,) positions tensor gives each row the bits of the scalar step
    of the same batch at that row's position, the cache included; a
    position past the cache writes the last row (``dynamic_update_slice``
    clamps); the step runs on ``meta`` tensors."""
    cfg, _ = _cfgs()
    _, p = _params(_cfgs()[1], 7)
    max_len = 12
    x = _x((3, 8, cfg.d_model), 8)
    _, (c_kv, k_rope) = mla.mla_full(p, torch.from_numpy(x), cfg,
                                     return_cache=True)
    cache = mla.mla_cache_from_prefill(cfg, c_kv, k_rope, max_len)
    xs = torch.from_numpy(_x((3, 1, cfg.d_model), 9))
    positions = torch.tensor([8, 11, 9])

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    y, got = mla.mla_decode(p, xs, clone(cache), positions, cfg)
    for row, pos in enumerate(positions.tolist()):
        want_y, want = mla.mla_decode(p, xs, clone(cache), pos, cfg)
        assert torch.equal(y[row], want_y[row])
        for name in got:
            assert torch.equal(got[name][row], want[name][row])
    # pos == max_len: the last cache row is written, every row attended
    over = clone(cache)
    mla.mla_decode(p, xs, over, max_len, cfg)
    assert not torch.equal(over["c_kv"][:, -1], cache["c_kv"][:, -1])
    meta_p = {k: v.to("meta") for k, v in p.items()}
    meta_c = {k: v.to("meta") for k, v in cache.items()}
    my, mc = mla.mla_decode(meta_p, xs.to("meta"), meta_c,
                            positions.to("meta"), cfg)
    assert my.device.type == "meta" and my.shape == y.shape
    assert mc["c_kv"].shape == cache["c_kv"].shape


def test_init_mla_cache_is_the_references_layout():
    cfg, jcfg = _cfgs()
    got = mla.mla_cache_struct(cfg, 3, 20)
    want = jmla.mla_cache_struct(jcfg, 3, 20)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mla.init_mla_cache(cfg, 1, 4)
    assert mla.init_mla_cache(cfg, 1, 4, device="cpu")["c_kv"].device.type == "cpu"
