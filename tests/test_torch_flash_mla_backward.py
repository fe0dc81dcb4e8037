"""The flash-attention gradient at Dk != Dv (MLA's heads) and the MLA block
under autograd, on the CPU, against ``jax.grad`` of the JAX package.

* The plain version's dq, dk and dv (autograd of
  ``flash_attention_plain``, the backward kernel's plain version) against
  ``jax.grad`` of the JAX ``flash_attention(..., impl="xla")`` at the
  reduced deepseek pair (48, 32) and at deepseek-v2's own (192, 128), tiny
  B, H and S, causal and not, MHA and a GQA group: within 1e-5 of each
  gradient's largest magnitude (the attention rule of ``PERF.md`` section
  2: the same f32 arithmetic in another order).
* ``mla_full`` (reduced deepseek) under autograd against ``jax.grad`` of the
  JAX block: the gradients of the input and of every leaf, among them the
  shared rope key, which ``expand`` broadcasts over the heads (its
  gradient sums over them) and ``cat`` joins to the per-head part; within
  1e-4 of each one's largest magnitude (the training rule).
* On the card the gradient is ``csrc/flash_attention_bwd.cu``, which only
  ``chip_smoke.py`` runs; here its pair rule: ``check_backward`` takes
  exactly the compiled pairs and raises a ``ValueError`` naming ROADMAP.md
  queue 2 item 6 for (256, 128), for Dk != Dv outside the list and for a
  ``q_offset``; (192, 128) takes the tensor cores in bf16 and the CUDA
  cores in f32, and its launch passes both head dims.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.mla import mla_full as j_mla_full
from repro.models.mla import mla_spec as j_mla_spec
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import check_backward
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain
from repro_torch.models.mla import mla_full

GRAD_RTOL = 1e-5


def _reduced_pair():
    cfg = configs.get("deepseek-v2-236b").reduced()
    return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,dk,dv", [
    (2, 4, 4, 40) + _reduced_pair(),      # the reduced deepseek's heads
    (1, 4, 2, 33) + _reduced_pair(),      # a GQA group, S no power of two
    (1, 2, 2, 24, 192, 128)])             # deepseek-v2's own pair
def test_plain_gradient_at_mixed_head_dims_matches_jax(b, h, kvh, s, dk, dv,
                                                       causal):
    rng = np.random.default_rng(dk + s)
    q, k = (rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, dk), (b, kvh, s, dk)))
    v = rng.standard_normal((b, kvh, s, dv)).astype(np.float32)
    dout = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: j_flash(*x, causal=causal, impl="xla"),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, dout)), causal=causal)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=f"d{name}")


def test_mla_block_gradients_match_jax():
    cfg = configs.get("deepseek-v2-236b").reduced()
    jcfg = jconfigs.ARCHS["deepseek-v2-236b"].reduced()
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        j_init_params(j_mla_spec(jcfg), jax.random.PRNGKey(1)))
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: j_mla_full(p, xx, jcfg), tree,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    params = {name: torch.from_numpy(a).requires_grad_()
              for name, a in tree.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = mla_full(params, xt, cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(y)).max())
    out.backward(torch.from_numpy(dy))
    for name, g, w in [("x", xt.grad, jgx)] + [
            (n, params[n].grad, jgp[n]) for n in sorted(params)]:
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    # the shared rope key's slice of wkv_a gets the head-summed gradient
    rope_cols = params["wkv_a"].grad[:, cfg.kv_lora_rank:]
    assert float(rope_cols.abs().max()) > 0


@pytest.mark.parametrize("pair", fa.BWD_PAIRS)
def test_check_backward_takes_the_compiled_pairs(pair):
    check_backward(*pair, 0)


def test_mla_pair_routes_and_is_the_forwards():
    assert (192, 128) in fa.BWD_PAIRS and (192, 128) in fa.BWD_MMA_PAIRS
    assert fa.bwd_route(torch.bfloat16, 192, 128) == "wgmma"
    assert fa.bwd_route(torch.float32, 192, 128) == "cuda_cores"
    # every tensor-core backward pair has a tensor-core forward
    assert set(fa.BWD_MMA_PAIRS) <= set(fa.MMA_HEAD_DIMS)
    assert set(fa.BWD_MMA_PAIRS) <= set(fa.BWD_PAIRS)


@pytest.mark.parametrize("dk,dv,q_offset", [
    (256, 128, 0),                 # paligemma's Dk against another Dv
    (48, 32, 0), (128, 192, 0), (192, 64, 0),   # Dk != Dv outside the list
    (192, 128, -16), (192, 128, -4)])
def test_other_pairs_and_offsets_are_refused(dk, dv, q_offset):
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item 6"):
        check_backward(dk, dv, q_offset)
    if q_offset == 0:
        with pytest.raises(ValueError, match="Dk = Dv"):
            fa.bwd_route(torch.bfloat16, dk, dv)


@pytest.mark.parametrize("dtype,route,h,kvh", [
    (torch.bfloat16, 1, 4, 4), (torch.float32, 0, 4, 4),
    (torch.bfloat16, 1, 4, 2)])
def test_the_launch_passes_both_head_dims(monkeypatch, dtype, route, h, kvh):
    calls = []
    monkeypatch.setattr(fa, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "stream_of", lambda t: None)
    b, s, t = 2, 5, 7
    q = torch.zeros(b, h, s, 192, dtype=dtype)
    k = torch.zeros(b, kvh, t, 192, dtype=dtype)
    v = torch.zeros(b, kvh, t, 128, dtype=dtype)
    dout = torch.zeros(b, h, s, 128, dtype=dtype)
    lse = torch.zeros(b, h, s)
    fa.launch_flash_attention_bwd(q, k, v, dout, lse, lse, q, k, v,
                                  causal=True, scale=192 ** -0.5)
    (args,) = calls
    # ..., b, h, kvh, s, t, dk, dv, scale, causal, q_offset, wgmma, part,
    # device, stream
    assert args[12:19] == (b, h, kvh, s, t, 192, 128)
    assert args[20:23] == (1, 0, route)
    # the GQA group's f32 partials: H * B * T * (Dk + Dv) floats, dK's then
    # dV's, on the tensor-core route only
    assert (args[23].value is not None) == (route == 1 and h > kvh)
    assert len(args[2]) == len(args) - 3          # one ctypes type an argument


def test_a_model_sized_mla_pair_is_the_configs():
    cfg = configs.get("deepseek-v2-236b")
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
            cfg.v_head_dim) in fa.BWD_MMA_PAIRS
    assert dataclasses.replace(cfg, n_layers=1).n_groups == 0
