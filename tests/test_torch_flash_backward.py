"""The flash-attention gradient on the CPU: the plain version's autograd
against ``jax.grad`` of the JAX package's XLA path, and the wrapper's rules.

* The causal plain version used to write each q block's online-softmax state
  into full-sequence buffers in place, which autograd had saved: its
  ``backward`` raised.  It now rebinds the state per q block; its forward
  must keep the bits of the in-place version (:func:`_inplace_causal`, the
  parent's algorithm kept here as the pin), in f32 and bf16, for q_offset
  0, positive and negative.
* Gradients: the same f32 arithmetic in another order, within 1e-5 of each
  gradient's largest magnitude.
* On the card the gradient is ``csrc/flash_attention_bwd.cu``, which only
  ``chip_smoke.py`` can run; here its shape rule (a ``ValueError`` naming
  ROADMAP.md queue 2 item 6, never a fallback), the CPU dispatch, and the
  card path's autograd wiring with the launches replaced by the plain
  versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.common import LAUNCHES, pad_dim
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (check_backward,
                                                     flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (_block, _merge, _state,
                                                     block_sizes,
                                                     causal_pairs,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain,
                                                     repeat_kv)

GRAD_RTOL = 1e-5


def _inplace_causal(q, k, v, *, scale=None, q_offset=0, bq=512, bk=512):
    """The plain causal path as it was: full-sequence (m, l, acc) buffers
    updated in place, block pair by block pair."""
    s, dk = q.shape[2], q.shape[3]
    t = k.shape[2]
    scale = dk ** -0.5 if scale is None else scale
    bq_, bk_ = block_sizes(s, t, bq, bk, True)
    group = q.shape[1] // k.shape[1]
    qp = pad_dim(q, 2, bq_)
    kp = repeat_kv(pad_dim(k, 2, bk_), group)
    vp = repeat_kv(pad_dim(v, 2, bk_), group)
    m_all, l_all, acc_all = _state(qp, vp.shape[3])
    for i, j in causal_pairs(qp.shape[2] // bq_, kp.shape[2] // bk_, bq_, bk_,
                             q_offset):
        rows = slice(i * bq_, (i + 1) * bq_)
        cols = slice(j * bk_, (j + 1) * bk_)
        mb, lb, ab = _block(qp[:, :, rows], kp[:, :, cols], vp[:, :, cols],
                            scale, True, q_offset + i * bq_, j * bk_, bq_, bk_)
        mn, ln, an = _merge(m_all[:, :, rows], l_all[:, :, rows],
                            acc_all[:, :, rows], mb, lb, ab)
        m_all[:, :, rows], l_all[:, :, rows], acc_all[:, :, rows] = mn, ln, an
    out = acc_all / torch.where(l_all == 0.0, 1.0, l_all)
    return out[:, :, :s].to(q.dtype)


def _qkv(seed, b, h, kvh, s, t, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32)
                              ).to(dtype)
                 for shape in ((b, h, s, d), (b, kvh, t, d), (b, kvh, t, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,q_offset,bq,bk", [
    (64, 64, 0, 16, 16), (40, 72, 32, 16, 16), (48, 48, -20, 16, 8),
    (100, 100, 0, 512, 512), (33, 70, 37, 8, 16)])
def test_causal_forward_keeps_the_in_place_versions_bits(dtype, s, t,
                                                         q_offset, bq, bk):
    q, k, v = _qkv(s + t, 2, 4, 2, s, t, 16, dtype)
    got = flash_attention(q, k, v, q_offset=q_offset, bq=bq, bk=bk)
    assert torch.equal(got, _inplace_causal(q, k, v, q_offset=q_offset,
                                            bq=bq, bk=bk))


@pytest.mark.parametrize("causal,h,kvh,s,d,bq,bk", [
    (True, 4, 2, 64, 64, 16, 16),       # GQA, several q and kv blocks
    (True, 4, 4, 48, 80, 512, 512),     # hubert's head dim, one block
    (True, 2, 1, 40, 128, 16, 8),       # ragged S over the blocks
    (False, 4, 2, 64, 64, 512, 16),     # non-causal scan over kv blocks
    (False, 4, 4, 32, 80, 512, 512)])
def test_plain_gradients_match_jax_grad_of_the_xla_path(causal, h, kvh, s, d,
                                                        bq, bk):
    q, k, v = _qkv(d + s, 2, h, kvh, s, s, d)
    dout = _qkv(d + s + 1, 2, h, kvh, s, s, d)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, bq=bq, bk=bk)
    out.backward(dout)

    def loss(q_, k_, v_):
        o = j_flash(q_, k_, v_, causal=causal, bq=bq, bk=bk, impl="xla")
        return jnp.sum(o * jnp.asarray(dout.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for got, ref in zip(leaves, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max())


def test_causal_backward_runs_and_matches_the_bwd_wrapper():
    """The in-place fault's RuntimeError ("modified by an inplace
    operation") does not come back, and ``flash_attention_bwd`` on CPU
    tensors is that same autograd, bit for bit, launching nothing."""
    q, k, v = _qkv(3, 2, 4, 2, 96, 96, 32)
    dout = _qkv(4, 2, 4, 2, 96, 96, 32)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, bq=32, bk=32).backward(dout)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, dout, None, causal=True)
    assert LAUNCHES == before
    # the wrapper's default blocks (512) against the 32-blocks above: the
    # same gradient up to the sums' order
    for g, leaf in zip(got, leaves):
        assert torch.isfinite(g).all()
        assert (g - leaf.grad).abs().max() <= GRAD_RTOL * leaf.grad.abs().max()


def test_no_grad_call_is_unchanged():
    q, k, v = _qkv(5, 1, 2, 2, 24, 24, 16)
    with torch.no_grad():
        a = flash_attention(q, k, v)
    b = flash_attention(*(x.clone().requires_grad_() for x in (q, k, v)))
    assert torch.equal(a, b.detach())


@pytest.mark.parametrize("dk,dv,q_offset", [(160, 160, 0), (192, 192, 0),
                                             (64, 64, -5), (48, 48, 0)])
def test_backward_kernel_refuses_other_shapes(dk, dv, q_offset):
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item 6"):
        check_backward(dk, dv, q_offset)


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128, 256])
def test_backward_kernel_takes_the_training_head_dims(d):
    check_backward(d, d, 0)


def test_the_card_path_is_an_autograd_function(monkeypatch):
    """With the launches replaced by the plain versions (the kernels run
    only on the card), a call whose inputs require grad goes through the
    autograd function: one forward launch that keeps the (B, H, S) f32
    log-sum-exp, then one backward launch on contiguous inputs (v is the
    strided view the model passes), whose gradients reach q, k and v in
    their shapes; a call without grad launches the forward alone, with no
    log-sum-exp."""
    calls = []

    def fake_forward(q, k, v, out, *, causal, scale, q_offset, bq, bk,
                     lse=None):
        out.copy_(flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                        q_offset=q_offset))
        if lse is not None:
            assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
            lse.zero_()
        calls.append(("forward", lse is not None))

    def fake_backward(q, k, v, dout, lse, delta, dq, dk, dv, *, causal,
                      scale, q_offset):
        assert all(x.is_contiguous() for x in (q, k, v, dout, lse))
        assert delta.shape == lse.shape
        for out, g in zip((dq, dk, dv), flash_attention_bwd_plain(
                q, k, v, dout, causal=causal, scale=scale,
                q_offset=q_offset)):
            out.copy_(g)
        calls.append("backward")

    monkeypatch.setattr(ops, "on_card", lambda *tensors: True)
    monkeypatch.setattr(ops, "launch_flash_attention", fake_forward)
    monkeypatch.setattr(ops, "launch_flash_attention_bwd", fake_backward)
    q, k, v = _qkv(6, 2, 4, 2, 40, 40, 32)
    v = v.transpose(1, 2).contiguous().transpose(1, 2)     # strided view
    dout = _qkv(7, 2, 4, 2, 40, 40, 32)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves)
    out.backward(dout)
    assert calls == [("forward", True), "backward"]
    for leaf, want in zip(leaves, flash_attention_bwd_plain(q, k, v, dout)):
        assert leaf.grad.shape == want.shape
        assert torch.equal(leaf.grad, want)
    calls.clear()
    with torch.no_grad():
        ops.flash_attention(*leaves)
    assert calls == [("forward", False)]
    # a context-parallel shard's rows: the backward takes their offset
    calls.clear()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*leaves, q_offset=4).backward(dout)
    assert calls == [("forward", True), "backward"]
    for leaf, want in zip(leaves, flash_attention_bwd_plain(
            q, k, v, dout, q_offset=4)):
        assert torch.equal(leaf.grad, want)
    with pytest.raises(ValueError, match="queue 2 item 6"):
        ops.flash_attention(*leaves, q_offset=-4)
