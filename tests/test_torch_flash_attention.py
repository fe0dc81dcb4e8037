"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX op
(``impl="xla"``, the path JAX takes on every backend but a TPU;
``impl="pallas"``, the TPU kernel in interpret mode, at sizes of 256 or
less; and ``mha_ref``) and through the port's wrapper on CPU tensors, which
runs the kernel's plain PyTorch version (``flash_attention_plain``).

Tolerance in float32: 2e-5 absolute on outputs of magnitude about 1 (the
same f32 online softmax, summed in another order).  In bfloat16 both
packages round the same f32 result, so outputs differ by at most one bf16
ulp of the output (2^-7 relative).

The tensor-map admissibility rule of the bf16 tensor-core kernel
(``tma_describable``) is pure Python on sizes, strides and the base
address, so it is tested here too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import mha_ref as j_mha_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention as fa_module
from repro_torch.kernels.flash_attention.flash_attention import (
    COMPILED_DV, MMA_HEAD_DIMS, supports_head_dims, tma_describable, tma_view)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (causal_pairs,
                                                     flash_attention_plain,
                                                     mha_ref, repeat_kv)

F32_ATOL = 2e-5


def _qkv(seed, b, h, kvh, s, t, dk, dv=None):
    rng = np.random.default_rng(seed)
    dv = dk if dv is None else dv
    return (rng.standard_normal((b, h, s, dk)).astype(np.float32),
            rng.standard_normal((b, kvh, t, dk)).astype(np.float32),
            rng.standard_normal((b, kvh, t, dv)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# the shapes of tests/test_kernels.py: GQA group 1, 2 and 8
@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 4, 4, 128, 32), (2, 4, 2, 256, 64),
                                         (1, 8, 1, 512, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_xla_and_mha_ref(b, h, kvh, s, d, causal):
    arrs = _qkv(0, b, h, kvh, s, s, d)
    got = flash_attention(*_t(*arrs), causal=causal).numpy()
    want = np.asarray(j_flash(*_j(*arrs), causal=causal, impl="xla"))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    oracle = np.asarray(j_mha_ref(*_j(*arrs), causal=causal))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(mha_ref(*_t(*arrs), causal=causal).numpy(),
                               oracle, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("causal,s,bq,bk", [(True, 256, 128, 128),
                                            (False, 256, 128, 128),
                                            (True, 200, 64, 128)])
def test_plain_matches_pallas_interpret(causal, s, bq, bk):
    arrs = _qkv(1, 1, 4, 2, s, s, 64)
    got = flash_attention(*_t(*arrs), causal=causal, bq=bq, bk=bk).numpy()
    want = np.asarray(j_flash(*_j(*arrs), causal=causal, impl="pallas",
                              bq=bq, bk=bk))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_q_offset_decode_suffix():
    """q as a suffix of the sequence (chunked prefill)."""
    arrs = _qkv(2, 1, 4, 4, 64, 256, 32)
    got = flash_attention(*_t(*arrs), causal=True, q_offset=192).numpy()
    for want in (j_flash(*_j(*arrs), causal=True, q_offset=192, impl="xla"),
                 j_mha_ref(*_j(*arrs), causal=True, q_offset=192)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_ATOL)
    got_b = flash_attention(*_t(*arrs), causal=True, q_offset=192, bq=32,
                            bk=64).numpy()
    np.testing.assert_allclose(got_b, got, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dk,dv", [(96, 64), (64, 32)])
def test_dk_differs_from_dv(dk, dv):
    arrs = _qkv(3, 1, 4, 4, 128, 128, dk, dv)
    got = flash_attention(*_t(*arrs), causal=True)
    assert got.shape == (1, 4, 128, dv)
    want = np.asarray(j_flash(*_j(*arrs), causal=True, impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("s,bq,bk", [(300, 512, 512), (300, 128, 128),
                                     (1000, 512, 512)])
def test_ragged_sequence(s, bq, bk):
    arrs = _qkv(4, 1, 4, 2, s, s, 32)
    got = flash_attention(*_t(*arrs), causal=True, bq=bq, bk=bk).numpy()
    want = np.asarray(j_flash(*_j(*arrs), causal=True, impl="xla", bq=bq, bk=bk))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got, np.asarray(j_mha_ref(*_j(*arrs))),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_within_one_ulp(causal):
    arrs = _qkv(5, 2, 4, 2, 128, 128, 64)
    bf = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = flash_attention(*bf, causal=causal)
    assert got.dtype == torch.bfloat16
    want = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                   causal=causal, impl="xla")
    got32 = got.float().numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** -7 * np.maximum(np.abs(got32), np.abs(want32))
    assert (np.abs(got32 - want32) <= ulp).all()


def test_non_causal_needs_a_dividing_kv_block():
    arrs = _qkv(6, 1, 2, 2, 64, 300, 32)
    with pytest.raises(ValueError, match="T % bk"):
        j_flash(*_j(*arrs), causal=False, impl="xla", bk=128)
    with pytest.raises(ValueError, match="T % bk"):
        flash_attention(*_t(*arrs), causal=False, bk=128)
    meta = tuple(torch.empty(a.shape, device="meta") for a in arrs)
    with pytest.raises(ValueError, match="T % bk"):
        flash_attention(*meta, causal=False, bk=128)
    # min(bk, T) = T divides T: allowed, as in the JAX wrapper
    got = flash_attention(*_t(*arrs), causal=False).numpy()
    want = np.asarray(j_flash(*_j(*arrs), causal=False, impl="xla"))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_meta_inputs_give_meta_outputs_without_launching():
    before = dict(LAUNCHES)
    q = torch.empty(2, 16, 300, 96, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 300, 96, device="meta", dtype=torch.bfloat16)
    v = torch.empty(2, 2, 300, 64, device="meta", dtype=torch.bfloat16)
    out = flash_attention(q, k, v, causal=True, bq=128, bk=128)
    assert (out.device.type, out.shape, out.dtype) == (
        "meta", (2, 16, 300, 64), torch.bfloat16)
    assert LAUNCHES == before


def test_cpu_runs_never_count_launches():
    before = dict(LAUNCHES)
    arrs = _qkv(7, 1, 4, 2, 64, 64, 32)
    flash_attention(*_t(*arrs), causal=True)
    flash_attention(*_t(*arrs), causal=False)
    assert LAUNCHES == before
    assert "flash_attention" in LAUNCHES


def test_wrapper_rejects_shapes_that_do_not_fit():
    q, k, v = _t(*_qkv(8, 1, 4, 3, 16, 16, 32))    # 3 kv heads do not divide 4
    with pytest.raises(ValueError, match="shapes do not fit"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="takes q"):
        flash_attention(q[0], k[0], v[0])


def test_kernel_head_dims():
    for d in (32, 64, 80, 96, 128, 256):
        assert supports_head_dims(d, d)
    assert supports_head_dims(96, 64) and supports_head_dims(192, 128)
    assert supports_head_dims(80, 80)              # hubert's heads
    assert supports_head_dims(256, 256)            # paligemma's heads
    assert not supports_head_dims(30, 32) and not supports_head_dims(260, 256)
    assert not supports_head_dims(256, 192)        # Dv 192 is not compiled
    assert COMPILED_DV == (32, 64, 80, 96, 128, 256)
    # bf16 (256, 256) and hubert's (80, 80) run the tensor-core kernel
    assert (256, 256) in MMA_HEAD_DIMS and (80, 80) in MMA_HEAD_DIMS
    # the bf16 tensor-core kernel's pairs are a subset of what the wrapper takes
    assert all(supports_head_dims(dk, dv) for dk, dv in MMA_HEAD_DIMS)
    assert (128, 128) in MMA_HEAD_DIMS            # qwen2.5-3b's heads


def test_causal_pairs_and_repeat_kv_follow_the_reference():
    from repro.kernels.flash_attention.ops import _causal_pairs
    for args in ((4, 4, 64, 64, 0), (2, 8, 32, 32, 192), (3, 2, 100, 150, 0)):
        assert causal_pairs(*args) == _causal_pairs(*args)
    x = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 2, 3, 4)
    r = repeat_kv(x, 3)
    assert r.shape == (2, 6, 3, 4)
    assert torch.equal(r[:, 4], x[:, 1]) and torch.equal(r[:, 2], x[:, 0])


def test_rows_that_see_no_key_stay_finite():
    """The -1e30 sentinel (not -inf): a q row with no visible key
    (q_offset < 0) stays finite, as in the JAX package's blocked paths,
    where mha_ref's -inf gives NaN."""
    arrs = _qkv(9, 1, 2, 2, 8, 8, 32)
    out = flash_attention_plain(*_t(*arrs), causal=True, q_offset=-4)
    ref = mha_ref(*_t(*arrs), causal=True, q_offset=-4)
    assert torch.isnan(ref[:, :, :4]).all()
    assert torch.isfinite(out).all()
    want = np.asarray(j_flash(*_j(*arrs), causal=True, q_offset=-4, impl="xla"))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=F32_ATOL)
    torch.testing.assert_close(out[:, :, 4:], ref[:, :, 4:], rtol=0,
                               atol=F32_ATOL)


def _no_key_rows_rule(v, s, t, q_offset, h, bq=512, bk=512):
    """What the plain version gives a row i that sees no key (q_offset + i
    < 0): in each kv block its q block visits every score is the sentinel,
    so p = 1 on every column, and the row is the mean of v over the first
    (jmax + 1) * bk columns of T padded with zero rows; 0 when jmax < 0.
    csrc/flash_attention.cu's final pass writes exactly this."""
    bq, bk = min(bq, s), min(bk, t)
    nk = -(-t // bk)
    group = h // v.shape[1]
    rows = []
    for i in range(min(s, -q_offset)):
        hi = q_offset + (i // bq + 1) * bq - 1
        jmax = min(nk - 1, hi // bk)
        cols = (jmax + 1) * bk
        if jmax < 0:
            rows.append(np.zeros(v.shape[:2] + v.shape[3:], np.float64))
        else:
            rows.append(v[:, :, :min(t, cols)].astype(np.float64).sum(2) / cols)
    out = np.stack(rows, axis=2)                       # (B, KVH, rows, Dv)
    return np.repeat(out, group, axis=1)


@pytest.mark.parametrize("s,t,q_offset,bq,bk", [
    (8, 8, -4, 512, 512), (64, 512, -16, 512, 512), (128, 512, -100, 512, 512),
    (100, 300, -37, 32, 64), (80, 200, -40, 16, 64), (40, 96, -20, 16, 32)])
def test_rows_that_see_no_key_match_jax_and_the_rule(s, t, q_offset, bq, bk):
    """q_offset < 0: the plain version agrees with the JAX XLA path on the
    rows that see no key (and on the others), and those rows follow the
    closed-form rule that the kernel's final pass computes.  Some q blocks
    see no key at all (their rows are 0); the JAX path cannot run a call in
    which no q block sees a key, so every case keeps one that does."""
    arrs = _qkv(10 + s, 2, 4, 2, s, t, 32, 48)
    kw = dict(causal=True, q_offset=q_offset, bq=bq, bk=bk)
    out = flash_attention(*_t(*arrs), **kw).numpy()
    want = np.asarray(j_flash(*_j(*arrs), impl="xla", **kw))
    np.testing.assert_allclose(out, want, rtol=0, atol=F32_ATOL)
    rows = min(s, -q_offset)
    rule = _no_key_rows_rule(arrs[2], s, t, q_offset, 4, bq, bk)
    np.testing.assert_allclose(out[:, :, :rows], rule, rtol=0, atol=F32_ATOL)
    # bf16: both round the same f32 values
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    got = flash_attention(*bf, **kw).float().numpy()
    jwant = np.asarray(j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                               impl="xla", **kw).astype(jnp.float32))
    assert (np.abs(got - jwant) <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(jwant))
            + F32_ATOL).all()


# -- the bf16 tensor-core kernel reads q, k and v through TMA tensor maps ------
D = 128


@pytest.mark.parametrize("what,sizes,strides,base,ok", [
    ("contiguous (B, H, S, D)", (2, 16, 256, D), (16 * 256 * D, 256 * D, D, 1), 0, True),
    # the model's (B, S, H, D) -> (B, H, S, D) transpose
    ("transposed view", (2, 16, 256, D), (256 * 16 * D, D, 16 * D, 1), 0, True),
    ("a head of size one, any stride", (2, 1, 256, D), (256 * D, 7, D, 1), 0, True),
    ("rows D + 1 apart", (2, 2, 300, D), (2 * 300 * (D + 1), 300 * (D + 1), D + 1, 1), 0, False),
    ("base off by one element", (2, 2, 300, D), (2 * 300 * D, 300 * D, D, 1), 2, False),
    ("an expanded axis (stride 0)", (2, 16, 256, D), (256 * D, 0, D, 1), 0, False),
    ("last axis strided", (2, 2, 300, D), (2 * 300 * D * 2, 300 * D * 2, 2 * D, 2), 0, False),
])
def test_tma_describable(what, sizes, strides, base, ok):
    assert tma_describable(1024 + base, sizes, strides, 2) is ok, what


def test_tma_view_copies_only_what_no_map_describes():
    buf = torch.zeros(2, 2, 300, D + 1, dtype=torch.bfloat16)
    aligned = torch.zeros(2, 16, 300, D, dtype=torch.bfloat16)
    before = fa_module.CONTIGUOUS_COPIES
    assert tma_view(aligned) is aligned
    transposed = torch.zeros(2, 300, 16, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tma_view(transposed) is transposed
    assert fa_module.CONTIGUOUS_COPIES == before
    view = buf[..., :D]
    copied = tma_view(view)
    assert fa_module.CONTIGUOUS_COPIES == before + 1
    assert copied.is_contiguous() and torch.equal(copied, view)
    assert tma_describable(copied.data_ptr(), copied.shape, copied.stride(), 2)


def test_hubert_attention_needs_no_copy_for_the_tensor_maps(monkeypatch):
    """hubert-xlarge's q, k and v, as the model's attention builds them at
    full width (16 heads of 80, bf16, no rotary: each a (B, S, H, 80) ->
    (B, H, S, 80) transposed view of its projection), are views a tensor map
    describes: the tensor-core kernel reads them in place, no copy."""
    from repro_torch.configs import get as get_arch
    from repro_torch.models import attention
    cfg = get_arch("hubert-xlarge")
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    assert (hd, hd) in MMA_HEAD_DIMS and cfg.dtype == "bfloat16"
    rng = np.random.default_rng(4)
    p = {name: torch.from_numpy(rng.standard_normal((d, h * hd)).astype(
        np.float32) * d ** -0.5).to(torch.bfloat16)
        for name in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(rng.standard_normal((2, 24, d)).astype(np.float32))
    seen = []

    def capture(q, k, v, *, causal):
        seen.append((q, k, v, causal))
        return torch.zeros(q.shape[:3] + (v.shape[3],), dtype=q.dtype)

    monkeypatch.setattr(attention, "flash_attention", capture)
    attention.attend_full(p, x, cfg)
    ((q, k, v, causal),) = seen
    assert not causal
    before = fa_module.CONTIGUOUS_COPIES
    for t in (q, k, v):
        assert t.shape == (2, h, 24, hd) and t.dtype == torch.bfloat16
        assert not t.is_contiguous()                  # the transposed view
        assert tma_describable(t.data_ptr(), t.shape, t.stride(),
                               t.element_size())
        assert tma_view(t) is t
    assert fa_module.CONTIGUOUS_COPIES == before
