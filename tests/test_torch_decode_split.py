"""The split plan of the port's decode-attention kernel and the plain
version of its split scheme, against the JAX package, on the CPU.

``plan_decode_splits`` decides how the card's kernel cuts T; the kernel
itself runs only on the card (``chip_smoke.py`` phase 2 holds it against
the plain versions there).  Here the plain version of the split scheme,
``decode_attention_split_ref`` (each split's partial, then the merge in the
order 0, 1, ...), takes the same numpy inputs, made from a seed, as the JAX
package's XLA path and its ``combine_partials`` over the same shards.

Tolerances, as in ``tests/test_torch_registry_kernels.py``: outputs of
magnitude about 1 within 2e-5 absolute (the same f32 softmax, summed in
another order); the unnormalized partials within 1e-5 of their largest
magnitude.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.decode_attention.ops import combine_partials as j_combine
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import \
    decode_attention_partial_ref as j_partial
from repro_torch.kernels.decode_attention.decode_attention import (
    KEY_TILE, MIN_KEYS_PER_SPLIT, PLAN_BATCH, plan_decode_splits)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_split_ref)

ATOL = 2e-5
PARTIAL_RTOL = 1e-5

# (b, kvh, t): qwen2.5-3b's decode shape, T = 1, a ragged T = 300 (MHA),
# T = 32768, one (batch, kv head) pair, and an MQA group of 16 heads (the
# plan reads kvh and t; b names the call the shape comes from)
PLAN_SHAPES = [(4, 2, 512), (4, 2, 1), (2, 8, 300), (4, 2, 32768),
               (1, 1, 4096), (2, 1, 1000)]


def _qkv(seed, b, h, kvh, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, kvh, t, d)).astype(np.float32),
            rng.standard_normal((b, kvh, t, d)).astype(np.float32))


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("b,kvh,t", PLAN_SHAPES)
def test_plan_covers_t_with_whole_tiles(b, kvh, t, sm_count):
    n, kps = plan_decode_splits(kvh, t, sm_count)
    assert n >= 1 and kps % KEY_TILE == 0
    starts = [i * kps for i in range(n)]
    ends = [min(t, s + kps) for s in starts]
    assert starts[0] == 0 and ends[-1] == t          # covers [0, t) exactly
    assert all(e > s for s, e in zip(starts, ends))  # no empty split
    assert all(ends[i] == starts[i + 1] for i in range(n - 1))
    if n > 1:
        assert kps >= MIN_KEYS_PER_SPLIT
    assert plan_decode_splits(kvh, t, sm_count) == (n, kps)
    if t < 2 * MIN_KEYS_PER_SPLIT:
        assert n == 1


@pytest.mark.parametrize("sm_count", [132, 114])
def test_plan_fills_the_card(sm_count):
    # qwen's decode shape: 2 kv heads get 8 splits of 64 keys (the floor),
    # 64 blocks at B = 4, 16 for one sequence
    assert plan_decode_splits(2, 512, sm_count) == (8, 64)
    # T = 32768: the plan's batch of 4 sequences fills the card, about two
    # blocks per SM (one sequence alone takes the same cut, a quarter of it)
    n, _ = plan_decode_splits(2, 32768, sm_count)
    assert 1.5 * sm_count <= n * 2 * PLAN_BATCH <= 3 * sm_count
    with pytest.raises(ValueError, match="positive"):
        plan_decode_splits(2, 0, sm_count)


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 16])
def test_plan_is_the_same_for_every_batch(batch):
    """The kernel's wrapper plans from (KVH, T, SM count) alone, so a row of
    a batched call is cut like the same row alone; the plain version of the
    split scheme then gives that row the same bits."""
    assert "b" not in inspect.signature(plan_decode_splits).parameters
    assert plan_decode_splits(2, 32768, 132) == (32, 1024)
    t, kvh = 300, 2
    n, kps = plan_decode_splits(kvh, t, 132)
    q, k, v = (torch.from_numpy(a) for a in _qkv(batch, batch, 8, kvh, t, 32))
    whole = decode_attention_split_ref(q, k, v, n, kps)
    for row in {0, batch - 1}:
        alone = decode_attention_split_ref(q[row:row + 1], k[row:row + 1],
                                           v[row:row + 1], n, kps)
        assert torch.equal(whole[row:row + 1], alone)


@pytest.mark.parametrize("b,h,kvh,t", [(4, 16, 2, 512), (2, 8, 8, 300),
                                       (1, 16, 1, 1000), (2, 4, 2, 1)])
def test_split_ref_matches_jax(b, h, kvh, t):
    arrs = _qkv(b + h + t, b, h, kvh, t, 32)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    want = np.asarray(j_decode(*(jnp.asarray(a) for a in arrs), impl="xla"))
    plans = {plan_decode_splits(kvh, t, sm) for sm in (132, 114)}
    plans.add((1, t))
    for n, kps in plans:
        got = decode_attention_split_ref(q, k, v, n, kps)
        assert got.shape == (b, h, 32) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), decode_attention(q, k, v).numpy(),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("t,n,kps", [(512, 8, 64), (300, 4, 96), (1000, 16, 64)])
def test_split_ref_partial_matches_jax_combine(t, n, kps):
    arrs = _qkv(t, 2, 8, 2, t, 64)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    acc, m, l = decode_attention_split_ref(q, k, v, n, kps, partial=True)
    assert acc.shape == (2, 8, 64) and m.shape == l.shape == (2, 8, 1)
    shards = [j_partial(*(jnp.asarray(x) for x in (
        arrs[0], arrs[1][:, :, i * kps:(i + 1) * kps],
        arrs[2][:, :, i * kps:(i + 1) * kps]))) for i in range(n)]
    jout, jm, jl = (np.asarray(x) for x in j_combine(shards))
    for got, want in ((acc / l, jout), (m, jm), (l, jl)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PARTIAL_RTOL * np.abs(want).max())
    # the merged triple is the whole cache's partial
    fa, fm, fl = decode_attention(q, k, v, partial=True)
    np.testing.assert_allclose(m.numpy(), fm.numpy(), rtol=0,
                               atol=PARTIAL_RTOL * fm.abs().max().item())
    np.testing.assert_allclose(acc.numpy(), fa.numpy(), rtol=0,
                               atol=PARTIAL_RTOL * fa.abs().max().item())
    np.testing.assert_allclose(l.numpy(), fl.numpy(), rtol=0,
                               atol=PARTIAL_RTOL * fl.abs().max().item())


def test_split_ref_rejects_a_plan_that_does_not_cover_t():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 1, 100, 8))
    for n, kps in ((1, 64), (3, 64), (0, 128)):
        with pytest.raises(ValueError, match="do not cover"):
            decode_attention_split_ref(q, k, v, n, kps)
