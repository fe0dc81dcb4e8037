"""The port's context-parallel attention and T-sharded decode, per shard
and on ranks.

* **The CP path on ranks**: on a (data=1, model=4) gloo mesh with the
  port's ``CP_MIN_SEQ`` set low in the ranks, a reduced config with 6 heads
  (which the axis of 4 does not divide) takes the context-parallel path,
  and its output and the gradients of x and of every weight equal the
  unsharded attention's within 1e-5 of their largest magnitude.
* **The per-shard call against JAX**, in this process: at the offsets a
  shard takes (``index * S_local >= 0``, and two that no block size
  divides), the port's ``flash_attention(causal=True, q_offset=)``, which
  the context-parallel path calls on each shard, and its gradients equal
  the JAX package's shard body, ``_xla_full(ql, kf, vf, scale, True,
  bk=512, q_offset=offset)``, and ``jax.grad`` of it within 1e-5 of max.  The plain two-pass decode
  (each shard's max with zero-length shards, the global max, the partials,
  the combine in shard order) equals ``decode_attention_masked_ref``
  unsplit: f32 within 1e-6 of max, bf16 within one ulp.
* **World-1 bits**: on a world-1 gloo mesh a reduced model's train step
  (under ``TRAIN_FSDP_RULES``) and prefill + decode step (under
  ``SERVE_RULES``) equal the unsharded ones bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import _xla_full
from repro_torch.kernels.decode_attention.ops import (
    combine_shards, decode_attention_masked_ref, decode_max, decode_partial)
from repro_torch.kernels.flash_attention.ops import flash_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401

WORLD_ONE_ARCHS = ("qwen2.5-3b", "deepseek-v2-236b")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The CP world and the world-1 runs, started together; the per-shard
    tests of this process overlap them."""
    groups = [(4, "context_parallel", (32, 16))]
    groups += [(1, "world_one", (arch,)) for arch in WORLD_ONE_ARCHS]
    collect = torch_ranks.start_groups(tmp_path_factory.mktemp("cp"), groups,
                                       timeout=240)
    box = {}

    def results():
        if not box:
            out = collect()
            box["cp"] = out[0][0]
            box.update({arch: r[0] for arch, r in
                        zip(WORLD_ONE_ARCHS, out[1:])})
        return box

    yield results
    results()                            # no rank outlives the module


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())


# ---------------------------------------------------------------------------
# per shard, against the JAX package (this process)
# ---------------------------------------------------------------------------
B, H, KVH, D, S_LOCAL, T = 1, 4, 2, 32, 256, 1024


def _shard_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S_LOCAL, D), np.float32)
    k = rng.standard_normal((B, KVH, T, D), np.float32)
    v = rng.standard_normal((B, KVH, T, D), np.float32)
    dy = rng.standard_normal((B, H, S_LOCAL, D), np.float32)
    return q, k, v, dy


@pytest.mark.parametrize("offset", [0, 256, 512, 768, 100, 640])
def test_shard_call_and_gradient_equal_the_jax_shard_body(ranks, offset):
    """Offsets 0 .. 768 are a 4-way split of T = 1024; 100 and 640 start a
    shard inside a key block (640 is 512 + 128: the JAX body's block of 512
    cut by the shard's first row)."""
    q, k, v, dy = _shard_inputs(7)
    scale = D ** -0.5

    def jax_loss(q, k, v):
        out = _xla_full(q, k, v, scale, True, bk=512, q_offset=offset)
        return jnp.sum(out * dy), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = flash_attention(*leaves, causal=True, scale=scale, q_offset=offset)
    (got * torch.from_numpy(dy)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5)
    for leaf, g in zip(leaves, grads):
        _close(leaf.grad.numpy(), g, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_decode_equals_the_unsplit_step(ranks, dtype):
    """qwen's step (B 4, H 16, KVH 2) on a cache of 512 split into 4
    T-blocks, lengths 257 .. 272: the last block holds no key of any
    row."""
    g = torch.Generator().manual_seed(3)
    b, h, kvh, t, d = 4, 16, 2, 512, 64
    q = torch.randn(b, h, d, generator=g).to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g).to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g).to(dtype)
    lengths = torch.tensor([257, 262, 266, 272])
    want = decode_attention_masked_ref(q, k, v, lengths)
    n, tl = 4, t // 4
    blocks = [(k[:, :, i * tl:(i + 1) * tl], v[:, :, i * tl:(i + 1) * tl],
               (lengths - i * tl).clamp(0, tl)) for i in range(n)]
    assert int(blocks[-1][2].max()) == 0
    maxima = [decode_max(q, kb, lb) for kb, _, lb in blocks]
    assert float(maxima[-1].max()) == float(np.float32(-1e30))
    m = torch.stack(maxima).amax(0)
    got = combine_shards([decode_partial(q, kb, vb, lb, m)
                          for kb, vb, lb in blocks], dtype)
    if dtype == torch.float32:
        _close(got.numpy(), want.numpy(), 1e-6)
    else:
        # one bf16 ulp of each output
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp(
            min=torch.finfo(torch.bfloat16).tiny)
        exp2 = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(
            min=1e-30))))
        assert ((got.float() - want.float()).abs()
                <= torch.finfo(torch.bfloat16).eps * exp2).all(), ulp.max()


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------
def test_context_parallel_path_on_4_ranks(ranks):
    got = ranks()["cp"]
    assert got["taken"] == [32], "the context-parallel path did not run"
    _close(*got["y"], 1e-5)
    _close(*got["dx"], 1e-5)
    for name, (a, b) in got["dw"].items():
        _close(a, b, 1e-5)


@pytest.mark.parametrize("arch", WORLD_ONE_ARCHS)
def test_world_one_mesh_is_bit_equal_to_unsharded(ranks, arch):
    got = ranks()[arch]
    assert got == {"loss": True, "grad_norm": True, "params": True,
                   "m": True, "v": True,
                   "prefill": True, "decode": True}, got


# ---------------------------------------------------------------------------
# the card paths' launches (recorded here: the kernels run only on the card)
# ---------------------------------------------------------------------------
def _record_launches(monkeypatch):
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ops as da_ops
    calls = []
    monkeypatch.setattr(da, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(da, "stream_of", lambda t: None)
    monkeypatch.setattr(da_ops, "on_card", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: type(
        "P", (), {"multi_processor_count": 132}))
    return calls


@pytest.mark.parametrize("t", [128, 4096])
def test_each_pass_is_one_launch_with_its_plan(monkeypatch, t):
    """The max pass and the partial pass each launch once, on the plan of
    the shard's T (which reads no batch size), with one ctypes type an
    argument; the partial pass passes the global max and asks for no
    split scratch when the plan gives one split."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        plan_decode_splits)
    calls = _record_launches(monkeypatch)
    b, h, kvh, d = 4, 16, 2, 128
    q = torch.zeros(b, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, kvh, t, d, dtype=torch.bfloat16)
    lengths = torch.tensor([0, 3, t, 1])
    m = decode_max(q, k, lengths)
    acc, l = decode_partial(q, k, k, lengths, m)
    assert m.shape == (b, h) and acc.shape == (b, h, d) and l.shape == (b, h)
    (mx, part) = calls
    n, kps = plan_decode_splits(kvh, t, 132)
    assert mx[:2] == ("decode_attention", "repro_decode_max_bf16")
    # name, symbol, types, q, k, lengths, mx_s, m, b, h, kvh, t, dk,
    # strides, scale, n_splits, kps, device, stream
    assert mx[8:13] == (b, h, kvh, t, d) and mx[15:17] == (n, kps)
    assert mx[7].value == m.data_ptr()
    # name, symbol, types, q, k, v, acc, m, l, acc_s, m_s, l_s, lengths,
    # gmax, b, h, kvh, t, dk, dv, strides, scale, n_splits, kps, ...
    assert part[:2] == ("decode_attention", "repro_decode_partial_bf16")
    assert part[14:20] == (b, h, kvh, t, d, d) and part[22:24] == (n, kps)
    assert (part[9].value is None) == (n == 1)      # split scratch
    assert part[13].value == m.data_ptr()           # the global max
    for args in calls:
        assert len(args[2]) == len(args) - 3        # one ctypes type an argument


def test_a_shard_before_key_zero_is_refused_on_the_card(monkeypatch):
    """On the card the differentiable call takes q_offset >= 0 (a
    context-parallel shard's offset always is; rows before key 0 would
    need the forward's no-key rule in the backward): a negative offset
    raises, it never falls back.  (D = 32 is a pair the backward is
    compiled for, so the offset alone is refused.)"""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_PAIRS)
    assert (D, D) in BWD_PAIRS
    monkeypatch.setattr(fa_ops, "on_card", lambda *t: True)
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in _shard_inputs(1))
    with pytest.raises(ValueError, match="q_offset >= 0; got .*q_offset=-256"):
        flash_attention(q, k, v, causal=True, scale=D ** -0.5,
                        q_offset=-256)
