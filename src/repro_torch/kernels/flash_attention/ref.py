"""Plain PyTorch versions + structural work counts for fused attention.

Layout convention across the repo: q (B, H, S, Dk), k (B, KVH, T, Dk),
v (B, KVH, T, Dv) with grouped-query sharing (KVH divides H).  Dk and Dv may
differ (MLA uses Dk = 192 = nope 128 + rope 64 against Dv = 128).

* :func:`flash_attention_plain` is the JAX package's XLA path
  (``kernels/flash_attention/ops.py``: ``_causal_pairs``, ``_block``,
  ``_merge``, ``_xla_causal``, ``_xla_full``), the path JAX takes on every
  backend but a TPU: blocked online softmax in f32 with the -1e30 sentinel,
  causal blocks visited in the static (q-chunk, kv-chunk) pair list, the
  non-causal case as a scan over kv chunks.  It sits beside the CUDA kernel
  (``csrc/flash_attention.cu``): the wrapper ``ops.flash_attention`` runs it
  for CPU and ``meta`` tensors.
* :func:`flash_attention_bwd_plain` is its gradient by autograd (the
  plain version of ``csrc/flash_attention_bwd.cu``).
* :func:`mha_ref` is the plain softmax oracle, with -inf masking: a row
  that is wholly masked gives NaN there (the sentinel versions give 0).
* :func:`counts` is the JAX package's, for the machine model.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...core.machine import WorkCounts
from ..common import pad_dim

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, KVH, T, D) -> (B, KVH * group, T, D) by repeating each kv head."""
    if group == 1:
        return x
    b, kvh, t, d = x.shape
    return x[:, :, None].expand(b, kvh, group, t, d).reshape(
        b, kvh * group, t, d)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: float | None = None,
            q_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention oracle (f32 softmax).

    ``q_offset`` is the absolute position of q[…, 0, :] — used when q is a
    suffix of a longer sequence (decode / chunked prefill): causal masking
    compares (q_offset + i) >= j.
    """
    b, h, s, dk = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group = h // kvh
    k = repeat_kv(k, group)
    v = repeat_kv(v, group)
    scale = (dk ** -0.5) if scale is None else scale
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        qi = q_offset + torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(qi < kj, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def counts(b: int, h: int, s: int, t: int, dk: int, dv: int,
           causal: bool = True, itemsize: int = 2) -> WorkCounts:
    frac = 0.5 if causal and s == t else 1.0
    macs = b * h * s * t * (dk + dv) * frac
    io = b * (h * s * (dk + dv) + h * s * dv) * itemsize
    return WorkCounts(ops=2.0 * macs, dcache_bytes=2.0 * macs * itemsize / 8,
                      host_bytes=io, working_set=io)


# ---------------------------------------------------------------------------
# The blocked online-softmax path (the JAX package's XLA path)
# ---------------------------------------------------------------------------
def causal_pairs(nq: int, nk: int, bq: int, bk: int,
                 q_offset: int) -> List[Tuple[int, int]]:
    """Static (i, j) kv-visibility pairs for causal chunked attention."""
    pairs = []
    for i in range(nq):
        hi = q_offset + (i + 1) * bq - 1          # last absolute q row
        jmax = min(nk - 1, hi // bk)
        pairs.extend((i, j) for j in range(jmax + 1))
    return pairs


def _block(q, k, v, scale, causal, qi0, kj0, bq, bk):
    """One online-softmax block: returns (m, l, acc) contributions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = qi0 + torch.arange(bq, device=q.device)[:, None]
        kj = kj0 + torch.arange(bk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m, l, acc


def _merge(m0, l0, a0, m1, l1, a1):
    m = torch.maximum(m0, m1)
    w0 = torch.exp(m0 - m)
    w1 = torch.exp(m1 - m)
    return m, l0 * w0 + l1 * w1, a0 * w0 + a1 * w1


def _state(q: torch.Tensor, dv: int):
    b, h, s, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full((b, h, s, 1), NEG_INF, **f32),
            torch.zeros((b, h, s, 1), **f32), torch.zeros((b, h, s, dv), **f32))


def _causal(q, k, v, scale, bq, bk, q_offset):
    """The JAX path's pair scan, with each q block's (m, l, acc) rebound per
    merge instead of written into full-sequence buffers: the same merges in
    the same order (the same bits), and nothing that autograd saved is
    modified in place."""
    s, t = q.shape[2], k.shape[2]
    cols_of: List[List[int]] = [[] for _ in range(s // bq)]
    for i, j in causal_pairs(s // bq, t // bk, bq, bk, q_offset):
        cols_of[i].append(j)
    out = []
    for i, js in enumerate(cols_of):
        rows = slice(i * bq, (i + 1) * bq)
        m, l, acc = _state(q[:, :, rows], v.shape[3])
        for j in js:
            cols = slice(j * bk, (j + 1) * bk)
            mb, lb, ab = _block(q[:, :, rows], k[:, :, cols], v[:, :, cols],
                                scale, True, q_offset + i * bq, j * bk, bq, bk)
            m, l, acc = _merge(m, l, acc, mb, lb, ab)
        out.append(acc / torch.where(l == 0.0, 1.0, l))
    return torch.cat(out, dim=2)


def _full(q, k, v, scale, causal, bk, q_offset):
    s, t = q.shape[2], k.shape[2]
    m_all, l_all, acc_all = _state(q, v.shape[3])
    for j in range(t // bk):
        cols = slice(j * bk, (j + 1) * bk)
        mb, lb, ab = _block(q, k[:, :, cols], v[:, :, cols], scale, causal,
                            q_offset, j * bk, s, bk)
        m_all, l_all, acc_all = _merge(m_all, l_all, acc_all, mb, lb, ab)
    return acc_all / torch.where(l_all == 0.0, 1.0, l_all)


def block_sizes(s: int, t: int, bq: int, bk: int, causal: bool) -> Tuple[int, int]:
    """The blocks the JAX package's XLA path uses, ``min(bq, S)`` and
    ``min(bk, T)``; raises the JAX wrapper's ``ValueError`` for non-causal
    attention whose kv block does not divide T."""
    bq_, bk_ = min(bq, s), min(bk, t)
    if not causal and t % bk_:
        raise ValueError("non-causal attention requires T % bk == 0 "
                         f"(T={t}, bk={bk_}) — pick a dividing block")
    return bq_, bk_


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          q_offset: int = 0, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """q (B,H,S,Dk), k (B,KVH,T,Dk), v (B,KVH,T,Dv) -> (B,H,S,Dv) in q's
    dtype.  S is padded up to a multiple of the q block and T of the kv
    block; padded kv columns lie above the diagonal of every real q row
    under causal masking, and non-causal attention needs a dividing block."""
    s, dk = q.shape[2], q.shape[3]
    t = k.shape[2]
    scale = (dk ** -0.5) if scale is None else scale
    bq_, bk_ = block_sizes(s, t, bq, bk, causal)
    group = q.shape[1] // k.shape[1]
    qp = pad_dim(q, 2, bq_)
    kp = repeat_kv(pad_dim(k, 2, bk_), group)
    vp = repeat_kv(pad_dim(v, 2, bk_), group)
    if causal:
        out = _causal(qp, kp, vp, scale, bq_, bk_, q_offset)
    else:
        out = _full(qp, kp, vp, scale, False, bk_, q_offset)
    return out[:, :, :s].to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, scale: float | None = None,
                              q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain` (at ``q_offset``) for
    the output's gradient ``dout``, by autograd through it: the JAX
    package's gradient of its XLA path, and the backward kernel's plain
    version."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, scale=scale,
                                    q_offset=q_offset)
        return torch.autograd.grad(out, leaves, dout)
