"""Plain PyTorch versions + structural work counts for decode attention.

Decode attends one new query per sequence against the full KV cache:
q (B, H, Dk) x k/v (B, KVH, T, D*) -> (B, H, Dv).  The partial-softmax form
(acc, m, l) combines seq-sharded shards (flash-decoding): each shard
reduces its KV slice, then shards merge with :func:`combine_partials`, an
exact algebraic identity.

These are the JAX package's ``kernels/decode_attention/ref.py``.  Its XLA
path (``ops.decode_attention`` off a TPU) is :func:`decode_attention_ref`
itself, so the ref functions are the kernel's plain versions: the wrapper
``ops.decode_attention`` runs them for CPU and ``meta`` tensors.  With a
row's ``lengths`` the plain version is :func:`decode_attention_masked_ref`,
the model's decode-step products (``models/attention.py:attend_decode``).
"""

from __future__ import annotations

import torch

from ...core.machine import WorkCounts
from ..flash_attention.ref import repeat_kv


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float | None = None) -> torch.Tensor:
    out, m, l = decode_attention_partial_ref(q, k, v, scale=scale)
    return (out / l).to(q.dtype)


def decode_attention_partial_ref(q, k, v, *, scale=None):
    """Unnormalized partial: returns (acc (B,H,Dv) f32, m (B,H,1), l (B,H,1))."""
    b, h, dk = q.shape
    kvh = k.shape[1]
    group = h // kvh
    k = repeat_kv(k, group)
    v = repeat_kv(v, group)
    scale = (dk ** -0.5) if scale is None else scale
    s = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bht,bhtd->bhd", p, v.float())
    return acc, m, l


#: the score of a masked key (the models' attention sentinel)
NEG_INF = -1e30


def _masked_scores(q, k, lengths, scale):
    """(B, KVH, G, T) f32 scaled scores of each row's keys ``[0,
    lengths[b])``, the sentinel elsewhere."""
    b, h, dk = q.shape
    kvh, t = k.shape[1], k.shape[2]
    scale = (dk ** -0.5) if scale is None else scale
    qd = q.reshape(b, kvh, h // kvh, dk)
    s = torch.matmul(qd.float(), k.float().transpose(-1, -2)) * scale
    valid = torch.arange(t, device=q.device) < lengths[:, None]   # (B, T)
    return torch.where(valid[:, None, None], s, NEG_INF)


def decode_attention_masked_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor, *,
                                scale: float | None = None,
                                out_dtype: torch.dtype | None = None
                                ) -> torch.Tensor:
    """Row b of q (B,H,Dk) attends to keys ``[0, lengths[b])`` of k/v
    (B,KVH,T,D*): the model's decode step as products (the JAX package's
    ``preferred_element_type=f32`` einsums over the cache dtype).  q, k and
    v share the cache dtype; both operands of each product are widened to
    f32 (a product of two bf16 values is exact in f32), and the softmax
    weights are rounded to the cache dtype before the weighted sum.
    Returns out (B,H,Dv) in ``out_dtype`` (default q's dtype)."""
    b, h, _ = q.shape
    s = _masked_scores(q, k, lengths, scale)                  # (B,KVH,G,T)
    m = s.amax(-1, keepdim=True)
    pexp = torch.exp(s - m)
    l = pexp.sum(-1, keepdim=True)
    o = torch.matmul(pexp.to(k.dtype).float(), v.float()) / l
    return o.reshape(b, h, v.shape[3]).to(out_dtype or q.dtype)


def decode_max_ref(q: torch.Tensor, k: torch.Tensor, lengths: torch.Tensor,
                   *, scale: float | None = None) -> torch.Tensor:
    """The T-sharded step's first pass over one shard's keys: each row's
    max scaled score ``(q . k) * scale`` over its keys ``[0, lengths[b])``
    of this shard, (B, H) f32, the sentinel -1e30 where it has none (a
    length of 0).  The scores are :func:`decode_attention_masked_ref`'s."""
    return _masked_scores(q, k, lengths, scale).amax(-1).reshape(
        q.shape[0], q.shape[1])


def decode_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, m: torch.Tensor, *,
                       scale: float | None = None):
    """The T-sharded step's second pass over one shard's keys, given each
    row's global max ``m`` (B, H) f32: ``p = exp(s - m)`` over the row's
    keys of the shard, -> (acc (B, H, Dv) f32, the sum of p rounded to the
    cache dtype times v; l (B, H) f32, the sum of p unrounded), as
    :func:`decode_attention_masked_ref` forms them.  A row with no key here
    gives zeros."""
    b, h, _ = q.shape
    kvh = k.shape[1]
    s = _masked_scores(q, k, lengths, scale)                  # (B,KVH,G,T)
    pexp = torch.exp(s - m.reshape(b, kvh, h // kvh, 1))
    acc = torch.matmul(pexp.to(k.dtype).float(), v.float())
    return acc.reshape(b, h, v.shape[3]), pexp.sum(-1).reshape(b, h)


def combine_shards(parts, out_dtype: torch.dtype) -> torch.Tensor:
    """The T-sharded step's combine: the shards' (acc, l) of
    :func:`decode_partial_ref` added in shard order, then ``acc / l``, in
    ``out_dtype``."""
    acc, l = parts[0]
    for acc2, l2 in parts[1:]:
        acc, l = acc + acc2, l + l2
    return (acc / l[..., None]).to(out_dtype)


def merge_partials(parts):
    """Merge [(acc, m, l), ...] partials from seq shards in their order into
    one unnormalized (acc, m, l)."""
    acc, m, l = parts[0]
    for acc2, m2, l2 in parts[1:]:
        mn = torch.maximum(m, m2)
        w1, w2 = torch.exp(m - mn), torch.exp(m2 - mn)
        acc = acc * w1 + acc2 * w2
        l = l * w1 + l2 * w2
        m = mn
    return acc, m, l


def combine_partials(parts):
    """Merge [(acc, m, l), ...] partials from seq shards — exact."""
    acc, m, l = merge_partials(parts)
    return acc / l, m, l


def decode_attention_split_ref(q, k, v, n_splits: int, keys_per_split: int, *,
                               scale=None, partial: bool = False):
    """The split scheme of the kernel in plain PyTorch: keys
    ``[i * keys_per_split, (i + 1) * keys_per_split)`` of split ``i`` reduce
    to their partial, and the splits merge in the order 0, 1, ...  Returns
    out (B,H,Dv) in q's dtype, or with ``partial=True`` the merged
    unnormalized (acc, m, l)."""
    t = k.shape[2]
    if n_splits < 1 or (n_splits - 1) * keys_per_split >= t or \
            n_splits * keys_per_split < t:
        raise ValueError(f"{n_splits} splits of {keys_per_split} keys do not "
                         f"cover T={t} without an empty split")
    parts = [decode_attention_partial_ref(
        q, k[:, :, i * keys_per_split:(i + 1) * keys_per_split],
        v[:, :, i * keys_per_split:(i + 1) * keys_per_split], scale=scale)
        for i in range(n_splits)]
    acc, m, l = merge_partials(parts)
    return (acc, m, l) if partial else (acc / l).to(q.dtype)


def counts(b: int, h: int, t: int, dk: int, dv: int,
           itemsize: int = 2) -> WorkCounts:
    macs = float(b) * h * t * (dk + dv)
    io = float(b) * t * (dk + dv) * itemsize      # the KV-cache read dominates
    return WorkCounts(ops=2.0 * macs, dcache_bytes=io, host_bytes=io,
                      working_set=io)
