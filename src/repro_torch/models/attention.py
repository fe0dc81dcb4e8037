"""GQA/MQA/MHA attention block with rotary embedding and a KV cache.

The JAX package's ``models/attention.py`` in PyTorch, with one parameter
mapping shared by the call modes:

* :func:`attend_full`   — prefill over a whole sequence, through the
  flash-attention wrapper (the hand-written kernel on the card);
* :func:`attend_decode` — one new token against the cache, through the
  decode-attention wrapper (the hand-written kernel on the card; the JAX
  package's einsums on the CPU);
* cache init/update helpers used by the serving layer.

Projection weights keep *flattened* head dims — (d_model, H*hd) — as in
the JAX package.

Under sharding rules on a ``DeviceMesh`` (``distributed.sharding.activate``)
the tensors are DTensors and the JAX package's ``constrain`` hooks sit at
its sites: q before the flash call, the cache on ``kv_seq`` in the decode
step.  Two paths are the distributed ones: causal attention at
``CP_MIN_SEQ`` keys or more whose heads the ``model`` axis does not divide
runs context-parallel (:func:`_context_parallel_attention`), and a decode
step whose cache is split on T takes each shard's partial sums
(:func:`_t_sharded_decode`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..distributed import sharding
from ..distributed.sharding import (active_axis_size, block_of, constrain,
                                    is_dtensor, on_blocks, placements_for,
                                    remap, replicated, spec_for, whole_on)
from ..kernels.decode_attention.ops import (combine_shards, decode_attention,
                                            decode_max, decode_partial)
from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .layers import apply_rotary, cdtype, rows_matmul
from .params import ParamSpec, dense_spec, state_device


def _context_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Causal attention with q sequence-sharded over the ``model`` axis
    (the JAX package's ``_context_parallel_attention``): for archs whose
    head count the model axis does not divide, q's S is split over
    ``model`` (batch as the rules place it), k and v are gathered once a
    layer (whole on S and heads), and each shard runs its rows with
    ``q_offset = index * S_local`` through ``flash_attention`` (the flash
    kernels on the card, forward and backward; the plain version on the
    CPU).  Every shard's offset is >= 0, so each row sees key 0 and the
    no-key rule never applies.  The output comes back in q's placement."""
    mesh = q.device_mesh
    b, _, _, d = q.shape
    batch = spec_for(("batch",), shape=(b,))
    bspec = batch[0] if len(batch) else None
    pq = placements_for(sharding.P(bspec, None, "model", None), mesh)
    pk = placements_for(sharding.P(bspec), mesh)
    index = mesh.get_local_rank("model")

    def body(ql, kl, vl):
        return flash_attention(ql, kl, vl, causal=True, scale=d ** -0.5,
                               q_offset=index * ql.shape[2])

    return on_blocks(body, (q, k, v), (pq, pk, pk), pq)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": dense_spec(d, h * hd, ("embed", "heads"), stacked=stacked),
        "wk": dense_spec(d, kvh * hd, ("embed", "kv"), stacked=stacked),
        "wv": dense_spec(d, kvh * hd, ("embed", "kv"), stacked=stacked),
        "wo": dense_spec(h * hd, d, ("heads", "embed"), stacked=stacked),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            shape = (stacked, width) if stacked else (width,)
            axes = (("layers", "heads") if name == "bq" else ("layers", "kv")
                    ) if stacked else (("heads",) if name == "bq" else ("kv",))
            out[name] = ParamSpec(shape, axes, "zeros")
    return out


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., H*hd) -> (..., H, hd).  A DTensor whose flattened head axis is
    split over more blocks than ``h`` divides into (a part of a head on a
    rank, as GSPMD lays out a flattened axis) is first gathered on that
    axis: a view cannot cut a head."""
    if is_dtensor(x):
        _, parts = block_of(x.device_mesh, x.placements, x.dim() - 1)
        if h % parts:
            x = x.redistribute(placements=whole_on(x.placements,
                                                   x.dim() - 1))
    return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)


class _MergeHeads(torch.autograd.Function):
    """(..., H, hd) -> (..., H*hd), whose gradient goes back through
    :func:`split_heads` (a DTensor gradient split on the flattened axis
    where H does not divide is gathered before the view)."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[-2]
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H*hd) (the inverse of :func:`split_heads`,
    for DTensors too)."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, H, S, hd), k/v (B, KVH, S, hd), rotary applied.
    q and k come out contiguous; v is a transposed view (the kernel takes
    strides).  The kv projections, narrow beside d_model, run on fixed row
    chunks (:func:`~repro_torch.models.layers.rows_matmul`), so a token's
    keys and values do not depend on its batch."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cdtype(cfg)
    xd = x.to(dt)
    xq = torch.matmul(xd, p["wq"].to(dt))
    xk = rows_matmul(xd, p["wk"].to(dt))
    xv = rows_matmul(xd, p["wv"].to(dt))
    if cfg.qkv_bias:
        xq = xq + p["bq"].to(dt)
        xk = xk + p["bk"].to(dt)
        xv = xv + p["bv"].to(dt)
    q = split_heads(xq, h).transpose(1, 2)
    k = split_heads(xk, kvh).transpose(1, 2)
    v = split_heads(xv, kvh).transpose(1, 2)
    if not cfg.is_encoder:   # encoders use additive positions at embed time
        q = apply_rotary(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rotary(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def attend_full(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """(B, S, D) -> (B, S, D); optionally also the (k, v) for cache build."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    causal = cfg.causal and not cfg.is_encoder
    model_tp = active_axis_size("model")
    if (causal and s >= sharding.CP_MIN_SEQ and model_tp > 1
            and cfg.n_heads % model_tp != 0 and is_dtensor(q)):
        # context parallelism for non-head-divisible archs at long seq
        out = _context_parallel_attention(q, k, v)
    else:
        q = constrain(q, "batch", "heads", "seq", None)
        out = flash_attention(q, k, v, causal=causal)
    out = merge_heads(out.transpose(1, 2))
    dt = cdtype(cfg)
    y = torch.matmul(out.to(dt), p["wo"].to(dt))
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zero k and v (B, KVH, max_len, hd) on ``device`` (default: the card)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, kvh, max_len, hd)
    device = state_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


def cache_from_prefill(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       max_len: int, dtype=torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Pad prefill (B, KVH, S, hd) K/V out to max_len cache arrays (under
    sharding rules, split on T as the decode step's ``constrain`` places
    them)."""
    b, kvh, s, hd = k.shape
    if is_dtensor(k, v):
        return {name: constrain(pad_rows(x.to(dtype), 2, max_len),
                                "batch", None, "kv_seq", None)
                for name, x in (("k", k), ("v", v))}
    cache = init_kv_cache(cfg, b, max_len, dtype, k.device)
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    return cache


# ---------------------------------------------------------------------------
# Decode (one token per sequence)
# ---------------------------------------------------------------------------
def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` as a (B,) int64 tensor on ``device``: an ``int`` is the same
    position for every row (spread without a host read); a (B,) tensor is
    one position per row."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            return pos.to(device=device, dtype=torch.int64).expand(batch)
        if tuple(pos.shape) != (batch,):
            raise ValueError(f"positions {tuple(pos.shape)} for a batch of "
                             f"{batch}: pass an int or a ({batch},) tensor")
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def pad_rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``n`` (a cache
    padded out to ``max_len``, DTensors too)."""
    shape = list(x.shape)
    shape[dim] = n - shape[dim]
    zeros = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([x, replicated(zeros, x)], dim=dim)


def write_at(cache: torch.Tensor, new: torch.Tensor, at: torch.Tensor,
             dim: int) -> None:
    """``cache[b, ..., at[b], ...] = new[b]`` along ``dim`` (1 or 2), in
    place: the decode step's write of each row's new key.  A cache split on
    that dim (a DTensor) is written on each rank's block, at the positions
    that fall in it; no position is read on the host."""
    rows = torch.arange(cache.shape[0], device=at.device)
    if not is_dtensor(cache):
        index = (rows, at) if dim == 1 else (rows, slice(None), at)
        cache[index] = new
        return
    pc = cache.placements
    lo_block, _ = block_of(cache.device_mesh, pc, dim)
    pb = remap(pc, {0: 0})

    def body(c, n, a):
        t = c.shape[dim]
        local = a - lo_block * t
        inside = (local >= 0) & (local < t)
        local = local.clamp(0, t - 1)
        r = torch.arange(c.shape[0], device=a.device)
        index = (r, local) if dim == 1 else (r, slice(None), local)
        keep = inside.reshape((-1,) + (1,) * (n.dim() - 1))
        c[index] = torch.where(keep, n, c[index])
        return c

    on_blocks(body, (cache, new, at), (pc, pb, pb), pc)


def _t_sharded_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, scale: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The decode step against a cache split on T (DTensors), as the JAX
    model's GSPMD partial reductions compute it: on each shard the max
    pass over its keys (row lengths local to the shard, 0 where it holds
    none of a row's keys), an all-reduce of the maxima over the T axis, the
    partial pass from that global max, then the shards' f32 (acc, l)
    gathered and added in shard order (bits that no arrival order
    changes), and ``acc / l``.  A cache whose T lies in one block (a world
    of 1, or ``kv_seq`` pruned) takes the single ``lengths`` call."""
    mesh = k.device_mesh
    pc = k.placements
    index, parts = block_of(mesh, pc, 2)
    if parts == 1:
        return decode_attention(q, k, v, scale=scale, lengths=lengths,
                                out_dtype=out_dtype)
    t_dims = [i for i, pl in enumerate(pc) if getattr(pl, "dim", None) == 2]
    if len(t_dims) != 1:
        raise ValueError(f"a decode cache split on T over {len(t_dims)} "
                         f"mesh axes; the step takes one")
    group = mesh.get_group(t_dims[0])
    pb = remap(pc, {0: 0})

    def body(ql, kl, vl, ln):
        t = kl.shape[2]
        local = (ln - index * t).clamp(0, t)
        m = decode_max(ql, kl, local, scale=scale)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        acc, l = decode_partial(ql, kl, vl, local, m, scale=scale)
        accs = [torch.empty_like(acc) for _ in range(parts)]
        ls = [torch.empty_like(l) for _ in range(parts)]
        dist.all_gather(accs, acc, group=group)
        dist.all_gather(ls, l, group=group)
        return combine_shards(list(zip(accs, ls)), out_dtype)

    return on_blocks(body, (q, k, v, lengths), (pb, pc, pc, pb), pb)


def attend_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos,
                  cfg: ModelConfig):
    """x (B, 1, D) + cache at absolute position ``pos``: an ``int`` for the
    whole batch or a (B,) int tensor, one position per row (the decode
    engine's slots sit at different positions).

    Returns (y (B, 1, D), cache).  Each row's new K/V is written into the
    cache **in place** (the JAX package returns an updated copy; writing in
    place spares a copy of the whole cache per layer and step), at its
    position clamped into [0, max_len - 1] as ``jax.lax.dynamic_update_slice``
    clamps it, and each row attends to every cache position ``<=`` its own.
    The step reads no position on the host, so it runs on ``meta`` tensors
    at capture.  An ``int`` goes through the same arithmetic as a tensor.

    The attention itself is the decode-attention kernel on the card
    (``kernels/decode_attention``), each row limited to its keys ``[0, pos
    + 1)`` by ``lengths``; its split plan reads no batch size and every sum
    has a fixed order, so a row gets the same bits in any batch, and it
    computes the step's weights (from the row's global max, rounded to the
    cache dtype before the weighted sum).  q goes in the cache dtype.  On the CPU (and on ``meta``) the wrapper runs the
    step's products (:func:`~repro_torch.kernels.decode_attention.ref.
    decode_attention_masked_ref`): the scores and the weighted sum read the
    bf16 cache with f32 accumulation, as the JAX package's
    ``preferred_element_type=f32`` einsums do (q and the softmax weights
    rounded to the cache dtype first, then both operands of each product
    widened to f32: a product of two bf16 values is exact in f32, so only
    the order of the sums differs from XLA's).
    """
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    pos = replicated(_row_positions(pos, b, x.device), x)       # (B,)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])

    # the cache is written in place: its constraint (the JAX package's,
    # after its write) comes first, a no-op on a cache the prefill placed
    k_cache = constrain(cache["k"], "batch", None, "kv_seq", None)
    v_cache = constrain(cache["v"], "batch", None, "kv_seq", None)
    dtype = k_cache.dtype
    t = k_cache.shape[2]
    at = pos.clamp(0, t - 1)
    write_at(k_cache, k_new[:, :, 0].to(dtype), at, 2)
    write_at(v_cache, v_new[:, :, 0].to(dtype), at, 2)

    dt = cdtype(cfg)
    qd = q[:, :, 0].to(dtype)
    if is_dtensor(k_cache):
        o = _t_sharded_decode(qd, k_cache, v_cache, at + 1, hd ** -0.5, dt)
    else:
        o = decode_attention(qd, k_cache, v_cache, scale=hd ** -0.5,
                             lengths=at + 1, out_dtype=dt)
    o = o.reshape(b, 1, h * hd)
    y = torch.matmul(o.to(dt), p["wo"].to(dt))
    return y, dict(cache, k=k_cache, v=v_cache)
