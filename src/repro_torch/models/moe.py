"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch.

The JAX package's ``models/moe.py`` in PyTorch, with its three sharding
constraints at its sites (groups on batch; the expert-major buffer and the
experts' outputs on ``"expert"``, the all-to-all boundary), which act under
sharding rules on DTensors and are no-ops on one device; there the routing,
dispatch and combine, all local to a group, run on each rank's groups
(``distributed.sharding.on_blocks``):

1. tokens are viewed as (groups, g, D), one routing group of ``g`` tokens
   each (a sequence in a prefill; one token per sequence in a decode step
   of fewer than 32 sequences);
2. per group: softmax router → top-k experts and weights per token;
3. **sort-based dispatch**: assignments are ordered by expert id; each
   token's position within its expert comes from a stable sort, and
   assignments beyond the per-expert capacity ``c`` are dropped (their
   combine weight is zeroed: GShard capacity semantics);
4. the kept rows land in an (E·c, D) buffer per group, each slot written
   once; dropped assignments go to a dummy row that is cut off;
5. the gated expert FFN runs as three batched products over the experts,
   (E, groups·c, D) @ (E, D, F), so each expert's weights are read once a
   call;
6. the combine gathers each token's k weighted rows and adds them in the
   order 0 .. k-1.

Every step is written so that its bits are the JAX layer's on the CPU and
do not depend on the device's choices, nor a token's on the batch it runs
in: the router's logits come from products of one fixed shape
(:data:`ROUTER_ROWS` token rows each, the last padded with zeros), so the
library picks one kernel for them at any batch (at deepseek-v2's width it
picks another for 256 rows than for 1536, and a logit can move by an ulp
and route the token elsewhere); the top k are the first k of a
*stable* descending sort (``jax.lax.top_k`` puts the lower index first
among equal values, and bf16 router logits tie often), expert counts are a
``scatter_add_`` of ones into ``zeros(E)`` (``bincount``'s length depends
on the data, which ``meta`` tensors cannot give), the dispatch writes each
kept slot once (``scatter_``, no accumulation, no atomics), and the combine
adds the k rows in a fixed order from zero, rounding each sum to the
compute dtype, as XLA's serial scatter-add does.  No ``nonzero`` and no
boolean-mask indexing: the layer runs on ``meta`` tensors.  Every index a
group's ops carry is local to its group, so a group's bits do not depend
on the other groups.

Aux losses: switch-style load balance and router z-loss, per group, then
averaged over the groups.  Shared experts (deepseek-v2: 2) run densely on
every token and add in.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..distributed.sharding import constrain, is_dtensor, on_blocks, whole_on
from .config import ModelConfig
from .layers import PRODUCT_ROWS, act_fn, cdtype, rows_matmul
from .params import ParamSpec, dense_spec

#: token rows of each router product (:func:`router_logits`)
ROUTER_ROWS = PRODUCT_ROWS


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def moe_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    e = cfg.n_experts
    ff = cfg.d_ff_expert or cfg.d_ff

    def expert_w(din, dout, axes):
        shape: Tuple[int, ...] = (e, din, dout)
        ax: Tuple = ("expert",) + axes
        if stacked:
            shape = (stacked,) + shape
            ax = ("layers",) + ax
        return ParamSpec(shape, ax, "normal", din ** -0.5)

    out = {
        "router": dense_spec(d, e, ("embed", None), stacked=stacked),
        "wi": expert_w(d, ff, ("embed", "mlp")),
        "wg": expert_w(d, ff, ("embed", "mlp")),
        "wo": expert_w(ff, d, ("mlp", "embed")),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        out["shared"] = {
            "wi": dense_spec(d, sff, ("embed", "mlp"), stacked=stacked),
            "wg": dense_spec(d, sff, ("embed", "mlp"), stacked=stacked),
            "wo": dense_spec(sff, d, ("mlp", "embed"), stacked=stacked),
        }
    return out


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Per-expert slots per routing group (a multiple of 8, as the JAX
    package pads for TPU tiling)."""
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


# ---------------------------------------------------------------------------
# Routing and combine (all groups at once, indices local to a group)
# ---------------------------------------------------------------------------
def router_logits(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """xg (n, g, D) @ router (D, E) -> (n, g, E), as products of
    :data:`ROUTER_ROWS` token rows each (the last chunk padded with zero
    rows), so a token's logits have the same bits in any batch."""
    return rows_matmul(xg, router)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (the first
    k of a stable descending sort; ``torch.topk`` orders no ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: ModelConfig, c: int, *,
          with_aux: bool = False):
    """logits (n, g, E) -> (slot (n, g·k), weight (n, g·k) f32, aux (n, 2)
    with ``with_aux``, else None).

    ``slot`` is each assignment's row in its group's (E·c + 1)-row buffer;
    ``slot == E·c`` marks a dropped assignment (the dummy row).  Assignment
    ``t·k + j`` is token ``t``'s j-th choice."""
    n, g, e = logits.shape
    k = cfg.top_k
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = top_k(probs, k)                               # (n, g, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(n, g * k)
    flat_w = top_w.reshape(n, g * k)
    # position within the expert via a stable sort by expert id
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((n, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = (torch.arange(g * k, device=dev)
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)

    kept = pos < c
    slot = torch.where(kept, flat_e * c + pos, e * c)
    weight = torch.where(kept, flat_w, 0.0)
    if not with_aux:
        return slot, weight, None

    # load-balance loss (Switch): E * sum_e fraction_tokens_e * mean_prob_e
    frac_tok = counts.float() / (g * k)
    mean_prob = probs.mean(dim=1)
    lb = e * (frac_tok * mean_prob).sum(-1)
    z = (torch.logsumexp(logits.float(), dim=-1) ** 2).mean(-1)
    return slot, weight, torch.stack([lb, z], dim=-1)


def dispatch(xg: torch.Tensor, slot: torch.Tensor, n_rows: int, k: int
             ) -> torch.Tensor:
    """xg (n, g, D) -> (n, n_rows, D): token ``t``'s row written to each of
    its assignments' slots (``t·k + j`` for choice j), each kept slot once;
    the dropped ones land in the last (dummy) row, which is cut off."""
    n, g, d = xg.shape
    tok = torch.arange(g, device=xg.device).repeat_interleave(k)  # (g·k,)
    rows = xg[:, tok]                                             # (n, g·k, D)
    buf = torch.zeros((n, n_rows + 1, d), dtype=xg.dtype, device=xg.device)
    buf.scatter_(1, slot[..., None].expand(n, g * k, d), rows)
    return buf[:, :-1]


def combine(y: torch.Tensor, slot: torch.Tensor, weight: torch.Tensor,
            k: int) -> torch.Tensor:
    """y (n, E·c, D) -> (n, g, D): each token's k expert rows times their
    weights (in y's dtype), added in the order 0 .. k-1 from zero."""
    n, _, d = y.shape
    yk = torch.cat([y, y.new_zeros((n, 1, d))], dim=1)
    gathered = torch.gather(yk, 1, slot[..., None].expand(n, slot.shape[1], d))
    gathered = gathered * weight[..., None].to(y.dtype)
    gathered = gathered.reshape(n, -1, k, d)
    out = y.new_zeros(gathered.shape[:2] + (d,))
    for j in range(k):
        out = out + gathered[:, :, j]
    return out


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------
def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, *,
              group_size: Optional[int] = None, with_aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux): with ``with_aux``, aux is (2,)
    f32 [load_balance, z], the mean over the groups; else None (the
    serving path reads no loss).

    ``group_size`` defaults to S (one routing group per sequence); B·S must
    be a multiple of it, as in the JAX layer's reshape."""
    b, s, d = x.shape
    e = cfg.n_experts
    dt = cdtype(cfg)
    g = group_size or s
    n = (b * s) // g
    if n * g != b * s:
        raise ValueError(f"{b * s} tokens do not split into groups of {g}")
    c = capacity(cfg, g)

    xg = constrain(x.reshape(n, g, d), "batch", None, None).to(dt)
    logits = router_logits(xg, p["router"].to(dt))                # (n, g, E)

    def route_dispatch(xg, logits):
        slot, weight, aux = route(logits, cfg, c, with_aux=with_aux)
        buf = dispatch(xg, slot, e * c, cfg.top_k)                # (n, E·c, D)
        return (buf, slot, weight) + ((aux,) if with_aux else ())

    if is_dtensor(xg, logits):
        # every index is local to its group: each rank routes its groups
        pg = whole_on(xg.placements, 1, 2)
        out = on_blocks(route_dispatch, (xg, logits), (pg, pg),
                        (pg,) * (4 if with_aux else 3))
    else:
        out = route_dispatch(xg, logits)
    buf, slot, weight = out[:3]
    aux = out[3] if with_aux else None
    # expert-major: (E, n·c, D), each expert's rows of every group together
    he = constrain(buf.reshape(n, e, c, d), "batch", "expert", None, None)
    he = he.transpose(0, 1).reshape(e, n * c, d)
    act = act_fn(cfg)
    hidden = act(torch.matmul(he, p["wg"].to(dt)))
    hidden = hidden * torch.matmul(he, p["wi"].to(dt))
    y_exp = torch.matmul(hidden, p["wo"].to(dt))                  # (E, n·c, D)
    y_exp = constrain(y_exp.reshape(e, n, c, d).transpose(0, 1), "batch",
                      "expert", None, None).reshape(n, e * c, d)
    if is_dtensor(y_exp):
        pg = whole_on(slot.placements, 1)          # groups as routed
        y = on_blocks(lambda *a: combine(*a, cfg.top_k),
                      (y_exp, slot, weight), (pg, pg, pg), pg)
    else:
        y = combine(y_exp, slot, weight, cfg.top_k)
    y = y.reshape(b, s, d)

    if cfg.n_shared_experts:
        sp = p["shared"]
        xd = x.to(dt)
        h = act(torch.matmul(xd, sp["wg"].to(dt)))
        h = h * torch.matmul(xd, sp["wi"].to(dt))
        y = y + torch.matmul(h, sp["wo"].to(dt))
    return y, (aux.mean(dim=0) if with_aux else None)
