"""Int8 gradient compression with error feedback, around the DP reduction.

The JAX package's ``distributed/compression.py``.  Gradients are quantized
to int8 with a per-tensor scale before the reduction and dequantized after,
the quantization residual carried forward as *error feedback* (Seide et
al.; the 1-bit Adam lineage), so the compression is unbiased over time.

* :func:`compress_int8` / :func:`decompress_int8` — the codec (+ error
  state), op for op the JAX package's: ``round`` half to even, a true
  division by the scale, ``maximum(amax / 127, 1e-20)``; so ``q``,
  ``scale`` and the new error equal JAX's bit for bit;
* :func:`compressed_psum` — the mean of a gradient tree over a mesh dim's
  process group on an int8 wire: each rank all-gathers its int8 payload
  and its f32 scale, then sums the dequantized parts in rank order and
  divides by n, returning the new error state.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.params import map_tree
from .sharding import active_mesh

INT8_MAX = 127.0


def compress_int8(g: torch.Tensor, err: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` to int8.  Returns (q, scale, new_err).

    ``scale`` is a 0-d f32 tensor (amax / 127); ``new_err`` the residual fed
    back into the next step's gradient."""
    gf = g.to(torch.float32)
    if err is not None:
        gf = gf + err
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp_min(amax / INT8_MAX, 1e-20)
    q = torch.clamp(torch.round(gf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _mean_int8(g: torch.Tensor, e: Optional[torch.Tensor], group
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, scale, new_e = compress_int8(g, e)
    n = dist.get_world_size(group)
    # the concatenated form of the gather (every backend takes it), viewed
    # as (N, ...) after
    all_q = torch.empty(n * q.numel(), dtype=q.dtype, device=q.device)
    all_s = torch.empty((n,), dtype=scale.dtype, device=scale.device)
    dist.all_gather_into_tensor(all_q, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(all_s, scale.reshape(1), group=group)
    all_q = all_q.view((n,) + tuple(q.shape))
    shaped = all_s.reshape((n,) + (1,) * q.dim())
    total = torch.sum(all_q.to(torch.float32) * shaped, dim=0)
    return total / n, new_e


def compressed_psum(grads, errs, axis_name: str = "data", mesh: Any = None):
    """Mean-reduce a gradient tree over the ``axis_name`` dim of ``mesh`` (a
    ``DeviceMesh``; default the mesh under
    :func:`~repro_torch.distributed.sharding.activate`) on an int8 wire.
    ``grads`` and ``errs`` (or None) are nested dicts of this rank's local
    tensors, or single tensors.  Returns (mean grads f32, new errs).

    Wire format: each participant quantizes (grad + error) to int8 with its
    own scale, all-gathers the int8 payload (+ f32 scales) and sums the
    dequantized contributions locally, in rank order.  For N participants
    this moves (N-1) int8 bytes per element where a ring all-reduce of f32
    moves 2 (N-1)/N x 4 bytes."""
    if mesh is None:
        mesh = active_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a DeviceMesh: pass mesh= or "
                         "call it under distributed.activate(rules, mesh)")
    group = mesh.get_group(axis_name)

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], None if e is None else e[k])
                     for k in sorted(g)}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return _mean_int8(g, e, group)

    return walk(grads, errs)


def init_error_state(grads):
    """Zero f32 error feedback shaped like ``grads``."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
