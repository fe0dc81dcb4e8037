"""Plain PyTorch versions + structural work counts for the Mamba (S6) scan.

Diagonal state-space recurrence per channel d with state size N:

    h_t = exp(delta_t * A) * h_{t-1} + delta_t * x_t * B_t      (d, N)
    y_t = C_t . h_t + D * x_t                                    (d,)

* :func:`mamba_scan_ref` / :func:`mamba_step_ref` are the JAX package's
  oracle (``kernels/mamba_scan/ref.py``): the exact sequential scan.
* :func:`mamba_scan_plain` is the JAX package's XLA path without the skip
  term (``kernels/mamba_scan/ops.py``: ``_chunked_assoc`` and the padding
  of ``mamba_scan``): chunks of ``chunk`` steps carrying the (B, Dm, N)
  state, an associative scan inside each chunk, T padded with delta = 0
  (an identity step).  It computes what the CUDA kernel
  (``csrc/mamba_scan.cu``) computes; the wrapper ``ops.mamba_scan`` runs it
  for CPU and ``meta`` tensors and adds the skip term on every device.
* :func:`counts` is the JAX package's, for the machine model.
"""

from __future__ import annotations

import torch

from ...core.machine import WorkCounts
from ..common import pad_dim


def mamba_scan_ref(x, delta, a, b, c, d, state0=None):
    """x/delta (B, T, Dm), a (Dm, N), b/c (B, T, N), d (Dm,).

    Returns (y (B, T, Dm), final state (B, Dm, N)), both f32 (the JAX
    oracle casts y to its f32 copy of x's dtype).
    """
    bsz, t, dm = x.shape
    n = a.shape[1]
    f32 = torch.float32
    x, delta, b, c = (z.to(f32) for z in (x, delta, b, c))
    a = a.to(f32)
    h = (torch.zeros((bsz, dm, n), dtype=f32, device=x.device)
         if state0 is None else state0.to(f32))
    ys = []
    for i in range(t):
        da = torch.exp(delta[:, i, :, None] * a[None])        # (B, Dm, N)
        inc = (delta[:, i] * x[:, i])[..., None] * b[:, i, None, :]
        h = da * h + inc
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, i]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((bsz, 0, dm), dtype=f32, device=x.device))
    return y + x * d[None, None].to(f32), h


def mamba_step_ref(x, delta, a, b, c, d, state):
    """Single decode step: x/delta (B, Dm), b/c (B, N), state (B, Dm, N)."""
    y, h = mamba_scan_ref(x[:, None], delta[:, None], a, b[:, None],
                          c[:, None], d, state)
    return y[:, 0], h


def counts(bsz: int, t: int, dm: int, n: int, itemsize: int = 4) -> WorkCounts:
    # per step per channel: exp+mul (2N), increment (2N), readout (2N)
    ops = 6.0 * bsz * t * dm * n
    io = (2.0 * bsz * t * dm + 2.0 * bsz * t * n) * itemsize
    return WorkCounts(ops=ops, dcache_bytes=ops / 3 * itemsize,
                      host_bytes=io, working_set=bsz * dm * n * itemsize)


def _assoc_scan(da: torch.Tensor, inc: torch.Tensor, dim: int):
    """Inclusive scan of h_t = da_t * h_{t-1} + inc_t along ``dim``: the
    pairs (da, inc) under ``(pa, pb) . (qa, qb) = (pa qa, qb + qa pb)``,
    combined by doubling (log2 of the length rounds)."""
    n = da.shape[dim]
    step = 1
    while step < n:
        head = [slice(None)] * da.dim()
        head[dim] = slice(step, None)
        tail = [slice(None)] * da.dim()
        tail[dim] = slice(0, n - step)
        qa, qb = da[tuple(head)], inc[tuple(head)]
        pa, pb = da[tuple(tail)], inc[tuple(tail)]
        keep = [slice(None)] * da.dim()
        keep[dim] = slice(0, step)
        da = torch.cat([da[tuple(keep)], pa * qa], dim=dim)
        inc = torch.cat([inc[tuple(keep)], qb + qa * pb], dim=dim)
        step *= 2
    return da, inc


def mamba_scan_plain(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor,
                     state0: torch.Tensor | None = None, *, chunk: int = 64):
    """Selective scan without the skip term: x/delta (B,T,Dm), a (Dm,N),
    b/c (B,T,N), optional ``state0`` (B,Dm,N).  Returns (y (B,T,Dm) in x's
    dtype, final state (B,Dm,N) f32)."""
    f32 = torch.float32
    bsz, t, dm = x.shape
    n = a.shape[1]
    a32 = a.to(f32)
    h = (torch.zeros((bsz, dm, n), dtype=f32, device=x.device)
         if state0 is None else state0.to(f32))
    xp, dp, bp, cp = (pad_dim(z, 1, chunk) for z in (x, delta, b, c))
    ys = []
    for c0 in range(0, xp.shape[1], chunk):
        part = slice(c0, c0 + chunk)
        xc, dtc, bc, cc = (z[:, part].to(f32) for z in (xp, dp, bp, cp))
        da = torch.exp(dtc[..., None] * a32[None, None])      # (B, C, Dm, N)
        inc = (dtc * xc)[..., None] * bc[:, :, None, :]
        inc = torch.cat([inc[:, :1] + da[:, :1] * h[:, None], inc[:, 1:]],
                        dim=1)                                # fold carry in
        _, hc = _assoc_scan(da, inc, dim=1)
        # the readout as products summed over N per (row, step, channel):
        # an einsum here lowers to a bmm whose blocking follows the batch
        ys.append((hc * cc[:, :, None, :]).sum(-1))
        h = hc[:, -1]
    y = (torch.cat(ys, dim=1)[:, :t] if ys
         else torch.zeros((bsz, 0, dm), dtype=f32, device=x.device))
    return y.to(x.dtype), h
