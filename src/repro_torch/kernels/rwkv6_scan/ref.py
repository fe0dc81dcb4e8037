"""Plain PyTorch versions + structural work counts for the RWKV-6 WKV scan.

Per head with dims (D_k = D_v = D), data-dependent per-channel decay
w_t in (0, 1) and per-channel bonus u:

    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i, j] + k_t[i] * v_t[j]

* :func:`rwkv6_scan_ref` / :func:`rwkv6_step_ref` are the JAX package's
  oracle (``kernels/rwkv6_scan/ref.py``): the exact sequential scan, all
  math in f32.
* :func:`rwkv6_scan_plain` is the JAX package's XLA path
  (``kernels/rwkv6_scan/ops.py``: ``_chunk_body`` and the padding of
  ``rwkv6_scan``), the path JAX takes on every backend but a TPU and the
  one its serving path takes on every backend (it seeds the scan with a
  state): chunks of ``chunk`` steps in the log-decay form, every
  exponential <= 1, T padded with ``w = 1, k = 0``.  It sits beside the CUDA
  kernel (``csrc/rwkv6_scan.cu``): the wrapper ``ops.rwkv6_scan`` runs it
  for CPU and ``meta`` tensors.
* :func:`rwkv6_scan_bwd_plain` is the gradient of the plain version
  (autograd through it: the mirror of ``jax.grad`` of the XLA path), which
  sits beside the backward kernel (``csrc/rwkv6_scan_bwd.cu``).  Its dw, like
  ``jax.grad``'s, comes from differences of cumulative log-decays, and loses
  accuracy where w is small (ROADMAP.md queue 3);
  :func:`rwkv6_scan_seq_grad`, autograd through the sequential loop in a
  dtype the caller names (f64), is the yardstick there.
* :func:`counts` is the JAX package's, for the machine model.
"""

from __future__ import annotations

import torch

from ...core.machine import WorkCounts
from ..common import pad_dim


def rwkv6_scan_ref(r, k, v, w, u, state0=None):
    """r/k/v/w (B, H, T, D), u (H, D); returns (y (B,H,T,D), state (B,H,D,D)),
    both f32 (the JAX oracle casts y to its f32 copy of r's dtype).

    ``state0`` (B, H, D, D) seeds the recurrence (decode / chunk chaining).
    """
    f32 = torch.float32
    return _recurrence(*(x.to(f32) for x in (r, k, v, w, u)),
                       None if state0 is None else state0.to(f32))


def _recurrence(r, k, v, w, u, s=None):
    """The sequential scan in the dtype of its inputs: (y, final state)."""
    b, h, t, d = r.shape
    if s is None:
        s = torch.zeros((b, h, d, d), dtype=r.dtype, device=r.device)
    ys = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]       # (B, H, D, D)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, :, i],
                               s + u[None, :, :, None] * kv))
        s = w[:, :, i, :, None] * s + kv
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros((b, h, 0, d), dtype=r.dtype, device=r.device))
    return y, s


def rwkv6_step_ref(r, k, v, w, u, state):
    """Single decode step: r/k/v/w (B, H, D), state (B, H, D, D)."""
    y, s = rwkv6_scan_ref(r[:, :, None], k[:, :, None], v[:, :, None],
                          w[:, :, None], u, state)
    return y[:, :, 0], s


def counts(b: int, h: int, t: int, d: int, itemsize: int = 4) -> WorkCounts:
    # per step: kv outer (D^2), state update (2 D^2), readout (2 D^2)
    ops = 5.0 * b * h * t * d * d
    io = 4.0 * b * h * t * d * itemsize
    return WorkCounts(ops=ops, dcache_bytes=ops / 5 * itemsize,
                      host_bytes=io, working_set=b * h * d * d * itemsize)


def _chunk(s0, r, k, v, w, u, strict, eye):
    """One chunk of the log-decay form: r/k/v/w (B, H, C, D) f32, s0
    (B, H, D, D) -> (state after the chunk, y (B, H, C, D))."""
    lw = torch.cumsum(torch.log(w), dim=2)                    # <= 0
    lw_prev = lw - torch.log(w)                               # exclusive
    diff = lw_prev[:, :, :, None, :] - lw[:, :, None, :, :]   # (B,H,C,C,D)
    decay = torch.where(strict, torch.exp(torch.where(strict, diff, 0.0)), 0.0)
    a = torch.einsum("bhti,bhtsi,bhsi->bhts", r, decay, k)
    a_diag = torch.einsum("bhti,hi,bhti->bht", r, u, k)
    a = a + a_diag[..., None] * eye
    y = torch.einsum("bhts,bhsd->bhtd", a, v)
    y = y + torch.einsum("bhti,bhij->bhtj", r * torch.exp(lw_prev), s0)
    w_total = torch.exp(lw[:, :, -1])                         # (B, H, D)
    k_scaled = k * torch.exp(lw[:, :, -1:, :] - lw)
    s = (w_total[..., :, None] * s0
         + torch.einsum("bhti,bhtd->bhid", k_scaled, v))
    return s, y


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state0: torch.Tensor | None = None, *,
                     chunk: int = 32):
    """RWKV-6 WKV over a sequence: r/k/v/w (B,H,T,D), u (H,D), optional
    ``state0`` (B,H,D,D).  Returns (y (B,H,T,D) in r's dtype, final state
    (B,H,D,D) f32).  T is padded to the chunk size (w=1, k=0 padding is
    exact: it neither decays the state nor contributes outputs)."""
    b, h, t, d = r.shape
    f32 = torch.float32
    dev, dtype = r.device, r.dtype
    s = (torch.zeros((b, h, d, d), dtype=f32, device=dev) if state0 is None
         else state0.to(f32))
    if t == 0:
        return torch.zeros((b, h, 0, d), dtype=dtype, device=dev), s
    r, k, v = (pad_dim(x, 2, chunk) for x in (r.to(f32), k.to(f32), v.to(f32)))
    w = pad_dim(w.to(f32), 2, chunk, fill=1)
    ti = torch.arange(chunk, device=dev)[:, None]
    si = torch.arange(chunk, device=dev)[None, :]
    strict = (ti > si)[None, None, :, :, None]
    eye = (ti == si).to(f32)[None, None]
    uf = u.to(f32)
    ys = []
    for c0 in range(0, r.shape[2], chunk):
        part = slice(c0, c0 + chunk)
        s, y = _chunk(s, r[:, :, part], k[:, :, part], v[:, :, part],
                      w[:, :, part], uf, strict, eye)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :t].to(dtype), s


def _grads(fn, inputs, dy, dtype=None):
    """Autograd of ``fn(*inputs)[0]`` against ``dy``, the inputs taken in
    ``dtype`` (None: their own) -> one gradient per input."""
    with torch.enable_grad():
        leaves = [x.detach().to(dtype or x.dtype).requires_grad_()
                  for x in inputs]
        y = fn(*leaves)[0]
        return torch.autograd.grad(y, leaves, dy.to(y.dtype))


def rwkv6_scan_bwd_plain(r, k, v, w, u, dy, *, chunk: int = 32):
    """(dr, dk, dv, dw, du) of ``sum(y * dy)`` for ``y = rwkv6_scan_plain(r,
    k, v, w, u)[0]`` (no state in, no gradient into the final state), by
    autograd through the plain version: dr, dk, dv in their inputs' dtypes,
    dw and du in f32, as the kernel gives them."""
    dr, dk, dv, dw, du = _grads(
        lambda *x: rwkv6_scan_plain(*x, chunk=chunk), (r, k, v, w, u), dy)
    return dr, dk, dv, dw.float(), du.float()


def rwkv6_scan_seq_grad(r, k, v, w, u, dy, dtype=torch.float64):
    """(dr, dk, dv, dw, du), all in ``dtype``, by autograd through the
    sequential recurrence (``rwkv6_scan_ref``'s loop) run in ``dtype``: its
    dw is the product of running decays, exact to the dtype's rounding for
    any w, where the chunked log-decay form's is not."""
    return _grads(_recurrence, (r, k, v, w, u), dy, dtype)
