"""The algorithm of the port's RWKV-6 backward kernel, in plain PyTorch,
against the JAX package's gradient and the exact one, on the CPU.

``csrc/rwkv6_scan_bwd.cu`` runs only on the card (``chip_smoke.py`` phase
2 holds it against the plain backward and the float64 sequential gradient
there).  What can be checked here is its algorithm, the forward's chunked
form run backwards, chunks of ``kC`` steps:

* a forward sweep of the chunked state update, keeping the state before
  every chunk (S0);
* then, chunk by chunk from the last, with G_end = dL/dS after the chunk's
  last step (zero for the last chunk): the products B = V dY^T,
  P1 = dY S0^T, P2 = V G_end^T and c_i = <S0_i, G_end,i>;
  dv = (k Q) G_end + A^T dY; the carry dL/dS0 = P_C G_end + (r P_prev)^T dY;
* and per channel i three running recurrences whose every factor is a
  decay in [0, 1], each channel's steps dealt over kThreadsPerChannel
  parts:
  Y[q] = (S_{t-1} dy_q)_i, ascending in t, gives dr_t = Y[t] + u k_t B[t, t];
  H[s] = (G_t v_s)_i and U = <G_t,i, S0_i>, descending in t, give
  dk_t = H[t] + u r_t B[t, t] and
  dw_t = P_prev,t U + sum_{s<t} (prod_{s<q<t} w_q) k_s H[s],
  each part holding kC / kP consecutive steps: a part whose steps all lie
  below t adds prod_{b0+kM<=q<t} w_q sum_m (k_s prod_{s<q<b0+kM} w_q) H[s],
  the part that holds t walks its steps below t down with a running
  product, and the parts' sums meet by a butterfly: dw_t[i] =
  sum_j G_t[i, j] S_{t-1}[i, j] taken from its definition, no log w, no
  division by w, exact at w = 0;
* du = sum_t r_t k_t B[t, t].

``chunked_backward`` below is that algorithm step for step, with the chunk
and the threads a channel read from the kernel's source; nothing but this
test uses it.  Its
products run in f32 here (the kernel's TF32 hi/lo products keep f32
accuracy).  Inputs are numpy arrays from a seed.

Tolerances: against ``jax.grad`` of the JAX package's XLA path, w in
[0.05, 1), 1e-5 of each gradient's largest magnitude (f32 sums in another
order); against the float64 sequential gradient
(``rwkv6_scan_seq_grad``), w log-uniform down to 1e-12 and with 5 % zeros,
1e-4 (``chip_smoke.py`` phase 2's rule for the kernel).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rw
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_seq_grad

SOURCE = (Path(rw.__file__).resolve().parents[2] / "csrc"
          / "rwkv6_scan_bwd.cu").read_text()


def _constant(name):
    m = re.search(rf"\bconstexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in csrc/rwkv6_scan_bwd.cu"
    return int(m.group(1))


CHUNK = _constant("kC")
PARTS = _constant("kThreadsPerChannel")
F32 = torch.float32


def _decays(w):
    """w (B,H,C,D) -> (P_prev (B,H,C,D) = prod_{q<t} w_q, Q = prod_{q>t} w_q,
    P_C = prod_q w_q (B,H,D)), as running products."""
    c = w.shape[2]
    p = torch.ones_like(w)
    q = torch.ones_like(w)
    for t in range(1, c):
        p[:, :, t] = p[:, :, t - 1] * w[:, :, t - 1]
    for t in range(c - 2, -1, -1):
        q[:, :, t] = q[:, :, t + 1] * w[:, :, t + 1]
    return p, q, p[:, :, -1] * w[:, :, -1]


def _a_matrix(r, k, w, u):
    """A[t][s] = sum_i r_t k_s prod_{s<q<t} w_q (s < t), A[t][t] =
    sum_i r_t u k_t: a running product down each column s."""
    b, h, c, d = r.shape
    a = torch.zeros(b, h, c, c)
    kd = k.clone()                     # kd[s] = k_s prod_{s<q<t} w_q at step t
    for t in range(c):
        a[:, :, t, :t] = torch.einsum("bhi,bhsi->bhs", r[:, :, t], kd[:, :, :t])
        a[:, :, t, t] = (r[:, :, t] * u * k[:, :, t]).sum(-1)
        kd[:, :, :t] = kd[:, :, :t] * w[:, :, t, None]
    return a


def chunked_backward(r, k, v, w, u, dy):
    """The kernel's algorithm: r/k/v/w/dy (B,H,T,D), u (H,D), all f32 ->
    (dr, dk, dv, dw (B,H,T,D), du (H,D))."""
    b, h, t, d = r.shape
    c = CHUNK
    parts = PARTS                                        # threads a channel
    n = -(-t // c)
    pad = n * c - t

    def padded(x, fill=0.0):
        return torch.cat([x, torch.full((b, h, pad, d), fill)], 2)

    r, k, v, dy = (padded(x) for x in (r, k, v, dy))
    w = padded(w, 1.0)
    uu = u[None]

    def part(x, ch):
        return x[:, :, ch * c:(ch + 1) * c]

    # the forward sweep: the state before every chunk
    s = torch.zeros(b, h, d, d)
    starts = []
    for ch in range(n):
        starts.append(s)
        if ch == n - 1:
            break
        _, q, p_c = _decays(part(w, ch))
        s = (p_c[..., None] * s
             + torch.einsum("bhti,bhtj->bhij", part(k, ch) * q, part(v, ch)))

    grads = [torch.zeros(b, h, n * c, d) for _ in range(4)]
    du = torch.zeros(b, h, d)
    g = torch.zeros(b, h, d, d)                          # G_end
    for ch in range(n - 1, -1, -1):
        s0 = starts[ch]
        rc, kc, wc, vc, dyc = (part(x, ch) for x in (r, k, w, v, dy))
        p, q, p_c = _decays(wc)
        a = _a_matrix(rc, kc, wc, uu)
        bm = torch.einsum("bhsj,bhqj->bhsq", vc, dyc)    # B = V dY^T
        p1 = torch.einsum("bhqj,bhij->bhqi", dyc, s0)    # dY S0^T
        p2 = torch.einsum("bhsj,bhij->bhsi", vc, g)      # V G_end^T
        cc = (s0 * g).sum(-1)                            # <S0_i, G_end,i>
        dv = (torch.einsum("bhti,bhij->bhtj", kc * q, g)
              + torch.einsum("bhqt,bhqj->bhtj", a, dyc))
        g_next = (p_c[..., None] * g
                  + torch.einsum("bhti,bhtj->bhij", rc * p, dyc))
        diag = torch.diagonal(bm, dim1=2, dim2=3)        # B[t][t] (B,H,C)
        dr, dk, dw = (torch.zeros(b, h, c, d) for _ in range(3))
        y = p1.clone()                                   # Y[q], t = 0
        for tt in range(c):
            dr[:, :, tt] = y[:, :, tt] + uu * kc[:, :, tt] * diag[:, :, tt, None]
            y[:, :, tt + 1:] = (wc[:, :, tt, None] * y[:, :, tt + 1:]
                                + kc[:, :, tt, None] * bm[:, :, tt, tt + 1:, None])
        hh = p2.clone()                                  # H[s], t = C - 1
        uc = cc                                          # U, t = C - 1
        km = c // parts                                  # steps a part
        # part p holds steps km p .. km p + km - 1: its c_m = k_s
        # prod_{s<q<km p+km} w_q
        wg = wc.reshape(b, h, parts, km, d)
        cm = torch.empty(b, h, parts, km, d)
        f = torch.ones(b, h, parts, d)
        for m in range(km - 1, -1, -1):
            cm[:, :, :, m] = kc.reshape(b, h, parts, km, d)[:, :, :, m] * f
            f = f * wg[:, :, :, m]
        for tt in range(c - 1, -1, -1):
            dk[:, :, tt] = hh[:, :, tt] + uu * rc[:, :, tt] * diag[:, :, tt, None]
            pt, mt = tt // km, tt % km                   # step t's part and slot
            hg = hh.reshape(b, h, parts, km, d)
            dot = cm[:, :, :, 0] * hg[:, :, :, 0]
            for m in range(1, km):
                dot = dot + cm[:, :, :, m] * hg[:, :, :, m]
            # a part below t's: prod_{km p+km<=q<t} w_q, ascending
            e = torch.ones(b, h, parts, d)
            for q in range(km, tt):
                e[:, :, :q // km] = e[:, :, :q // km] * wc[:, :, q, None]
            sums = torch.where((torch.arange(parts) < pt)[:, None], e * dot, 0.0)
            walk = torch.zeros(b, h, d)                  # t's part, below t
            f = torch.ones(b, h, d)
            for m in range(mt - 1, -1, -1):
                walk = walk + f * kc[:, :, km * pt + m] * hh[:, :, km * pt + m]
                f = f * wc[:, :, km * pt + m]
            sums[:, :, pt] = walk
            o = 1                                        # the parts' butterfly
            while o < parts:
                sums = sums + sums[:, :, torch.arange(parts) ^ o]
                o *= 2
            sums = sums[:, :, 0]
            dw[:, :, tt] = p[:, :, tt] * uc + sums
            hh[:, :, :tt] = (wc[:, :, tt, None] * hh[:, :, :tt]
                             + rc[:, :, tt, None] * bm[:, :, :tt, tt, None])
            uc = wc[:, :, tt] * uc + rc[:, :, tt] * p1[:, :, tt]
        du = du + (rc * kc * diag[..., None]).sum(2)
        for out, x in zip(grads, (dr, dk, dv, dw)):
            out[:, :, ch * c:(ch + 1) * c] = x
        g = g_next
    dr, dk, dv, dw = (x[:, :, :t] for x in grads)
    return dr, dk, dv, dw, du.sum(0)


def _inputs(seed, b, h, t, d, w_low=0.05, zeros=0.0):
    """r, k, v, w (log-uniform in [w_low, 1), a share ``zeros`` of it 0),
    u and dy, f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, d)) for _ in range(3))
    w = np.exp(rng.uniform(np.log(w_low), 0.0, (b, h, t, d)))
    w = np.where(rng.uniform(size=w.shape) < zeros, 0.0, w)
    u = 0.5 * rng.standard_normal((h, d))
    dy = rng.standard_normal((b, h, t, d))
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u, dy))


def _jax_grads(ins):
    *xs, dy = (jnp.asarray(x) for x in ins)

    def loss(*args):
        return jnp.sum(j_rwkv6_scan(*args, impl="xla")[0] * dy)

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(*xs)]


def _check(got, want, tol):
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


SHAPES = [(2, 2, 1, 32), (2, 2, 40, 64), (1, 2, 77, 32), (1, 2, 128, 64)]


def test_the_chunk_is_the_forward_kernels():
    fwd = (Path(rw.__file__).resolve().parents[2] / "csrc"
           / "rwkv6_scan.cu").read_text()
    assert re.search(rf"\bconstexpr int kC = {CHUNK};", fwd)


@pytest.mark.parametrize("b,h,t,d", SHAPES)
def test_chunked_backward_matches_jax_grad(b, h, t, d):
    ins = _inputs(t + d, b, h, t, d)
    got = chunked_backward(*(torch.from_numpy(x) for x in ins))
    _check(got, _jax_grads(ins), 1e-5)


@pytest.mark.parametrize("zeros", [0.0, 0.05])
@pytest.mark.parametrize("b,h,t,d", SHAPES[1:])
def test_chunked_backward_matches_the_float64_gradient_at_tiny_w(
        b, h, t, d, zeros):
    """w log-uniform in [1e-12, 1), and with 5 % of it exactly 0, where
    the log-decay form's dw is lost (or NaN): every gradient within 1e-4
    of the float64 sequential gradient's largest magnitude.  (At T = 1 no
    output reads w: the sequential graph has no dw, and the JAX test above
    holds the kernel's zeros.)"""
    ins = _inputs(t + 3 * d, b, h, t, d, w_low=1e-12, zeros=zeros)
    tensors = [torch.from_numpy(x) for x in ins]
    got = chunked_backward(*tensors)
    _check(got, rwkv6_scan_seq_grad(*tensors), 1e-4)
