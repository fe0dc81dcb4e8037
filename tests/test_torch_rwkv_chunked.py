"""The algorithm of the port's RWKV-6 WKV kernel, in plain PyTorch, against
the JAX package's ``rwkv6_scan`` on the CPU.

``csrc/rwkv6_scan.cu`` runs only on the card (``chip_smoke.py`` phase 2
holds it against the plain version there).  What can be checked here is its
algorithm: the state split into slabs of 32 columns, each carried on its
own; chunks of 32 steps in the chunked form, with every decay a running
product of w (never an exp of a difference of log sums); the missing steps
of the last chunk as r = k = v = 0, w = 1.  ``slab_chunked_scan`` below is
that algorithm step for step, used by nothing but this test.  It takes the
same numpy inputs, made from a seed, as the JAX op (its XLA chunked path,
what JAX runs off a TPU), with decays w = exp(-exp(w_log)) and w_log drawn
over [-6, 3], which gives w from about 0.998 down to about 2e-9.

Tolerance: 1e-5 of the largest magnitude of y and of the state, as
``chip_smoke.py`` phase 2 holds the kernel against the plain version (the
same f32 sums in another order, and products of decays in place of
exponentials of log sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan

RTOL = 1e-5
CHUNK = 32
SLAB = 32


def _exclusive_cumprod(w, dim, reverse=False):
    """prod of w over the steps before (or, reversed, after) each step."""
    if reverse:
        w = torch.flip(w, (dim,))
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    p = torch.cumprod(torch.cat([ones, w.narrow(dim, 0, w.shape[dim] - 1)], dim), dim)
    return torch.flip(p, (dim,)) if reverse else p


def slab_chunked_scan(r, k, v, w, u, state0=None):
    """The kernel's algorithm: r/k/v/w (B,H,T,D) f32, u (H,D), state0
    (B,H,D,D) or None -> (y (B,H,T,D), state (B,H,D,D))."""
    b, h, t, d = r.shape
    s = torch.zeros(b, h, d, d) if state0 is None else state0.clone()
    y = torch.zeros(b, h, t, d)
    for c0 in range(0, t, CHUNK):
        n = min(CHUNK, t - c0)
        pad = CHUNK - n

        def chunk(x, fill=0.0):
            x = x[:, :, c0:c0 + n]
            return torch.cat([x, torch.full((b, h, pad, d), fill)], 2)

        rc, kc, vc, wc = chunk(r), chunk(k), chunk(v), chunk(w, 1.0)
        p_prev = _exclusive_cumprod(wc, 2)                 # prod_{q<t} w_q
        q_after = _exclusive_cumprod(wc, 2, reverse=True)  # prod_{q>s} w_q
        p_all = p_prev[:, :, -1] * wc[:, :, -1]            # prod_q w_q
        # A down each column s: the diagonal's u bonus, then running
        # products kd = k_s * prod_{s<q<t} w_q for t > s
        a = torch.zeros(b, h, CHUNK, CHUNK)
        for s_col in range(CHUNK):
            a[:, :, s_col, s_col] = (rc[:, :, s_col] * u * kc[:, :, s_col]).sum(-1)
            kd = kc[:, :, s_col]
            for t_row in range(s_col + 1, CHUNK):
                a[:, :, t_row, s_col] = (rc[:, :, t_row] * kd).sum(-1)
                kd = kd * wc[:, :, t_row]
        r_dec, k_dec = rc * p_prev, kc * q_after
        for j0 in range(0, d, SLAB):                       # slabs on their own
            cols = slice(j0, j0 + SLAB)
            s_slab = s[..., cols]
            y_c = a @ vc[..., cols] + r_dec @ s_slab
            y[:, :, c0:c0 + n, cols] = y_c[:, :, :n]
            s[..., cols] = (p_all[..., None] * s_slab
                            + k_dec.transpose(-1, -2) @ vc[..., cols])
    return y, s


def _inputs(seed, b, h, t, d, state):
    rng = np.random.default_rng(seed)
    f = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(np.float32)
    r, k, v = f(b, h, t, d), f(b, h, t, d), f(b, h, t, d)
    w = np.exp(-np.exp(rng.uniform(-6.0, 3.0, (b, h, t, d)))).astype(np.float32)
    s0 = {"absent": None, "zero": np.zeros((b, h, d, d), np.float32),
          "random": rng.standard_normal((b, h, d, d)).astype(np.float32)}[state]
    return r, k, v, w, f(h, d), s0


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("state", ["absent", "zero", "random"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 300])
def test_slab_chunked_algorithm_matches_jax(t, d, state):
    r, k, v, w, u, s0 = _inputs(t * 7 + d, 2, 2, t, d, state)
    y, s = slab_chunked_scan(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                             None if s0 is None else torch.from_numpy(s0))
    jy, js = j_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                    None if s0 is None else jnp.asarray(s0), impl="xla")
    assert y.shape == (2, 2, t, d) and s.shape == (2, 2, d, d)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close(y, jy)
    _close(s, js)
