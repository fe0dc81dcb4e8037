"""The gradients of the two scans, in the port against the JAX package, on
the CPU.

* ``rwkv6_scan_bwd_plain`` and ``mamba_scan_bwd_plain`` (autograd through
  the port's plain versions, which the card's backward kernels are held
  against) against ``jax.grad`` of the JAX package's XLA paths, in f32, at
  T ragged over the chunks, with w in [0.05, 1) for rwkv: within 1e-5 of
  each gradient's largest magnitude (the same f32 arithmetic in another
  order).  The public ``rwkv6_scan_bwd`` / ``mamba_scan_bwd`` and autograd
  through ``rwkv6_scan`` / ``selective_scan`` give the same on the CPU.
* A caveat of the reference, pinned: with w log-uniform in [1e-4, 1), the
  XLA path's dw (and the plain version's, which mirrors it) lies more than
  1e-4 of the largest |dw| away from the exact gradient, the sequential
  recurrence's in float64, while the sequential recurrence in f32 stays
  within 1e-6 of it.  The chunked form takes dw from differences of
  cumulative log-decays, which cancel where w is small; the card's kernel
  takes dw from its definition and is held to the float64 gradient
  (``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba_scan
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6_scan
from repro_torch.kernels.mamba_scan.ops import mamba_scan_bwd, selective_scan
from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_plain
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan, rwkv6_scan_bwd
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_plain,
                                                rwkv6_scan_seq_grad)

TOL = 1e-5


def _rwkv_inputs(seed, b, h, t, d, w_low=0.05):
    """r, k, v, w (log-uniform in [w_low, 1)), u and dy, f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, d)) for _ in range(3))
    w = np.exp(rng.uniform(np.log(w_low), 0.0, (b, h, t, d)))
    u = 0.5 * rng.standard_normal((h, d))
    dy = rng.standard_normal((b, h, t, d))
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u, dy))


def _jax_rwkv_grads(ins):
    *xs, dy = (jnp.asarray(x) for x in ins)

    def loss(*args):
        return jnp.sum(j_rwkv6_scan(*args, impl="xla")[0] * dy)

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(*xs)]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("b,h,t,d", [(2, 2, 45, 16), (1, 3, 77, 32),
                                     (2, 1, 40, 64), (1, 2, 1, 8)])
def test_rwkv_plain_gradient_matches_jax_grad(b, h, t, d):
    ins = _rwkv_inputs(t + d, b, h, t, d)
    want = _jax_rwkv_grads(ins)
    tensors = [torch.from_numpy(x) for x in ins]
    _close(rwkv6_scan_bwd_plain(*tensors), want)
    # the public wrapper on CPU tensors, and autograd through the op
    _close(rwkv6_scan_bwd(*tensors), want)
    leaves = [x.clone().requires_grad_() for x in tensors[:5]]
    rwkv6_scan(*leaves)[0].backward(tensors[5])
    _close([x.grad for x in leaves], want)


def _mamba_inputs(seed, b, t, dm, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, dm))
    delta = np.log1p(np.exp(rng.standard_normal((b, t, dm)) - 1.0))
    a = -np.exp(0.5 * rng.standard_normal((dm, n)))
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    dy = rng.standard_normal((b, t, dm))
    return tuple(z.astype(np.float32) for z in (x, delta, a, bm, cm, dy))


@pytest.mark.parametrize("b,t,dm,n", [(2, 100, 24, 16), (1, 70, 8, 4),
                                      (2, 9, 16, 32)])
def test_mamba_plain_gradient_matches_jax_grad(b, t, dm, n):
    ins = _mamba_inputs(t + n, b, t, dm, n)
    *xs, dy = (jnp.asarray(z) for z in ins)
    zero_d = jnp.zeros((dm,), jnp.float32)       # the scan alone: no skip

    def loss(*args):
        return jnp.sum(j_mamba_scan(*args, zero_d, impl="xla")[0] * dy)

    want = jax.grad(loss, argnums=range(5))(*xs)
    tensors = [torch.from_numpy(z) for z in ins]
    _close(mamba_scan_bwd_plain(*tensors), want)
    _close(mamba_scan_bwd(*tensors), want)
    leaves = [z.clone().requires_grad_() for z in tensors[:5]]
    selective_scan(*leaves)[0].backward(tensors[5])
    _close([z.grad for z in leaves], want)


def test_the_plain_backwards_keep_the_kernels_dtypes():
    """dr, dk, dv in r's dtype, dw and du in f32 (and likewise dx in x's,
    ddelta in delta's, da, db, dc in f32), as the kernels give them."""
    r, k, v, w, u, dy = (torch.from_numpy(x) for x in
                         _rwkv_inputs(0, 1, 2, 5, 8))
    bf = torch.bfloat16
    grads = rwkv6_scan_bwd_plain(r.to(bf), k.to(bf), v.to(bf), w, u, dy.to(bf))
    assert [g.dtype for g in grads] == [bf, bf, bf, torch.float32,
                                        torch.float32]
    x, delta, a, bm, cm, dy = (torch.from_numpy(z) for z in
                               _mamba_inputs(0, 1, 5, 8, 4))
    grads = mamba_scan_bwd_plain(x.to(bf), delta, a, bm, cm, dy.to(bf))
    assert [g.dtype for g in grads] == [bf] + [torch.float32] * 4


def _rel_err(got, exact):
    exact = np.asarray(exact, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - exact).max()
                 / np.abs(exact).max())


def _errors_at(w_low):
    """Each path's gradients against the float64 sequential ones at B 2,
    H 2, T 128, D 64, seed 1, w log-uniform in [w_low, 1): {path: [error /
    max |g| of dr, dk, dv, dw, du]} for ``jax.grad`` of the XLA path, the
    plain version and the sequential recurrence in f32."""
    ins = _rwkv_inputs(1, 2, 2, 128, 64, w_low=w_low)
    tensors = [torch.from_numpy(x) for x in ins]
    exact = [g.numpy() for g in rwkv6_scan_seq_grad(*tensors)]
    paths = {"jax.grad": _jax_rwkv_grads(ins),
             "plain": rwkv6_scan_bwd_plain(*tensors),
             "sequential f32": rwkv6_scan_seq_grad(*tensors,
                                                   dtype=torch.float32)}
    return {name: [_rel_err(g, e) for g, e in zip(grads, exact)]
            for name, grads in paths.items()}


def test_the_chunked_dw_loses_accuracy_at_small_w():
    """The reference caveat (ROADMAP.md queue 3): w log-uniform in [1e-4,
    1).  Against the float64 sequential gradient the XLA path's dw
    (``jax.grad``) and the plain version's are off by more than 1e-4 of the
    largest |dw|; the sequential recurrence in f32 is within 1e-6, and the
    chunked form's other gradients within 1e-4."""
    errs = _errors_at(1e-4)
    assert errs["jax.grad"][3] > 1e-4
    assert errs["plain"][3] > 1e-4
    assert max(errs["sequential f32"]) < 1e-6
    for i in (0, 1, 2, 4):
        assert errs["jax.grad"][i] < 1e-4, i
        assert errs["plain"][i] < 1e-4, i


def test_the_sequential_gradient_is_finite_where_w_is_zero():
    """Where w underflows to 0 the log-decay form's gradients are NaN; the
    sequential recurrence's (the kernel's formula) stay finite and agree
    with the float64 gradient."""
    ins = list(_rwkv_inputs(2, 1, 2, 40, 16))
    ins[3][:, :, 7] = 0.0
    tensors = [torch.from_numpy(x) for x in ins]
    plain_dw = rwkv6_scan_bwd_plain(*tensors)[3]
    assert not bool(torch.isfinite(plain_dw).all())
    exact = rwkv6_scan_seq_grad(*tensors)
    seq32 = rwkv6_scan_seq_grad(*tensors, dtype=torch.float32)
    for g, e in zip(seq32, exact):
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g, e) < 1e-6


if __name__ == "__main__":
    # the caveat's table: PYTHONPATH=src python tests/test_torch_scan_backward.py
    for low in (0.1, 1e-2, 1e-3, 1e-4):
        for name, errs in _errors_at(low).items():
            print(f"w in [{low:g}, 1) {name}: error / max |g| of dr dk dv "
                  f"dw du " + " ".join(f"{e:.2g}" for e in errs))
