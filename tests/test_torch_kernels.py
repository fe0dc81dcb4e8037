"""Each ported kernel family against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX op (its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and through
the port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
version — the arithmetic the CUDA kernel repeats.  Integer FIR and
delineation flags must match exactly; fp32 outputs match within the stated
tolerances.  The wrappers must also map ``meta`` inputs to ``meta`` outputs
of the right shape and dtype (capture infers shapes that way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.delineate.ops import delineate as j_delineate
from repro.kernels.fir.ops import fir as j_fir
from repro.kernels.stockham_fft.ops import fft as j_fft
from repro.kernels.stockham_fft.ops import power_spectrum as j_power_spectrum
from repro.kernels.svm.ops import svm_decision as j_svm
from repro_torch.kernels.common import LAUNCHES, on_card, pad_dim
from repro_torch.kernels.delineate.ops import delineate
from repro_torch.kernels.fir.ops import fir
from repro_torch.kernels.stockham_fft.ops import fft, power_spectrum
from repro_torch.kernels.svm.ops import svm_decision

SEEDS = (0, 1, 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- FIR ---------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,taps", [(1000, 17), (700, 128), (300, 520)])
def test_fir_float_matches_reference(n, taps, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    h = (rng.standard_normal(taps) / taps).astype(np.float32)
    want = np.asarray(j_fir(jnp.asarray(x), jnp.asarray(h)))
    got = fir(_t(x), _t(h)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    # fp32 sums of `taps` products in the same order; XLA may contract a
    # multiply-add into one rounding, so allow a few ulps of |y| ~ 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_fir_q15_int16_exact(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 15, 2 ** 15, 777).astype(np.int16)
    h = rng.integers(-2 ** 15, 2 ** 15, 64).astype(np.int16)
    want = np.asarray(j_fir(jnp.asarray(x), jnp.asarray(h)))
    got = fir(_t(x), _t(h)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_fir_int32_wraparound_exact():
    # products of ~2^30 x 2^30 wrap int32 many times over; only modular
    # int32 accumulation, then >> 15, then nothing else, matches
    rng = np.random.default_rng(7)
    x = rng.integers(2 ** 29, 2 ** 31 - 1, 300).astype(np.int32)
    h = rng.integers(2 ** 29, 2 ** 31 - 1, 40).astype(np.int32)
    want = np.asarray(j_fir(jnp.asarray(x), jnp.asarray(h)))
    got = fir(_t(x), _t(h)).numpy()
    acc_exact = np.convolve(x.astype(object), h.astype(object))[:300]
    assert any(abs(int(v)) >= 2 ** 31 for v in acc_exact)   # it does overflow
    np.testing.assert_array_equal(got, want)


# -- delineation ---------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("thr", [0, 0.25])
def test_delineate_float_exact(seed, thr):
    rng = np.random.default_rng(seed)
    x = np.sin(np.arange(1500) / 9.0) + 0.3 * rng.standard_normal(1500)
    x = x.astype(np.float32)
    x[100:104] = x[100]                     # a plateau
    want = np.asarray(j_delineate(jnp.asarray(x), thr))
    got = delineate(_t(x), thr).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("thr", [0, 3, 2.7])
def test_delineate_int_exact(dtype, thr):
    rng = np.random.default_rng(3)
    x = rng.integers(-20, 20, 1100).astype(dtype)
    want = np.asarray(j_delineate(jnp.asarray(x), thr))
    got = delineate(_t(x), thr).numpy()
    np.testing.assert_array_equal(got, want)


# -- Stockham FFT ----------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [8, 64, 512])
def test_fft_matches_reference(n, seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((3, n)).astype(np.float32)
    im = rng.standard_normal((3, n)).astype(np.float32)
    jre, jim = (np.asarray(a) for a in j_fft(jnp.asarray(re), jnp.asarray(im)))
    tre, tim = (a.numpy() for a in fft(_t(re), _t(im)))
    # fp32 with the same butterflies; the twiddles' cos/sin come from two
    # libraries (ulp-level) and errors grow ~log2(n); |X| ~ sqrt(n)
    tol = dict(rtol=1e-4, atol=1e-5 * n)
    np.testing.assert_allclose(tre, jre, **tol)
    np.testing.assert_allclose(tim, jim, **tol)
    np.testing.assert_allclose(tre + 1j * tim, np.fft.fft(re + 1j * im),
                               rtol=1e-4, atol=1e-4 * n)


def test_power_spectrum_batched_matches_reference():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 512)).astype(np.float32)
    want = np.stack([np.asarray(j_power_spectrum(jnp.asarray(r))) for r in w])
    got = power_spectrum(_t(w)).numpy()
    # |X|^2 up to ~n * sum(x^2); absolute error scales with the peak
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())
    np.testing.assert_array_equal(power_spectrum(_t(w[2])).numpy(), got[2])


# -- SVM ----------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("q,m,d,gamma", [(13, 300, 7, 0.5), (128, 256, 36, 0.5),
                                         (5, 40, 3, None)])
def test_svm_matches_reference(q, m, d, gamma, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (q, d)).astype(np.float32)
    # support vectors near the queries, so the RBF values are not all 0
    sv = (x[rng.integers(0, q, m)] + 0.2 * rng.standard_normal((m, d))
          ).astype(np.float32)
    alpha = (rng.standard_normal(m) / m).astype(np.float32)
    b = np.float32(0.1)
    want = np.asarray(j_svm(jnp.asarray(x), jnp.asarray(sv),
                            jnp.asarray(alpha), b, gamma=gamma))
    got = svm_decision(_t(x), _t(sv), _t(alpha), torch.tensor(b),
                       gamma=gamma).numpy()
    if gamma is not None:
        assert np.abs(want - b).max() > 1e-3      # the kernel term matters
    # fp32 dot products and a sum over m in another order
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- dispatch ----------------------------------------------------------------------------
def test_meta_inputs_give_meta_outputs_without_launching():
    before = dict(LAUNCHES)
    meta = dict(device="meta")
    y = fir(torch.empty(100, **meta), torch.empty(9, **meta))
    assert (y.device.type, y.shape, y.dtype) == ("meta", (100,), torch.float32)
    yi = fir(torch.empty(100, dtype=torch.int16, **meta),
             torch.empty(9, dtype=torch.int16, **meta))
    assert (yi.shape, yi.dtype) == ((100,), torch.int16)
    f = delineate(torch.empty(50, **meta), 0)
    assert (f.device.type, f.shape, f.dtype) == ("meta", (50,), torch.int8)
    re, im = fft(torch.empty(4, 64, **meta))
    assert re.device.type == "meta" and re.shape == im.shape == (4, 64)
    p = power_spectrum(torch.empty(128, 512, **meta))
    assert p.device.type == "meta" and p.shape == (128, 512)
    s = svm_decision(torch.empty(8, 3, **meta), torch.empty(20, 3, **meta),
                     torch.empty(20, **meta), torch.empty((), **meta), 0.5)
    assert s.device.type == "meta" and s.shape == (8,)
    assert LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32"):
        fir(torch.zeros(10, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        fir(torch.zeros(10), torch.zeros(3, dtype=torch.int16))
    with pytest.raises(ValueError, match="1-D"):
        fir(torch.zeros(2, 10), torch.zeros(3))
    with pytest.raises(ValueError, match="power of two"):
        fft(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="disagree"):
        svm_decision(torch.zeros(4, 3), torch.zeros(5, 2), torch.zeros(5), 0.0)
    with pytest.raises(TypeError):
        delineate(torch.zeros(10, dtype=torch.float16))
    with pytest.raises(ValueError, match="different devices"):
        on_card(torch.zeros(3), torch.zeros(3, device="meta"))


def test_pad_dim_matches_reference():
    from repro.kernels.common import pad_dim as j_pad_dim
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for axis, mult, fill in ((0, 8, 0), (1, 3, -1), (-1, 4, 5)):
        np.testing.assert_array_equal(
            pad_dim(_t(x), axis, mult, fill).numpy(),
            np.asarray(j_pad_dim(jnp.asarray(x), axis, mult, fill)))
