"""The schedule of the port's Stockham FFT kernel, in plain PyTorch, against
the plain version bit for bit and against the JAX package on the CPU, and
the wrappers' launches.

``csrc/stockham_fft.cu`` runs only on the card (``chip_smoke.py`` phase 2
holds it against the plain version there, and ``power_spectrum`` against
the card's own ``fft``).  What can be checked here is its schedule: a
twiddle table of the n - 1 values of all stages, stage l at offset l - 1,
filled from the n / 2 values of the last stage (each smaller stage's angle
is one of them, bit for bit);
passes of two radix-2 stages (l, 2l) done in registers, thread k < n/4
reading X[k + {0, n/4, n/2, 3n/4}] and writing Z[4gl + j + {0, l, 2l,
3l}]; a last radix-2 pass where log2 n is odd.  ``staged_radix4_fft``
below is that schedule step for step; nothing but this test uses it.
Each product and sum is a float32 operation of its own, as the kernel
rounds them (``__fmul_rn``/``__fadd_rn``), so the schedule must give the
plain version's bits exactly.  Against the JAX ``fft`` (its Pallas kernel
in interpret mode) the tolerance is ``tests/test_torch_kernels.py``'s:
rtol 1e-4, atol 1e-5 n (the twiddles' cos/sin come from two libraries).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.stockham_fft.ops import fft as j_fft
from repro_torch.kernels.stockham_fft import ops as fft_ops
from repro_torch.kernels.stockham_fft.ref import stockham_fft_ref

SIZES = [1 << s for s in range(14)]          # n = 1 .. 8192
CSRC = Path(fft_ops.__file__).resolve().parents[2] / "csrc" / "stockham_fft.cu"
#: a block's shared memory on sm_90 (opt-in limit)
MAX_SHARED = 232448


def twiddle_table(n: int):
    """(cos, sin) of every stage's twiddles in one table, stage l at offset
    l - 1, filled as the kernel fills it: from the n / 2 angles
    float32(-pi / (n/2)) * j of the last stage alone, entry j going to
    entry j / 2^i of stage n / 2^(i+1) wherever 2^i divides j."""
    if n < 2:
        return torch.zeros(0), torch.zeros(0)
    half = n // 2
    step = torch.full((), -math.pi / half, dtype=torch.float32)
    ang = torch.arange(half, dtype=torch.float32) * step
    last_cos, last_sin = torch.cos(ang), torch.sin(ang)
    cos, sin = torch.empty(n - 1), torch.empty(n - 1)
    l = half
    while l >= 1:
        j = torch.arange(l)
        cos[l - 1 + j] = last_cos[j * (half // l)]
        sin[l - 1 + j] = last_sin[j * (half // l)]
        l //= 2
    return cos, sin


def butterfly(ar, ai, br, bi, wr, wi):
    tr = wr * br - wi * bi
    ti = wr * bi + wi * br
    return (ar + tr, ai + ti), (ar - tr, ai - ti)


def staged_radix4_fft(re: torch.Tensor, im: torch.Tensor):
    """The kernel's schedule on float32 (batch, n) planes."""
    b, n = re.shape
    log2n = n.bit_length() - 1
    cos, sin = twiddle_table(n)
    xr, xi = re.clone(), im.clone()
    s = 0
    while s + 2 <= log2n:                    # stages l and 2l, in registers
        l = 1 << s
        k = torch.arange(n // 4)
        j, g = k % l, k // l
        x = [(xr[:, k + c * n // 4], xi[:, k + c * n // 4]) for c in range(4)]
        w1 = (cos[l - 1 + j], sin[l - 1 + j])
        (y0, y1), (y2, y3) = (butterfly(*x[0], *x[2], *w1),
                              butterfly(*x[1], *x[3], *w1))
        z0, z2 = butterfly(*y0, *y2, cos[2 * l - 1 + j], sin[2 * l - 1 + j])
        z1, z3 = butterfly(*y1, *y3, cos[3 * l - 1 + j], sin[3 * l - 1 + j])
        base = 4 * g * l + j
        zr, zi = torch.empty_like(xr), torch.empty_like(xi)
        for c, z in enumerate((z0, z1, z2, z3)):
            zr[:, base + c * l], zi[:, base + c * l] = z
        xr, xi = zr, zi
        s += 2
    if s < log2n:                            # the last stage, l = n / 2
        half = n // 2
        k = torch.arange(half)
        lo, hi = butterfly(xr[:, k], xi[:, k], xr[:, k + half], xi[:, k + half],
                           cos[half - 1 + k], sin[half - 1 + k])
        xr = torch.cat([lo[0], hi[0]], dim=1)
        xi = torch.cat([lo[1], hi[1]], dim=1)
    return xr, xi


def _planes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, n)).astype(np.float32),
            rng.standard_normal((3, n)).astype(np.float32))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", SIZES)
def test_schedule_has_the_plain_versions_bits(n):
    """Bit for bit (as int32 words, so -0.0 != +0.0) for every n."""
    re, im = (torch.from_numpy(a) for a in _planes(n, n))
    got = staged_radix4_fft(re, im)
    want = stockham_fft_ref(re, im)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", SIZES[1:])
def test_schedule_matches_the_jax_fft(n):
    re, im = _planes(n, 100 + n)
    jre, jim = (np.asarray(a) for a in j_fft(jnp.asarray(re), jnp.asarray(im)))
    tre, tim = (a.numpy() for a in staged_radix4_fft(torch.from_numpy(re),
                                                     torch.from_numpy(im)))
    tol = dict(rtol=1e-4, atol=1e-5 * n)
    np.testing.assert_allclose(tre, jre, **tol)
    np.testing.assert_allclose(tim, jim, **tol)


def test_max_n_fits_a_blocks_shared_memory():
    """4 planes of n floats and n - 1 float2 twiddles: 24 n - 8 bytes, 192
    KB at MAX_N; the kernel refuses a larger n itself (kMaxN)."""
    src = CSRC.read_text()
    k_max = int(re.search(r"constexpr int kMaxN = (\d+);", src).group(1))
    assert k_max == fft_ops.MAX_N
    assert 4 * 4 * k_max + 8 * (k_max - 1) <= MAX_SHARED


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fft_ops, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fft_ops, "stream_of", lambda t: None)
    monkeypatch.setattr(fft_ops, "on_card", lambda *t: True)
    return calls


def test_power_spectrum_on_the_card_is_one_launch_into_power(monkeypatch):
    """The card path launches once, hands the kernel the output as its
    ``power`` pointer and no plane to write, and returns that output."""
    calls = _record_launches(monkeypatch)
    x = torch.zeros(128, 512)
    out = fft_ops.power_spectrum(x)
    (args,) = calls
    assert args[:2] == ("stockham_fft", "repro_stockham_fft_f32")
    src_re, src_im, re_out, im_out, power = (a.value for a in args[3:8])
    assert (src_re, src_im, re_out, im_out) == (x.data_ptr(), None, None, None)
    assert power == out.data_ptr() and out.shape == (128, 512)
    assert args[8:10] == (128, 512)
    one = fft_ops.power_spectrum(torch.zeros(64))
    assert len(calls) == 2 and one.shape == (64,)


def test_fft_on_the_card_passes_no_power_pointer(monkeypatch):
    calls = _record_launches(monkeypatch)
    re_, im_ = torch.zeros(3, 64), torch.zeros(3, 64)
    ore, oim = fft_ops.fft(re_, im_)
    (args,) = calls
    ptrs = [a.value for a in args[3:8]]
    assert ptrs == [re_.data_ptr(), im_.data_ptr(), ore.data_ptr(),
                    oim.data_ptr(), None]
