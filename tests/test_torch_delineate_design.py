"""The neighbour rule of the port's delineation kernel, in plain PyTorch,
against the plain version and the JAX package on the CPU, exactly; and the
wrapper's one launch.

``csrc/delineate.cu`` runs only on the card (``chip_smoke.py`` phase 2
holds it against the plain version there).  What can be checked here is
how each sample finds its neighbours: ``kernel_order_delineate`` below is
it step for step, and nothing but this test uses it.  The grid is one
thread a sample in blocks of ``kThreads``; thread i < n reads x[i],
x[max(i - 1, 0)] and x[min(i + 1, n - 1)] and stores flag i, threads past
n store nothing; the endpoints are never extrema; the thresholds are cast
to x's dtype.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.delineate.ops import delineate as j_delineate
from repro_torch.kernels.delineate import ops as dl_ops
from repro_torch.kernels.delineate.ref import delineate_ref, thresholds

CU = Path(dl_ops.__file__).resolve().parents[2] / "csrc" / "delineate.cu"
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", CU.read_text()).group(1))


def kernel_order_delineate(x: torch.Tensor, thr) -> torch.Tensor:
    """``csrc/delineate.cu``'s flags for a 1-D x."""
    n = x.shape[0]
    blocks = -(-n // THREADS)
    i = torch.arange(blocks * THREADS)
    i = i[i < n]                                          # threads past n return
    xc = x[i]
    prev = x[torch.where(i > 0, i - 1, 0)]
    nxt = x[torch.where(i < n - 1, i + 1, n - 1)]
    t, neg_t = thresholds(thr, x.dtype)
    interior = (i > 0) & (i < n - 1)
    peak = interior & (xc > prev) & (xc >= nxt) & (xc > t)
    trough = interior & (xc < prev) & (xc <= nxt) & (xc < neg_t)
    flags = torch.zeros(n, dtype=torch.int8)
    flags[i] = peak.to(torch.int8) - trough.to(torch.int8)
    return flags


def _signals(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        x = np.sin(np.arange(n) / 5.0) + 0.3 * rng.standard_normal(n)
    else:
        x = rng.integers(-20, 20, n)
    x = x.astype(dtype)
    if n > 60:
        x[40:45] = x[40]                                  # a plateau
        x[50] = 3                                         # ties with thr = 3
        x[52] = -3
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int32])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 9, 31, 33, 127, 128, 129,
                               255, 256, 257, 1000, 4097])
def test_neighbour_rule_equals_the_plain_version(dtype, n):
    xn = _signals(dtype, n, seed=n)
    x = torch.from_numpy(xn)
    for thr in (0, 3, 2.7, 0.25):
        got = kernel_order_delineate(x, thr)
        assert torch.equal(got, delineate_ref(x, thr)), thr


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int32])
@pytest.mark.parametrize("n", [1, 2, 6, 130, 1500])
@pytest.mark.parametrize("thr", [0, 3, 2.7])
def test_neighbour_rule_equals_the_jax_delineate(dtype, n, thr):
    xn = _signals(dtype, n, seed=7)
    want = np.asarray(j_delineate(jnp.asarray(xn), thr))
    got = kernel_order_delineate(torch.from_numpy(xn), thr).numpy()
    np.testing.assert_array_equal(got, want)


def test_int16_threshold_is_cast_before_the_compare():
    """2.7 on an int16 signal compares as 2 (the cast truncates), so a
    peak of 3 counts and a trough of -3 too; 70000 wraps in int16."""
    x = torch.tensor([0, 3, 0, -3, 0, 2, 0], dtype=torch.int16)
    got = kernel_order_delineate(x, 2.7)
    assert got.tolist() == [0, 1, 0, -1, 0, 0, 0]
    for thr in (2.7, 70000, -1):
        assert torch.equal(kernel_order_delineate(x, thr), delineate_ref(x, thr))


def test_the_kernel_is_one_thread_a_sample():
    """The rule mirrored above is the source's: whole blocks of kThreads
    threads, one sample each, with clamped neighbour reads."""
    src = CU.read_text()
    assert 0 < THREADS <= 1024 and THREADS % 32 == 0
    assert "const int blocks = (n + kThreads - 1) / kThreads;" in src
    assert "if (i >= n) return;" in src
    assert "x[i > 0 ? i - 1 : 0]" in src and "x[i < n - 1 ? i + 1 : n - 1]" in src


@pytest.mark.parametrize("dtype,symbol", [
    (torch.float32, "repro_delineate_f32"), (torch.int16, "repro_delineate_i16"),
    (torch.int32, "repro_delineate_i32")])
def test_delineate_on_the_card_is_one_launch(monkeypatch, dtype, symbol):
    calls = []
    monkeypatch.setattr(dl_ops, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(dl_ops, "stream_of", lambda t: None)
    monkeypatch.setattr(dl_ops, "on_card", lambda *t: True)
    x = torch.zeros(65_536, dtype=dtype)
    flags = dl_ops.delineate(x, 2.7)
    (args,) = calls
    assert args[:2] == ("delineate", symbol)
    assert args[3].value == x.data_ptr() and args[4].value == flags.data_ptr()
    assert flags.dtype == torch.int8 and flags.shape == (65_536,)
    assert args[5:8] == (65_536, *thresholds(2.7, dtype))
