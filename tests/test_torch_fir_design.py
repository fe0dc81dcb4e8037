"""The schedule of the port's FIR kernel, in plain PyTorch, against the plain
version bit for bit and against the JAX package on the CPU; the launch plan
and the wrapper's one launch.

``csrc/fir.cu`` runs only on the card (``chip_smoke.py`` phase 2 holds it
against the plain version there with ``torch.equal``).  What can be checked
here is its schedule: ``kernel_order_fir`` below is it step for step, and
nothing but this test uses it.  A block of ``threads`` threads owns
``threads * rows`` consecutive outputs, thread k the ``rows`` from
``k * rows``.  The taps go through in chunks of ``kChunk``; for each chunk
the block stages the window x[ws .. ws + len) (zeros outside [0, n); ws the
lowest sample the chunk reads, rounded down to a 16-byte vector), and each
thread keeps ``rows + 4`` samples of it in registers, w[k] = x[A - 4g - 4 +
k] at the group of taps 4g .. 4g + 3, where A is its first output less the
chunk's first tap.  Output r takes tap 4g + u times w[r + 4 - u], u = 0..3
in order; then the window slides by four samples read at x[A - 4g - 8].
The last chunk's taps % 4 taps go on the last window, with no padded tap.
Every read must lie inside the staged window (checked here).  Float sums
are float32 operations of their own (``__fmul_rn``/``__fadd_rn``); integer
sums wrap in uint32, then ``>> 15``.  So the schedule must give
``fir_ref``'s bits exactly, for every plan.  Against the JAX ``fir`` (its
Pallas kernel in interpret mode): atol 1e-6 in float32 (XLA may contract a
multiply-add), exact for Q15.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fir.ops import fir as j_fir
from repro_torch.kernels.fir import fir as fir_mod
from repro_torch.kernels.fir import ops as fir_ops
from repro_torch.kernels.fir.ref import FXP_SHIFT, fir_ref

H100_SMS = 132
CSRC = Path(fir_mod.__file__).resolve().parents[2] / "csrc" / "fir.cu"
_LOW32 = 0xFFFFFFFF


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CSRC.read_text()).group(1))


def _cdiv(a, b):
    return -(-a // b)


def _blocks(n, plan):
    """The grid ``launch_fir`` in csrc/fir.cu launches for a plan."""
    return _cdiv(n, plan.rows * plan.threads)


def kernel_order_fir(x: torch.Tensor, h: torch.Tensor, rows: int,
                     threads: int) -> torch.Tensor:
    """``csrc/fir.cu``'s sums for a 1-D x and taps h, with ``rows``
    outputs a thread and ``threads`` a block."""
    n, taps = x.shape[0], h.shape[0]
    fixed = not x.dtype.is_floating_point
    work = torch.int64 if fixed else torch.float32     # int64: uint32 in its low bits
    vec = 16 // x.element_size()
    chunk = _const("kChunk")
    outs = threads * rows
    blocks = _cdiv(n, outs)
    xw_all, hw = x.to(work), h.to(work)
    base = torch.arange(blocks) * outs                  # (blocks,)
    first = torch.arange(threads) * rows                # (threads,)
    acc = [torch.zeros(blocks, threads, dtype=work) for _ in range(rows)]

    def madd(a, tap, v):
        return (a + tap * v) & _LOW32 if fixed else a + tap * v

    for c0 in range(0, taps, chunk):
        tc = min(chunk, taps - c0)
        groups = _cdiv(tc, 4)
        lo = base - c0 - 4 * groups - 4
        ws = lo - lo % vec                              # rounded down to a vector
        length = _cdiv(int((base + outs - c0 - ws).max()), vec) * vec
        g = ws[:, None] + torch.arange(length)[None, :]
        inside = (g >= 0) & (g < n)
        window = torch.where(inside, xw_all[g.clamp(0, n - 1)],
                             torch.zeros((), dtype=work))
        off = base[:, None] + first[None, :] - c0 - ws[:, None]

        def xw(i):                                      # x[A + i] for every thread
            idx = off + i
            assert int(idx.min()) >= 0 and int(idx.max()) < length
            return torch.gather(window, 1, idx)

        w = [xw(k - 4) for k in range(rows + 4)]
        full = tc // 4
        for grp in range(full):
            q = [xw(-4 * grp - 8 + j) for j in range(4)]
            for u in range(4):
                tap = hw[c0 + 4 * grp + u]
                for r in range(rows):
                    acc[r] = madd(acc[r], tap, w[r + 4 - u])
            w = q + w[:rows]                            # slide by four samples
        for u in range(tc % 4):
            tap = hw[c0 + 4 * full + u]
            for r in range(rows):
                acc[r] = madd(acc[r], tap, w[r + 4 - u])
    y = torch.stack(acc, dim=-1).reshape(-1)[:n]
    if not fixed:
        return y
    y = torch.where(y >= 2 ** 31, y - 2 ** 32, y)      # as int32
    return (y >> FXP_SHIFT).to(x.dtype)


def _signal(kind: str, n: int, taps: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return (rng.standard_normal(n).astype(np.float32),
                (rng.standard_normal(taps) / taps).astype(np.float32))
    if kind == "q15":
        return (rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                rng.integers(-2 ** 15, 2 ** 15, taps).astype(np.int16))
    # int32 with products that wrap many times over
    return (rng.integers(2 ** 29, 2 ** 31 - 1, n).astype(np.int32),
            rng.integers(2 ** 29, 2 ** 31 - 1, taps).astype(np.int32))


CASES = [  # (n, taps, rows, threads)
    (1000, 17, 1, 32), (1000, 17, 8, 32), (777, 128, 2, 64), (777, 128, 4, 32),
    (300, 129, 8, 64), (65, 3, 4, 32), (1, 1, 1, 32), (5, 33, 2, 32),
    (1300, 700, 4, 64), (40, 127, 8, 32),
    # blocks that are no whole number of warps, as the plan sizes them
    (1000, 128, 4, 125), (100, 17, 1, 1), (300, 5, 2, 3), (777, 33, 8, 67),
]


@pytest.mark.parametrize("kind", ["f32", "q15", "i32"])
@pytest.mark.parametrize("n,taps,rows,threads", CASES)
def test_schedule_gives_the_plain_versions_bits(kind, n, taps, rows, threads):
    xn, hn = _signal(kind, n, taps, seed=n + taps)
    x, h = torch.from_numpy(xn), torch.from_numpy(hn)
    got = kernel_order_fir(x, h, rows, threads)
    want = fir_ref(x, h)
    assert got.dtype == want.dtype
    if kind == "f32":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["f32", "q15"])
@pytest.mark.parametrize("n,taps,rows,threads",
                         [(1000, 17, 4, 32), (700, 128, 2, 64), (300, 129, 8, 32)])
def test_schedule_matches_the_jax_fir(kind, n, taps, rows, threads):
    xn, hn = _signal(kind, n, taps, seed=3)
    want = np.asarray(j_fir(jnp.asarray(xn), jnp.asarray(hn)))
    got = kernel_order_fir(torch.from_numpy(xn), torch.from_numpy(hn), rows,
                           threads).numpy()
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_a_tap_that_does_not_exist_adds_no_product():
    """taps % 4 != 0 with an inf in the signal: a zero-padded tap would put
    0 * inf = NaN where the plain version has a number."""
    x = torch.ones(64)
    x[10] = float("inf")
    h = torch.full((5,), 0.5)
    got = kernel_order_fir(x, h, 4, 32)
    want = fir_ref(x, h)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert not bool(torch.isnan(got[:10]).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_every_plan_gives_the_same_bits():
    xn, hn = _signal("f32", 2000, 600, seed=5)
    x, h = torch.from_numpy(xn), torch.from_numpy(hn)
    outs = [kernel_order_fir(x, h, r, t).view(torch.int32)
            for r in fir_mod.ROWS for t in (1, 32, 125, 256)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_plan_fills_the_card_at_tinybio():
    """TinyBio (65,536 samples, 128 taps): 4 outputs a thread, and one
    block of four warps on each of the 132 SMs, so every scheduler of
    every SM runs a warp."""
    plan = fir_mod.plan_fir(65_536, 128, H100_SMS)
    assert tuple(plan) == (4, 125) and _blocks(65_536, plan) == H100_SMS
    assert _cdiv(plan.threads, 32) == fir_mod.SCHEDULERS
    # beside it, 2^20 samples: 8 outputs a thread in 1024 blocks of 128
    plan = fir_mod.plan_fir(1 << 20, 128, H100_SMS)
    assert tuple(plan) == (8, 128) and _blocks(1 << 20, plan) == 1024


def _cost(n, taps, rows, sms):
    rounds = _cdiv(_cdiv(n, 32 * rows), fir_mod.SCHEDULERS * sms)
    return rounds * (rows * taps + fir_mod.WARP_FIXED_PRODUCTS)


def test_plan_is_pure_and_covers_every_output_once():
    """The same arguments give the same plan; ``rows`` makes the modelled
    cost least (the larger on a tie); the threads are the fewest that
    cover the signal with one block per SM, capped at PLAN_THREADS, so no
    SM holds two blocks below the cap and every SM holds one at it."""
    for args in [(65_536, 128, 132), (1 << 20, 128, 132), (5, 3, 7)]:
        assert fir_mod.plan_fir(*args) == fir_mod.plan_fir(*args)
    for n in [1, 31, 32, 1000, 4097, 65_536, 70_001, 1 << 20, 3 << 20]:
        for taps in (1, 128, 5000):
            for sms in (1, 78, 132):
                plan = fir_mod.plan_fir(n, taps, sms)
                outs, blocks = plan.rows * plan.threads, _blocks(n, plan)
                assert plan.rows in fir_mod.ROWS
                best = min(_cost(n, taps, r, sms) for r in fir_mod.ROWS)
                assert _cost(n, taps, plan.rows, sms) == best
                assert all(_cost(n, taps, r, sms) > best
                           for r in fir_mod.ROWS if r > plan.rows)
                assert 1 <= plan.threads <= fir_mod.PLAN_THREADS <= fir_mod.MAX_THREADS
                assert (blocks - 1) * outs < n <= blocks * outs  # each output once
                if plan.threads < fir_mod.PLAN_THREADS:
                    assert plan.threads == _cdiv(n, plan.rows * sms)
                    assert blocks <= sms
                else:
                    assert blocks >= sms
    with pytest.raises(ValueError):
        fir_mod.plan_fir(0, 128, H100_SMS)
    with pytest.raises(ValueError):
        fir_mod.plan_fir(100, 0, H100_SMS)


def test_the_kernel_matches_the_binding():
    """The chunk, the most threads and the outputs a thread the kernel is
    compiled for (csrc/fir.cu) are the binding's, and its grid is the one
    ``_blocks`` counts."""
    src = CSRC.read_text()
    assert _const("kChunk") == fir_mod.CHUNK
    assert _const("kMaxThreads") == fir_mod.MAX_THREADS
    compiled = tuple(int(k) for k in re.findall(
        r"case (\d+): fir_kernel<T, S, \1>", src))
    assert compiled == fir_mod.ROWS
    assert "const long long outs = static_cast<long long>(threads) * rows;" in src
    assert "const int blocks = static_cast<int>((n + outs - 1) / outs);" in src


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fir_mod, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fir_mod, "stream_of", lambda t: None)
    monkeypatch.setattr(fir_ops, "on_card", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": H100_SMS}))
    return calls


@pytest.mark.parametrize("xdt,hdt,symbol,h16", [
    (torch.float32, torch.float32, "repro_fir_f32", None),
    (torch.int16, torch.int16, "repro_fir_i16", 1),
    (torch.int16, torch.int32, "repro_fir_i16", 0),
    (torch.int32, torch.int16, "repro_fir_i32", 1)])
def test_fir_on_the_card_is_one_launch_of_any_taps(monkeypatch, xdt, hdt, symbol, h16):
    """One launch with the plan's rows and threads, for 5000 taps too (no
    limit on the taps); int16 taps go to the kernel as they are, with no
    conversion launched before it."""
    calls = _record_launches(monkeypatch)
    for taps in (128, 5000):
        x, h = torch.zeros(65_536, dtype=xdt), torch.zeros(taps, dtype=hdt)
        y = fir_ops.fir(x, h)
        args = calls.pop()
        assert not calls and args[:2] == ("fir", symbol)
        plan = fir_mod.plan_fir(65_536, taps, H100_SMS)
        assert args[3].value == x.data_ptr() and args[4].value == h.data_ptr()
        if h16 is None:
            assert args[5].value == y.data_ptr()
            assert args[6:10] == (65_536, taps, plan.rows, plan.threads)
        else:
            assert args[5] == h16 and args[6].value == y.data_ptr()
            assert args[7:12] == (65_536, taps, FXP_SHIFT, plan.rows, plan.threads)


def test_an_empty_signal_launches_nothing(monkeypatch):
    calls = _record_launches(monkeypatch)
    y = fir_ops.fir(torch.zeros(0), torch.zeros(3))
    assert y.shape == (0,) and not calls
