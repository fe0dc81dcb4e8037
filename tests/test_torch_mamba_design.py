"""The algorithm of the port's Mamba selective-scan kernel, in plain
PyTorch, against the JAX package's oracle on the CPU, and the plan and
copy rule that choose how the kernel launches.

``csrc/mamba_scan.cu`` runs only on the card (``chip_smoke.py`` phase 2
holds it against the plain version there).  What can be checked here is its
algorithm: channel tiles of ``128 / lanes`` channels and runs of ``kRun``
steps, both with ragged tails (missing channels and steps as zeros, never
computed into y or the state); the N states of a channel split over
``lanes`` threads, each summing its share of y in order and the shares
meeting by a butterfly; decays ``2^(delta * a log2 e)``.
``staged_lane_scan`` below is that algorithm step for step, with the
kernel's constants read from its source; nothing but this test uses it.
It takes the same numpy inputs, made from a seed, as the JAX oracle
``repro.kernels.mamba_scan.ref.mamba_scan_ref`` (the exact sequential scan)
and the port's ``mamba_scan_plain``, with decays drawn near 1 (delta * a
in [-1e-3, -1e-5]), at jamba's own ranges (delta in [1e-3, 1e-2], a in
[-16, -1]: decays of 0.85 to 0.999), near 0 (down to below 2^-127, where
2^z is 0) and between.

Tolerance: 1e-5 of the largest magnitude of y and of the state, as
``chip_smoke.py`` phase 2 holds the kernel against the plain version (the
same f32 sums in another order, and 2^z in place of exp; the kernel's
fused multiply-adds are a multiply and an add here, a rounding apart).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_scan_ref
from repro_torch.kernels.mamba_scan import mamba_scan as mm
from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain

RTOL = 1e-5
SOURCE = (Path(mm.__file__).resolve().parents[2] / "csrc" / "mamba_scan.cu").read_text()


def _constant(name, kind=float):
    m = re.search(rf"\b{name} = ([-+0-9.e]+)f?[,;]", SOURCE)
    assert m, f"{name} not found in csrc/mamba_scan.cu"
    return kind(m.group(1))


RUN = _constant("kRun", int)
THREADS = _constant("kThreads", int)
F32 = torch.float32


def staged_lane_scan(x, delta, a, b, c, state0, lanes):
    """The kernel's algorithm: x/delta (B,T,Dm), a (Dm,N), b/c (B,T,N) f32,
    state0 (B,Dm,N) or None -> (y (B,T,Dm), state (B,Dm,N))."""
    bsz, t, dm = x.shape
    n = a.shape[1]
    s = n // lanes                                   # states per thread
    ch_tile = THREADS // lanes
    y = torch.zeros(bsz, t, dm)
    state = torch.zeros(bsz, dm, n)
    a_log2e = a * torch.tensor(math.log2(math.e), dtype=F32)
    for ch0 in range(0, dm, ch_tile):
        live = min(ch_tile, dm - ch0)

        def tile(z, axis):                           # zeros past Dm
            z = z.narrow(axis, ch0, live)
            pad = list(z.shape)
            pad[axis] = ch_tile - live
            return torch.cat([z, torch.zeros(pad)], axis)

        ap = tile(a_log2e, 0)                        # (C, N)
        h = torch.zeros(bsz, ch_tile, n) if state0 is None else tile(state0, 1)
        xs, ds = tile(x, 2), tile(delta, 2)
        for t0 in range(0, t, RUN):
            for tt in range(min(RUN, t - t0)):
                step = t0 + tt
                dt = ds[:, step]                     # (B, C)
                dx = dt * xs[:, step]
                parts = []
                for part in range(lanes):
                    acc = torch.zeros(bsz, ch_tile)
                    for j in range(s):
                        k = part * s + j
                        z = dt * ap[None, :, k]
                        da = torch.exp2(z)
                        h[:, :, k] = da * h[:, :, k] + dx * b[:, step, None, k]
                        acc = h[:, :, k] * c[:, step, None, k] + acc
                    parts.append(acc)
                while len(parts) > 1:                # butterfly, xor 1 then 2
                    parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
                y[:, step, ch0:ch0 + live] = parts[0][:, :live]
        state[:, ch0:ch0 + live] = h[:, :live]
    return y, state


@pytest.fixture(scope="module", autouse=True)
def _warm_intra_op_threads():
    """One vectorized exp on every intra-op thread before any comparison.
    On some x86 CPU hosts the first such call of a process (torch 2.13,
    CPU) has been seen to return values about 1e-4 off over one thread's
    share of the tensor, and no later call; mamba_scan_plain's first exp
    would then disagree with the other two scans."""
    torch.exp(-torch.rand(1 << 20))


def _inputs(seed, bsz, t, dm, n, decay, with_state):
    rng = np.random.default_rng(seed)
    f = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(np.float32)
    if decay == "near 1":
        delta = rng.uniform(1e-3, 1e-2, (bsz, t, dm))
        a = -rng.uniform(1e-2, 1e-1, (dm, n))
    elif decay == "jamba":
        delta = rng.uniform(1e-3, 1e-2, (bsz, t, dm))
        a = -rng.uniform(1.0, 16.0, (dm, n))
    elif decay == "near 0":
        delta = rng.uniform(1.0, 5.0, (bsz, t, dm))
        a = -rng.uniform(5.0, 30.0, (dm, n))
    else:                                            # chip_smoke's draw
        delta = np.abs(0.3 * rng.standard_normal((bsz, t, dm))) + 0.1
        a = -(np.abs(rng.standard_normal((dm, n))) + 0.1)
    s0 = rng.standard_normal((bsz, dm, n)).astype(np.float32) if with_state else None
    return (f(bsz, t, dm), delta.astype(np.float32), a.astype(np.float32),
            f(bsz, t, n), f(bsz, t, n), s0)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("decay", ["mixed", "near 1", "jamba", "near 0"])
@pytest.mark.parametrize("n,lanes", [(16, 1), (16, 2), (32, 4), (32, 2),
                                     (8, 1), (2, 1), (4, 1)])
def test_staged_lane_algorithm_matches_jax(n, lanes, decay, with_state):
    bsz, t, dm = 2, 37, 70                           # ragged in T and Dm
    x, delta, a, b, c, s0 = _inputs(n * 10 + lanes, bsz, t, dm, n, decay,
                                    with_state)
    tx = [torch.from_numpy(z) for z in (x, delta, a, b, c)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = staged_lane_scan(*tx, ts0, lanes)
    jy, js = j_mamba_scan_ref(*(jnp.asarray(z) for z in (x, delta, a, b, c)),
                              jnp.zeros(dm, jnp.float32),
                              None if s0 is None else jnp.asarray(s0))
    assert y.shape == (bsz, t, dm) and s.shape == (bsz, dm, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close(y, jy)
    _close(s, js)
    py, ps = mamba_scan_plain(*tx, ts0)
    _close(y, py)
    _close(s, ps)


@pytest.mark.parametrize("t,dm", [(0, 64), (1, 300), (16, 128), (17, 129)])
def test_staged_runs_and_tiles_match_jax_at_the_edges(t, dm):
    """T = 0 (the state passes through), one step, whole runs and tiles,
    and one step or channel past them."""
    x, delta, a, b, c, s0 = _inputs(t + dm, 1, t, dm, 16, "mixed", True)
    tx = [torch.from_numpy(z) for z in (x, delta, a, b, c)]
    y, s = staged_lane_scan(*tx, torch.from_numpy(s0), 1)
    jy, js = j_mamba_scan_ref(*(jnp.asarray(z) for z in (x, delta, a, b, c)),
                              jnp.zeros(dm, jnp.float32), jnp.asarray(s0))
    assert y.shape == (1, t, dm)
    if t:
        _close(y, jy)
    _close(s, js)


H100_SMS = 132
JAMBA = (16384, 16)                                  # d_inner, d_state


def test_plan_mamba_is_a_pure_function_of_its_arguments():
    plans = {(b, t): mm.plan_mamba(b, t, *JAMBA, H100_SMS)
             for b, t in ((4, 256), (2, 128), (1, 4096))}
    assert [p.lanes for p in plans.values()] == [2, 2, 2]
    for (b, t), plan in plans.items():
        assert mm.plan_mamba(b, t, *JAMBA, H100_SMS) == plan
        assert plan.channels * plan.lanes == mm.THREADS
        assert plan.blocks == b * -(-JAMBA[0] // plan.channels)
    # the lanes (the order of y's sum over N) do not depend on the batch:
    # the decode engine's batch-1 prefill and greedy_generate's batch of
    # six give a row the same bits
    for t in (7, 256, 4096):
        for dm, n in (JAMBA, (300, 16), (1024, 32), (4096, 32)):
            lanes = {mm.plan_mamba(b, t, dm, n, H100_SMS).lanes
                     for b in (1, 2, 4, 6, 64)}
            assert len(lanes) == 1, (t, dm, n, lanes)


@pytest.mark.parametrize("b,t", [(1, 4096), (4, 256), (2, 128)])
def test_plan_mamba_covers_the_card(b, t):
    """At least 4 warps an SM (the plan aims at WARPS_PER_SM, or
    WARPS_PER_SM_LONG for a long scan), and the last wave's imbalance
    small: the busiest SM holds at most 5 % more blocks than the mean."""
    plan = mm.plan_mamba(b, t, *JAMBA, H100_SMS)
    target = mm.WARPS_PER_SM_LONG if t >= mm.LONG_SCAN else mm.WARPS_PER_SM
    assert plan.warps_per_sm >= max(4, target)
    per_sm = plan.blocks / H100_SMS
    assert math.ceil(per_sm) / per_sm <= 1.05
    assert b * JAMBA[0] * plan.lanes == plan.blocks * mm.THREADS


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_plan_mamba_keeps_8_to_16_states_a_lane_where_n_allows(n):
    assert mm.lane_choices(n) == {2: (1,), 4: (1,), 8: (1,), 16: (1, 2),
                                  32: (2, 4)}[n]
    for b, dm in ((1, 64), (1, 16384), (64, 16384)):
        plan = mm.plan_mamba(b, 100, dm, n, H100_SMS)
        assert plan.lanes in mm.lane_choices(n)
        assert min(n, 8) <= n // plan.lanes <= 16
        # no fewer lanes would reach the warp target with one batch row
        assert plan.lanes == min(mm.lane_choices(n)) or (
            dm * plan.lanes // 2 < mm.WARPS_PER_SM * H100_SMS * 32)
    with pytest.raises(ValueError, match="compiled for N"):
        mm.plan_mamba(1, 8, 64, 64, H100_SMS)
    with pytest.raises(ValueError, match="positive sizes"):
        mm.plan_mamba(0, 8, 64, n, H100_SMS)


@pytest.mark.parametrize("dm,itemsize,offset,want", [
    (16384, 2, 0, True), (16384, 4, 0, True), (300, 2, 0, False),
    (300, 4, 0, True), (8, 2, 0, True), (7, 4, 0, False), (64, 2, 2, False),
    (64, 4, 8, False)])
def test_rows_16b_is_the_kernels_copy_rule(dm, itemsize, offset, want):
    """16-byte copies need a 16-byte aligned base and Dm * itemsize a
    multiple of 16 (csrc/mamba_scan.cu:rows_16b refuses copy16 otherwise):
    a bf16 row of Dm = 300 (600 bytes) is streamed one element at a time."""
    assert mm.rows_16b(256 + offset, dm, itemsize) is want


@pytest.mark.parametrize("dtype,dm,view_offset,copy16", [
    (torch.bfloat16, 16384, 0, 1), (torch.bfloat16, 300, 0, 0),
    (torch.float32, 300, 0, 1), (torch.bfloat16, 64, 1, 0)])
def test_launch_passes_the_plan_and_the_copy_rule(monkeypatch, dtype, dm,
                                                  view_offset, copy16):
    """The binding hands the kernel plan_mamba's lanes and rows_16b's
    verdict on x and delta (an x one element into its storage included)."""
    calls = []
    monkeypatch.setattr(mm, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(mm, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": H100_SMS}))
    bsz, t, n = 2, 5, 16
    x = torch.zeros(bsz * t * dm + view_offset, dtype=dtype)[view_offset:]
    x = x.view(bsz, t, dm)
    delta = torch.zeros(bsz, t, dm)
    a = torch.zeros(dm, n)
    bm = cm = torch.zeros(bsz, t, n)
    mm.launch_mamba_scan(x, delta, a, bm, cm, None, torch.empty_like(x),
                         torch.empty(bsz, dm, n))
    (args,) = calls
    assert args[0] == "mamba_scan"
    lanes, flag = args[-4], args[-3]
    assert lanes == mm.plan_mamba(bsz, t, dm, n, H100_SMS).lanes
    assert flag == copy16


@pytest.mark.parametrize("n,lanes", [(16, 1), (16, 2), (32, 4), (2, 1)])
def test_launch_takes_the_callers_lanes(monkeypatch, n, lanes):
    """``lanes=`` (what bench_mamba_scan.py --lanes times) reaches the
    kernel in place of the plan's; a count the kernel is not compiled for
    at this N raises before anything launches."""
    calls = []
    monkeypatch.setattr(mm, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(mm, "stream_of", lambda t: None)
    bsz, t, dm = 1, 5, 64
    x = delta = torch.zeros(bsz, t, dm)
    bm = cm = torch.zeros(bsz, t, n)
    args = (x, delta, torch.zeros(dm, n), bm, cm, None, torch.empty_like(x),
            torch.empty(bsz, dm, n))
    mm.launch_mamba_scan(*args, lanes=lanes)
    assert calls[0][-4] == lanes
    bad = {2: 2, 16: 4, 32: 1}[n]
    with pytest.raises(ValueError, match="takes lanes"):
        mm.launch_mamba_scan(*args, lanes=bad)
    assert len(calls) == 1
