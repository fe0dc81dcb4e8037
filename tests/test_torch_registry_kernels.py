"""The registry's last two families (decode_attention, mamba_scan) and the
rwkv6_scan counts, the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX ops (their XLA
paths, ``impl="xla"``, which is what JAX runs off a TPU; the Pallas kernels
in interpret mode where the test says so) and through the port's wrappers on
CPU tensors, which run the kernels' plain PyTorch versions.

Tolerances: the same f32 arithmetic summed in another order, so 2e-5
absolute on outputs of magnitude about 1 (decode attention, mamba outputs
and states); the unnormalized partial sums (acc, l), which grow with T,
within 1e-5 of their largest magnitude.  Work counts, the registry's
families and the modeled reports of an offload are equal (``==``).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
from repro.core.program import BUILTIN_FAMILIES as J_FAMILIES
from repro.kernels.decode_attention.ops import combine_partials as j_combine
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import counts as j_decode_counts
from repro.kernels.decode_attention.ref import \
    decode_attention_partial_ref as j_partial
from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba
from repro.kernels.mamba_scan.ref import counts as j_mamba_counts
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_ref
from repro.kernels.mamba_scan.ref import mamba_step_ref as j_mamba_step
from repro.kernels.rwkv6_scan.ref import counts as j_rwkv_counts
import repro_torch.core as tcore
from repro_torch.core.program import BUILTIN_FAMILIES
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.decode_attention.ops import (combine_partials,
                                                      decode_attention)
from repro_torch.kernels.decode_attention.ref import \
    counts as decode_counts
from repro_torch.kernels.mamba_scan.mamba_scan import COMPILED_N
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.mamba_scan.ref import counts as mamba_counts
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_plain,
                                                mamba_scan_ref, mamba_step_ref)
from repro_torch.kernels.rwkv6_scan.ref import counts as rwkv_counts

ATOL = 2e-5
PARTIAL_RTOL = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _qkv(seed, b, h, kvh, t, dk, dv=None):
    rng = np.random.default_rng(seed)
    dv = dk if dv is None else dv
    return (rng.standard_normal((b, h, dk)).astype(np.float32),
            rng.standard_normal((b, kvh, t, dk)).astype(np.float32),
            rng.standard_normal((b, kvh, t, dv)).astype(np.float32))


def _ssm(seed, b, t, dm, n):
    """Inputs in the ranges of tests/test_kernels.py: delta > 0, a < 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return (f(b, t, dm, sc=0.5), np.abs(f(b, t, dm, sc=0.3)) + 0.1,
            -np.abs(f(dm, n)) - 0.1, f(b, t, n, sc=0.5), f(b, t, n, sc=0.5),
            f(dm, sc=0.5), f(b, dm, n))


# -- decode attention ----------------------------------------------------------
# the shapes of tests/test_kernels.py, a ragged T, Dk != Dv and an MQA group
@pytest.mark.parametrize("b,h,kvh,t,dk,dv", [
    (2, 4, 2, 512, 64, 64), (1, 8, 8, 128, 32, 32), (2, 16, 2, 300, 128, 128),
    (1, 6, 1, 77, 96, 48)])
def test_decode_attention_plain_matches_jax(b, h, kvh, t, dk, dv):
    arrs = _qkv(b + h + t, b, h, kvh, t, dk, dv)
    got = decode_attention(*_t(*arrs))
    assert got.shape == (b, h, dv) and got.dtype == torch.float32
    want = np.asarray(j_decode(*_j(*arrs), impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the TPU kernel in interpret mode (T block-aligned there)
    if t % 128 == 0:
        pallas = np.asarray(j_decode(*_j(*arrs), impl="pallas"))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)


def test_decode_attention_partial_and_combine_match_jax():
    """partial=True gives the unnormalized (acc, m, l); combining 4 T-shards
    equals the full result, in both packages."""
    arrs = _qkv(1, 2, 4, 2, 256, 32)
    q, k, v = _t(*arrs)
    acc, m, l = decode_attention(q, k, v, partial=True)
    ja, jm, jl = (np.asarray(x) for x in j_partial(*_j(*arrs)))
    for got, want in ((acc, ja), (m, jm), (l, jl)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PARTIAL_RTOL * np.abs(want).max())
    shards = [decode_attention(q, k[:, :, i * 64:(i + 1) * 64],
                               v[:, :, i * 64:(i + 1) * 64], partial=True)
              for i in range(4)]
    merged, _, _ = combine_partials(shards)
    np.testing.assert_allclose(merged.numpy(),
                               decode_attention(q, k, v).numpy(),
                               rtol=0, atol=ATOL)
    jshards = [j_partial(*_j(arrs[0], arrs[1][:, :, i * 64:(i + 1) * 64],
                             arrs[2][:, :, i * 64:(i + 1) * 64]))
               for i in range(4)]
    jmerged = np.asarray(j_combine(jshards)[0])
    np.testing.assert_allclose(merged.numpy(), jmerged, rtol=0, atol=ATOL)


def test_decode_attention_bf16_keeps_q_dtype_within_one_ulp():
    arrs = _qkv(2, 2, 8, 2, 128, 64)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    got = decode_attention(*bf)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_decode(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                               impl="xla").astype(jnp.float32))
    g = got.float().numpy()
    assert (np.abs(g - want) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(want))
            + 1e-6).all()


def test_decode_attention_checks_shapes_and_runs_on_meta():
    q, k, v = _t(*_qkv(3, 1, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="do not fit"):
        decode_attention(q, k[:, :1].expand(1, 3, 16, 8), v[:, :1].expand(1, 3, 16, 8))
    with pytest.raises(ValueError, match="T >= 1"):
        decode_attention(q, k[:, :, :0], v[:, :, :0])
    before = dict(LAUNCHES)
    out = decode_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    acc, m, l = decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                 partial=True)
    assert out.device.type == "meta" and out.shape == (1, 4, 8)
    assert (acc.shape, m.shape, l.shape) == ((1, 4, 8), (1, 4, 1), (1, 4, 1))
    assert LAUNCHES == before


# -- mamba scan ----------------------------------------------------------------
@pytest.mark.parametrize("b,t,dm,n", [(1, 32, 16, 8), (2, 64, 32, 16),
                                      (2, 100, 24, 16), (1, 1, 8, 2)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_scan_plain_matches_jax(b, t, dm, n, with_state):
    x, delta, a, bb, cc, d, s0 = _ssm(b + t + dm, b, t, dm, n)
    state = s0 if with_state else None
    y, h = mamba_scan(*_t(x, delta, a, bb, cc, d),
                      None if state is None else _t(state)[0])
    jy, jh = j_mamba(*_j(x, delta, a, bb, cc, d),
                     None if state is None else jnp.asarray(state), impl="xla")
    assert y.dtype == torch.float32 and h.shape == (b, dm, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    # the oracle, sequential over T, both packages
    ry, rh = mamba_scan_ref(*_t(x, delta, a, bb, cc, d),
                            None if state is None else _t(state)[0])
    jry, jrh = j_mamba_ref(*_j(x, delta, a, bb, cc, d),
                           None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=0, atol=ATOL)


def test_mamba_scan_matches_the_tpu_kernel_in_interpret_mode():
    x, delta, a, bb, cc, d, _ = _ssm(4, 2, 128, 128, 16)
    y, h = mamba_scan(*_t(x, delta, a, bb, cc, d))
    jy, jh = j_mamba(*_j(x, delta, a, bb, cc, d), impl="pallas")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=ATOL)


def test_mamba_step_and_bf16_dtype_rule_match_jax():
    x, delta, a, bb, cc, d, s0 = _ssm(5, 2, 1, 16, 8)
    y, h = mamba_step_ref(*_t(x[:, 0], delta[:, 0], a, bb[:, 0], cc[:, 0], d,
                              s0))
    jy, jh = j_mamba_step(*_j(x[:, 0], delta[:, 0], a, bb[:, 0], cc[:, 0], d,
                              s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    # what the jamba block passes under bf16: x bf16, the rest f32
    x, delta, a, bb, cc, d, _ = _ssm(6, 2, 40, 16, 16)
    y, h = mamba_scan(torch.from_numpy(x).to(torch.bfloat16),
                      *_t(delta, a, bb, cc, d))
    jy, jh = j_mamba(jnp.asarray(x, jnp.bfloat16), *_j(delta, a, bb, cc, d),
                     impl="xla")
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    g, w = y.float().numpy(), np.asarray(jy.astype(jnp.float32))
    assert (np.abs(g - w) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
            + 1e-6).all()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=ATOL)


def test_mamba_plain_chains_state_across_calls():
    """Two halves chained through the state equal the whole scan."""
    x, delta, a, bb, cc, _, _ = _ssm(7, 1, 64, 16, 8)
    xt, dt, at, bt, ct = _t(x, delta, a, bb, cc)
    y, h = mamba_scan_plain(xt, dt, at, bt, ct)
    y1, h1 = mamba_scan_plain(xt[:, :40], dt[:, :40], at, bt[:, :40], ct[:, :40])
    y2, h2 = mamba_scan_plain(xt[:, 40:], dt[:, 40:], at, bt[:, 40:],
                              ct[:, 40:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=0, atol=ATOL)


def test_mamba_scan_checks_and_meta_shapes():
    x, delta, a, bb, cc, d, _ = _t(*_ssm(8, 1, 8, 8, 4))
    with pytest.raises(ValueError, match="do not fit"):
        mamba_scan(x, delta, a, bb[:, :, :3], cc, d)
    before = dict(LAUNCHES)
    y, h = mamba_scan(*(z.to("meta") for z in (x, delta, a, bb, cc, d)))
    assert y.device.type == "meta" and (y.shape, h.shape) == ((1, 8, 8),
                                                              (1, 8, 4))
    assert LAUNCHES == before
    assert 16 in COMPILED_N and 2 in COMPILED_N


# -- work counts -----------------------------------------------------------------
@pytest.mark.parametrize("family", ["decode_attention", "mamba_scan",
                                    "rwkv6_scan"])
def test_counts_equal_reference(family):
    cases = {
        "decode_attention": (decode_counts, j_decode_counts,
                             [(4, 16, 512, 128, 128, 2), (1, 8, 77, 32, 48, 4)]),
        "mamba_scan": (mamba_counts, j_mamba_counts,
                       [(4, 256, 16384, 16, 4), (1, 7, 33, 2, 2)]),
        "rwkv6_scan": (rwkv_counts, j_rwkv_counts,
                       [(4, 40, 256, 64, 4), (1, 3, 1, 32, 2)]),
    }
    ours, theirs, args = cases[family]
    for a in args:
        assert dataclasses.asdict(ours(*a)) == dataclasses.asdict(theirs(*a))


# -- the registry ------------------------------------------------------------------
def test_registry_lists_the_reference_families_memoized():
    assert sorted(BUILTIN_FAMILIES) == sorted(J_FAMILIES)
    assert len(BUILTIN_FAMILIES) == 7
    for cfg in ("EGPU_8T", "EGPU_16T"):
        prog = tcore.Program.build(getattr(tcore, cfg))
        for family in ("decode_attention", "mamba_scan"):
            kern = prog.create_kernel(family)
            assert (kern.family, kern.config) == (family, getattr(tcore, cfg))
            assert kern is tcore.Program.build(getattr(tcore, cfg)).create_kernel(family)
            assert kern.counts is not None
    p16 = tcore.Program.build(tcore.EGPU_16T)
    assert p16.create_kernel("mamba_scan") is p16.create_kernel("mamba_scan", chunk=64)
    assert p16.create_kernel("mamba_scan") is not p16.create_kernel("mamba_scan", chunk=32)
    assert set(BUILTIN_FAMILIES) <= set(p16.create_kernels())


def _family_inputs(family):
    """tests/test_program.py's sample invocation for the two families."""
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    if family == "mamba_scan":
        return (f32(1, 32, 4), np.abs(f32(1, 32, 4)) * 0.1,
                -np.abs(f32(4, 2)), f32(1, 32, 2), f32(1, 32, 2), f32(4))
    return (f32(1, 2, 8), f32(1, 2, 16, 8), f32(1, 2, 16, 8))


@pytest.mark.parametrize("family", ["decode_attention", "mamba_scan"])
def test_registry_executors_match_the_reference_executors(family):
    ins = _family_inputs(family)
    got = tcore.Program.build(tcore.EGPU_16T).create_kernel(family).executor(*_t(*ins))
    want = jcore.Program.build(jcore.EGPU_16T).create_kernel(
        family, use_pallas=False).executor(*_j(*ins))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    legacy = importlib.import_module(BUILTIN_FAMILIES[family]).build_kernel(
        tcore.EGPU_16T)
    again = legacy.executor(*_t(*ins))
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# the registry path on a queue and through APU.offload, at the sizes
# chip_smoke.py's registry phase uses, cut down
OFFLOADS = {
    "decode_attention": (lambda: _qkv(9, 2, 8, 2, 64, 32),
                         {"b": 2, "h": 8, "t": 64, "dk": 32, "dv": 32,
                          "itemsize": 4}),
    "mamba_scan": (lambda: _ssm(10, 2, 40, 64, 16)[:6],
                   {"bsz": 2, "t": 40, "dm": 64, "n": 16}),
}


@pytest.mark.parametrize("preset", ["EGPU_4T", "EGPU_8T", "EGPU_16T"])
@pytest.mark.parametrize("family", sorted(OFFLOADS))
def test_registry_offload_reports_equal_the_reference(family, preset):
    make, cp = OFFLOADS[family]
    ins = make()
    jcfg, tcfg = getattr(jcore, preset), getattr(tcore, preset)
    jstage = jcore.Stage(jcore.Program.build(jcfg).create_kernel(family),
                         counts_params=cp)
    tstage = tcore.Stage(tcore.Program.build(tcfg).create_kernel(family),
                         counts_params=cp)
    before = dict(LAUNCHES)
    for mode in ("graph", "eager"):
        jout, jrep = jcore.APU(jcfg).offload([jstage], _j(*ins), mode=mode)
        tout, trep = tcore.APU(tcfg, device="cpu").offload([tstage], ins,
                                                           mode=mode)
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep), mode
        assert len(tout) == len(jout)
        for g, w in zip(tout, jout):
            np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data),
                                       rtol=0, atol=ATOL)
    # through a CommandQueue: the same outputs as the op
    ctx = tcore.Context(tcore.Device(tcfg), "cpu")
    kern = tcore.Program.build(tcfg).create_kernel(family)
    kern.set_args(*_t(*ins))
    ev = tcore.CommandQueue(ctx).enqueue_kernel(kern, counts_params=cp)
    outs = ev.wait()
    direct = kern.executor(*_t(*ins))
    direct = direct if isinstance(direct, tuple) else (direct,)
    assert all(torch.equal(o.data, d) for o, d in zip(outs, direct))
    assert LAUNCHES == before                  # the CPU runs no kernel
