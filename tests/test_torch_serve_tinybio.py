"""TinyBio batched and served through the port, on the CPU.

* The four TinyBio kernels' wrappers take a leading batch axis: their
  plain versions give every row the bits of the same row called alone
  (``fir`` f32 and Q15, ``delineate`` with extrema at the row edges,
  ``power_spectrum``, ``svm``), and agree with ``jax.vmap`` of the JAX
  package's plain versions (identical inputs: integer FIR and flags exact;
  f32 FIR within atol 1e-6, the spectrum within 1e-6 of its largest value,
  the SVM within rtol 1e-4 + atol 1e-5 — f32 sums taken in another order).
* On the card each batched call is ONE launch with the batch as its row
  count; with ``launch`` recorded instead of run, the wrappers, their
  ``torch.func.vmap`` and their custom ops' vmap and fake rules (on
  ``meta``) are held to that here.
* The batched TinyBio graph's modeled ``fused_modeled()`` equals the JAX
  package's for B = 1, 2, 4 (``==``), and TinyBio served at full size on
  the CPU gives every request the bits of its own ``APU.offload``, with one
  cache miss per lane, at warmup.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.apps import tinybio as jt
from repro.kernels.delineate.ref import delineate_ref as j_delineate_ref
from repro.kernels.fir.ref import fir_ref as j_fir_ref
from repro.kernels.stockham_fft.ref import stockham_fft_ref as j_fft_ref
from repro.kernels.svm.ref import svm_decision_ref as j_svm_ref
from repro_torch.apps import tinybio as tt
from repro_torch.kernels import common
from repro_torch.kernels.delineate import ops as dl_ops
from repro_torch.kernels.fir import fir as fir_mod
from repro_torch.kernels.fir import ops as fir_ops
from repro_torch.kernels.stockham_fft import ops as fft_ops
from repro_torch.kernels.svm import ops as svm_ops
from repro_torch.kernels.svm import svm as svm_mod

H100_SMS = 132
RNG = np.random.default_rng(20)
N = 1000
B = 4


def _f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


SIG = _f32(B, N)
TAPS = (np.hamming(17) / 17).astype(np.float32)
SIG16 = RNG.integers(-2 ** 15, 2 ** 15, (B, N)).astype(np.int16)
TAPS16 = RNG.integers(-2 ** 15, 2 ** 15, 33).astype(np.int16)
EDGY = SIG.copy()
EDGY[:, 0], EDGY[:, 1], EDGY[:, -2], EDGY[:, -1] = 9.0, -9.0, -9.0, 9.0
WIN = _f32(B, 8, 64)
QUERIES = RNG.uniform(-1, 1, (B, 16, 6)).astype(np.float32)
SV = (QUERIES[0][RNG.integers(0, 16, 24)] + 0.1 * _f32(24, 6)).astype(np.float32)
ALPHA = (_f32(24) / 24).astype(np.float32)


# ---------------------------------------------------------------------------
# the batched plain versions
# ---------------------------------------------------------------------------
def test_fir_rows_are_their_single_calls_and_match_jax():
    x, h = torch.from_numpy(SIG), torch.from_numpy(TAPS)
    y = fir_ops.fir(x, h)
    assert y.shape == (B, N)
    assert all(torch.equal(y[i], fir_ops.fir(x[i], h)) for i in range(B))
    want = np.asarray(jax.vmap(j_fir_ref, in_axes=(0, None))(SIG, TAPS))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-6)
    xi, hi = torch.from_numpy(SIG16), torch.from_numpy(TAPS16)
    yi = fir_ops.fir(xi, hi)
    assert yi.dtype == torch.int16
    assert all(torch.equal(yi[i], fir_ops.fir(xi[i], hi)) for i in range(B))
    np.testing.assert_array_equal(
        yi.numpy(), np.asarray(jax.vmap(j_fir_ref, in_axes=(0, None))(SIG16, TAPS16)))


def test_delineate_rows_keep_their_own_edges():
    x = torch.from_numpy(EDGY)
    flags = dl_ops.delineate(x, 0)
    assert flags.dtype == torch.int8 and flags.shape == (B, N)
    assert all(torch.equal(flags[i], dl_ops.delineate(x[i], 0)) for i in range(B))
    # endpoints are never extrema; the troughs beside them are
    assert (flags[:, 0] == 0).all() and (flags[:, -1] == 0).all()
    assert (flags[:, 1] == -1).all() and (flags[:, -2] == -1).all()
    # a flattened signal would flag row i's last sample against row i+1's
    flat = dl_ops.delineate(x.reshape(-1), 0).reshape(B, N)
    assert not torch.equal(flat, flags)
    np.testing.assert_array_equal(
        flags.numpy(), np.asarray(jax.vmap(lambda r: j_delineate_ref(r, 0))(EDGY)))


def test_power_spectrum_of_a_stack_and_svm_on_query_sets():
    w = torch.from_numpy(WIN)
    p = fft_ops.power_spectrum(w)
    assert p.shape == (B, 8, 64)
    assert all(torch.equal(p[i], fft_ops.power_spectrum(w[i])) for i in range(B))
    assert torch.equal(p[1, 3], fft_ops.power_spectrum(w[1, 3]))

    def j_power(row):
        re, im = j_fft_ref(row, jnp.zeros_like(row))
        return re * re + im * im
    want = np.asarray(jax.vmap(jax.vmap(j_power))(WIN))
    np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=1e-6 * float(want.max()))
    q, sv, alpha = (torch.from_numpy(a) for a in (QUERIES, SV, ALPHA))
    for b in (0.1, torch.tensor(0.1)):
        s = svm_ops.svm_decision(q, sv, alpha, b, 0.5)
        assert s.shape == (B, 16)
        assert all(torch.equal(s[i], svm_ops.svm_decision(q[i], sv, alpha, b, 0.5))
                   for i in range(B))
        want = np.asarray(jax.vmap(lambda x: j_svm_ref(x, SV, ALPHA, 0.1, 0.5))(QUERIES))
        assert float(np.abs(want - 0.1).max()) > 1e-3          # RBF signal
        np.testing.assert_allclose(s.numpy(), want, rtol=1e-4, atol=1e-5)


def test_wrappers_under_vmap_equal_their_batched_calls():
    x, h = torch.from_numpy(SIG), torch.from_numpy(TAPS)
    assert torch.equal(torch.func.vmap(lambda a: fir_ops.fir(a, h))(x),
                       fir_ops.fir(x, h))
    e = torch.from_numpy(EDGY)
    assert torch.equal(torch.func.vmap(lambda a: dl_ops.delineate(a, 0))(e),
                       dl_ops.delineate(e, 0))
    w = torch.from_numpy(WIN)
    assert torch.equal(torch.func.vmap(fft_ops.power_spectrum)(w),
                       fft_ops.power_spectrum(w))
    q, sv, alpha = (torch.from_numpy(a) for a in (QUERIES, SV, ALPHA))
    assert torch.equal(
        torch.func.vmap(lambda a: svm_ops.svm_decision(a, sv, alpha, 0.1, 0.5))(q),
        svm_ops.svm_decision(q, sv, alpha, 0.1, 0.5))


# ---------------------------------------------------------------------------
# one launch a batched call (launches recorded, not run)
# ---------------------------------------------------------------------------
@pytest.fixture
def recorded(monkeypatch):
    calls = []
    record = lambda *args: calls.append(args)
    for mod in (fir_mod, dl_ops, fft_ops, svm_mod):
        monkeypatch.setattr(mod, "launch", record)
        monkeypatch.setattr(mod, "stream_of", lambda t: None)
    for mod in (fir_ops, dl_ops, fft_ops, svm_ops):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": H100_SMS}))
    return calls


@pytest.mark.parametrize("vmapped", [False, True])
def test_each_batched_call_is_one_launch_with_the_batch_as_rows(recorded, vmapped):
    x, h = torch.from_numpy(SIG), torch.from_numpy(TAPS)
    xi, hi = torch.from_numpy(SIG16), torch.from_numpy(TAPS16)
    e, w = torch.from_numpy(EDGY), torch.from_numpy(WIN)
    q, sv, alpha = (torch.from_numpy(a) for a in (QUERIES, SV, ALPHA))
    lift = (lambda f: torch.func.vmap(f)) if vmapped else (lambda f: f)
    plan = fir_mod.plan_fir(N, 17, H100_SMS)

    lift(lambda a: fir_ops.fir(a, h))(x)
    (args,) = recorded
    assert args[:2] == ("fir", "repro_fir_f32")
    assert args[6:11] == (N, 17, plan.rows, plan.threads, B)
    recorded.clear()
    lift(lambda a: fir_ops.fir(a, hi))(xi)
    (args,) = recorded
    assert args[:2] == ("fir", "repro_fir_i16")
    assert args[7:13] == (N, 33, 15, *fir_mod.plan_fir(N, 33, H100_SMS), B)
    recorded.clear()
    lift(lambda a: dl_ops.delineate(a, 0))(e)
    (args,) = recorded
    assert args[:2] == ("delineate", "repro_delineate_f32") and args[5:9] == (N, 0.0, -0.0, B)
    recorded.clear()
    lift(fft_ops.power_spectrum)(w)
    (args,) = recorded
    assert args[:2] == ("stockham_fft", "repro_stockham_fft_f32")
    assert args[8:10] == (B * 8, 64)
    recorded.clear()
    lift(lambda a: svm_ops.svm_decision(a, sv, alpha, 0.1, 0.5))(q)
    (args,) = recorded
    assert args[:2] == ("svm", "repro_svm_f32")
    assert args[9:15] == (B * 16, 24, 6, 0.5, 1, svm_mod.plan_svm(B * 16, H100_SMS).queries)


def test_vmap_and_fake_rules_hold_on_meta():
    """The custom ops' fake rule gives shapes and dtypes on ``meta`` and
    their vmap rule folds the batch; nothing launches."""
    before = dict(common.LAUNCHES)
    m = lambda a: torch.from_numpy(a).to("meta")
    assert torch.func.vmap(lambda a: fir_ops.fir_card(a, m(TAPS)))(m(SIG)).shape == (B, N)
    f = torch.func.vmap(lambda a: dl_ops.delineate_card(a, 0))(m(EDGY))
    assert f.shape == (B, N) and f.dtype == torch.int8
    assert torch.func.vmap(fft_ops.power_spectrum_card)(m(WIN)).shape == (B, 8, 64)
    re, im = torch.func.vmap(lambda a: fft_ops.fft_card(a, None))(m(WIN))
    assert re.shape == im.shape == (B, 8, 64)
    s = torch.func.vmap(lambda a: svm_ops.svm_card(a, m(SV), m(ALPHA), None, 0.1, 0.5))(
        m(QUERIES))
    assert s.shape == (B, 16) and s.device.type == "meta"
    with pytest.raises(NotImplementedError, match="constants"):
        torch.func.vmap(fir_ops.fir_card)(m(SIG), m(np.ones((B, 3), np.float32)))
    assert common.LAUNCHES == before


# ---------------------------------------------------------------------------
# the batched TinyBio graph and the served pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_batched_tinybio_graph_models_like_the_reference(batch):
    n = tt.TINYBIO_WORKLOAD["n"]
    j_stages, _ = jt.tinybio_stages(jcore.EGPU_16T)
    t_stages, _ = tt.tinybio_stages(tcore.EGPU_16T, device="cpu")
    j_graph = jcore.APU(jcore.EGPU_16T, explicit_transfers=True).capture_pipeline(
        jserve.batched_stages(j_stages, batch), (jnp.zeros((batch, n), jnp.float32),))
    t_graph = tcore.APU(tcore.EGPU_16T, device="cpu",
                        explicit_transfers=True).capture_pipeline(
        tserve.batched_stages(t_stages, batch), (torch.zeros(batch, n),))
    (t_fused, t_energy), (j_fused, j_energy) = t_graph.fused_modeled(), j_graph.fused_modeled()
    assert dataclasses.asdict(t_fused) == dataclasses.asdict(j_fused)
    assert t_energy == j_energy
    assert [n_.kind for n_ in t_graph.nodes] == [n_.kind for n_ in j_graph.nodes]
    assert [tuple(a.shape) for a in t_graph.out_avals] == [(batch, 128)]
    assert t_graph.verify() == ()


@pytest.fixture(scope="module")
def served():
    """Four TinyBio requests at full size through a two-lane CPU server."""
    stages, _ = tt.tinybio_stages(tcore.EGPU_16T, device="cpu")
    n = tt.TINYBIO_WORKLOAD["n"]
    srv = tserve.Server(stages, workers=(tserve.QueueWorker(tcore.EGPU_16T, device="cpu"),
                                         tserve.QueueWorker(tcore.EGPU_8T, device="cpu")),
                        bucket_sizes=(n,), max_batch=2, device="cpu")
    warmed = srv.warmup(tt.synth_signal(n, 0))
    signals = [tt.synth_signal(n, s) for s in range(4)]
    rids = [srv.submit(s) for s in signals]
    srv.flush()
    return stages, srv, warmed, signals, [srv.result(r) for r in rids]


def test_served_tinybio_is_bit_equal_to_per_request_offloads(served):
    stages, srv, _, signals, outs = served
    apu = tcore.APU(tcore.EGPU_16T, device="cpu")
    for sig, (got,) in zip(signals, outs):
        (want,), _ = apu.offload(stages, (torch.from_numpy(sig),))
        assert got.shape == (128,) and torch.equal(got, want.data)


def test_served_tinybio_captures_once_per_lane(served):
    _, srv, warmed, _, _ = served
    assert warmed == 2
    stats = srv.cache.stats()
    assert (stats["misses"], stats["hits"], stats["verified"], stats["findings"]) == (2, 2, 2, 0)
    rep = srv.report()
    assert rep.n_requests == 4 and rep.n_batches == 2 and rep.avg_batch_fill == 1.0
    assert [q.batches for q in rep.queues] == [1, 1]
