"""The queue's options and ``create_buffer``'s adoption rules, the port
against the JAX package, on the CPU.

``CommandQueue(ctx, profile=, blocking=, max_events=, out_of_order=, ...)``,
``blocking=`` on the transfer commands, ``flush()``, ``Event.dispatch_s`` /
``wall_s`` and ``Context.create_buffer(data, flags, copy=, use_host_ptr=)``.
Each test of the JAX package's own suite that pins one of them has its case
here, run through both packages on the same numpy inputs; the option grid
then replays one command stream over the registry's GeMM and TinyBio
families through a JAX queue and a port queue under every combination.

Tolerance: ``==`` for every modeled float (the machine model is the same
Python over the same counts), event counts and release counts; bits for
outputs where both sides compute in the same order, else the stated rtol.
The card path of ``blocking=`` (a wait on the launch's own recorded CUDA
event) is checked with a stand-in event object; ``chip_smoke.py`` phase 4d
drives it on the card.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs as jobs
import repro_torch.core as tcore
import repro_torch.core.runtime as truntime
import repro_torch.obs as tobs
from repro.kernels.gemm.ref import counts as j_gemm_counts
from repro.kernels.gemm.ref import gemm_ref as j_gemm_ref
from repro_torch.kernels.gemm.ref import counts as t_gemm_counts
from repro_torch.kernels.gemm.ref import gemm_ref as t_gemm_ref


class Pkg:
    """One package's side of a comparison: its core module and array
    constructor (a CPU context for the port)."""

    def __init__(self, name):
        self.name = name
        self.core = jcore if name == "jax" else tcore
        self.obs = jobs if name == "jax" else tobs

    def ctx(self, cfg="EGPU_16T"):
        dev = self.core.Device(getattr(self.core, cfg))
        return (self.core.Context(dev) if self.name == "jax"
                else self.core.Context(dev, "cpu"))

    def array(self, a):
        return jnp.asarray(a) if self.name == "jax" else torch.from_numpy(
            np.ascontiguousarray(a))

    def ndr(self):
        return self.core.NDRange((8, 8), (4, 4))

    def mm_kernel(self, d=8, seed=0):
        """The reference's ``mlp`` test kernel: relu(x @ w), gemm counts."""
        w = (np.random.default_rng(seed).standard_normal((d, d)) * 0.2
             ).astype(np.float32)
        if self.name == "jax":
            jw = jnp.asarray(w)
            fn = lambda x: jnp.maximum(j_gemm_ref(x, jw), 0.0)
            counts = lambda **kw: j_gemm_counts(m=d, n=d, k=d)
        else:
            tw = torch.from_numpy(w)
            fn = lambda x: torch.clamp_min(t_gemm_ref(x, tw), 0.0)
            counts = lambda **kw: t_gemm_counts(m=d, n=d, k=d)
        return self.core.Kernel("mlp", executor=fn, counts=counts)

    def counts_kernel(self):
        """The reference's ``twice`` test kernel (fixed work counts)."""
        return self.core.Kernel(
            "twice", executor=lambda x: x * 2,
            counts=lambda **kw: self.core.WorkCounts(
                ops=64, dcache_bytes=256, host_bytes=256, working_set=256))

    def numpy(self, t):
        return np.asarray(t) if self.name == "jax" else t.numpy()


JAX, PORT = Pkg("jax"), Pkg("torch")
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
ONES = np.ones((8, 8), np.float32)


# -- tests/test_runtime_async.py: the unprofiled and the blocking queue -------
def _unprofiled_finish(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, profile=False)
    a = ctx.create_buffer(P.array(ONES))
    evs = [q.enqueue_nd_range(P.mm_kernel(), P.ndr(), (a,)) for _ in range(3)]
    assert not any(e.done for e in evs)
    q.finish()
    assert q.events == () and q.released_count == 3
    assert all(e.done and e.released and e.outputs == () for e in evs)
    assert all(e.modeled is None and e.energy_j is None for e in evs)
    # the queue keeps working after a release sweep
    e = q.enqueue_nd_range(P.mm_kernel(), P.ndr(), (a,))
    q.finish()
    assert e.done and q.released_count == 4
    return q.released_count, q.total_modeled_s(), q.total_energy_j()


def test_unprofiled_finish_releases_events():
    assert _unprofiled_finish(PORT) == _unprofiled_finish(JAX) == (4, 0.0, 0.0)


@BOTH
def test_blocking_queue_syncs_each_launch(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, profile=False, blocking=True)
    a = ctx.create_buffer(P.array(ONES))
    ev = q.enqueue_nd_range(P.mm_kernel(), P.ndr(), (a,))
    assert ev.done and ev.deps == ()
    (out,) = ev.wait()
    assert out.shape == (8, 8)


def test_blocking_queue_outputs_equal_the_async_queue():
    x = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    outs = {}
    for blocking in (False, True):
        ctx = PORT.ctx()
        q = tcore.CommandQueue(ctx, profile=False, blocking=blocking)
        cur = ctx.create_buffer(torch.from_numpy(x))
        for _ in range(4):
            cur = q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(),
                                     (cur,)).outputs[0]
        q.finish()
        outs[blocking] = cur.data
    assert torch.equal(outs[False], outs[True])


# -- the card path of blocking=: a wait on the launch's own event ----------------
class _DeviceDone:
    """Stands in for the ``torch.cuda.Event`` recorded behind a launch."""

    def __init__(self, log, delay_s=0.0):
        self.log, self.delay_s = log, delay_s

    def synchronize(self):
        time.sleep(self.delay_s)
        self.log.append(self)


def _spy_queue(monkeypatch, blocking, delay_s=0.0):
    log, made = [], []

    def record_done(outputs):
        made.append(_DeviceDone(log, delay_s))
        return made[-1]

    def device_wide(*a, **k):
        raise AssertionError("blocking must not synchronize the whole device")

    monkeypatch.setattr(truntime, "_record_done", record_done)
    monkeypatch.setattr(torch.cuda, "synchronize", device_wide)
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx, blocking=blocking)
    return ctx, q, log, made


def test_blocking_waits_on_the_launchs_own_event(monkeypatch):
    ctx, q, log, made = _spy_queue(monkeypatch, True, delay_s=0.005)
    a = ctx.create_buffer(torch.ones(8, 8))
    evs = []
    for _ in range(3):
        evs.append(q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(), (a,)))
        # waited inside the enqueue, on this launch's event and no other
        assert log == made and evs[-1].done and evs[-1].deps == ()
        assert evs[-1]._device_done is None
    # dispatch_s is taken after the wait on a blocking queue
    assert all(e.dispatch_s >= 0.005 and e.wall_s == e.dispatch_s for e in evs)
    q.finish()
    assert len(log) == 3                 # nothing left to wait at finish


def test_async_enqueue_leaves_the_wait_to_finish(monkeypatch):
    ctx, q, log, made = _spy_queue(monkeypatch, False, delay_s=0.005)
    a = ctx.create_buffer(torch.ones(8, 8))
    evs = [q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(), (a,))
           for _ in range(3)]
    assert log == [] and not any(e.done for e in evs)
    # the wall of an async enqueue is the host's enqueue only
    assert all(0.0 <= e.dispatch_s < 0.005 for e in evs)
    q.flush()                            # clFlush: nothing left to submit
    assert log == []
    q.finish()
    assert sorted(map(id, log)) == sorted(map(id, made))
    assert all(e.done for e in evs)


def test_blocking_transfer_waits_its_producers(monkeypatch):
    ctx, q, log, made = _spy_queue(monkeypatch, False)
    a = ctx.create_buffer(torch.ones(8, 8))
    ev = q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(), (a,))
    rd = q.enqueue_read_buffer(ev.outputs[0], blocking=True)
    assert log == made and ev.done and rd.done and rd.dispatch_s == 0.0
    buf = ctx.create_buffer(torch.zeros(8, 8))
    wr = q.enqueue_write_buffer(buf, torch.ones(8, 8), blocking=True)
    assert wr.done and buf.data.sum() == 64


# -- flush ---------------------------------------------------------------------------
@BOTH
def test_flush_is_a_no_op(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    a = ctx.create_buffer(P.array(ONES))
    ev = q.enqueue_nd_range(P.mm_kernel(), P.ndr(), (a,))
    assert q.flush() is None
    assert q.events == (ev,) and q._drained == 0
    q.finish()
    assert ev.done


# -- constructor -----------------------------------------------------------------------
@BOTH
def test_queue_parameter_order_and_max_events_check(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, False, True, 3, True)
    assert (q.profile, q.blocking, q.max_events, q.out_of_order) == (
        False, True, 3, True)
    q = P.core.CommandQueue(ctx, out_of_order=True)
    assert (q.profile, q.blocking, q.max_events, q.out_of_order) == (
        True, False, None, True)
    with pytest.raises(ValueError, match="max_events"):
        P.core.CommandQueue(ctx, max_events=-1)


# -- tests/test_program.py: create_buffer's copy and use_host_ptr -------------------
def test_create_buffer_copy_and_use_host_ptr():
    ctx = PORT.ctx()
    x = torch.arange(16, dtype=torch.float32)
    assert ctx.create_buffer(x).data is x            # on the device: adopted
    assert ctx.create_buffer(x, copy=False).data is x
    alias = ctx.create_buffer(x, use_host_ptr=True).data
    assert alias is x and alias.data_ptr() == x.data_ptr()
    fresh = ctx.create_buffer(x, copy=True).data
    assert fresh is not x and fresh.data_ptr() != x.data_ptr()
    assert torch.equal(fresh, x)
    host = np.arange(4, dtype=np.float32)
    assert isinstance(ctx.create_buffer(host).data, torch.Tensor)
    with pytest.raises(TypeError, match="cannot adopt foreign storage"):
        ctx.create_buffer(host, copy=False)          # cannot adopt numpy
    with pytest.raises(TypeError):
        ctx.create_buffer(host, use_host_ptr=True)
    with pytest.raises(ValueError):
        ctx.create_buffer(x, copy=True, use_host_ptr=True)
    # the JAX package gives the same answers to the same calls
    jctx = JAX.ctx()
    jx = jnp.arange(16, dtype=jnp.float32)
    assert jctx.create_buffer(jx, use_host_ptr=True).data is jx
    assert jctx.create_buffer(jx, copy=True).data is not jx
    with pytest.raises(TypeError, match="cannot adopt foreign storage"):
        jctx.create_buffer(host, copy=False)
    with pytest.raises(TypeError):
        jctx.create_buffer(host, use_host_ptr=True)
    with pytest.raises(ValueError):
        jctx.create_buffer(jx, copy=True, use_host_ptr=True)


def test_create_buffer_cannot_adopt_a_tensor_on_another_device():
    """The port's one difference: a ``jax.Array`` always lies in the unified
    memory, but a tensor on another torch device (a CPU tensor for a card
    context; here a ``meta`` tensor for a CPU context) has storage the
    context cannot alias, so adoption raises as it does for numpy."""
    ctx = PORT.ctx()
    elsewhere = torch.empty(16, device="meta")
    with pytest.raises(TypeError, match="cannot adopt foreign storage"):
        ctx.create_buffer(elsewhere, copy=False)
    with pytest.raises(TypeError, match="use_host_ptr"):
        ctx.create_buffer(elsewhere, use_host_ptr=True)


def test_create_buffer_copies_keep_host_edits_out():
    """copy=None and copy=True never alias a numpy array (the rule
    ``tests/test_torch_dag.py::test_write_source_moves_to_the_context_device``
    pins): a later host edit does not reach the buffer."""
    ctx = PORT.ctx()
    host = np.arange(4, dtype=np.float32)
    bufs = [ctx.create_buffer(host), ctx.create_buffer(host, copy=True)]
    host[:] = -1.0
    for b in bufs:
        assert b.data.tolist() == [0.0, 1.0, 2.0, 3.0]


# -- tests/test_obs.py: released-event metadata --------------------------------------
def _released_metadata(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, max_events=1)   # bounded profiling window
    kern = P.mm_kernel()
    events = [q.enqueue_nd_range(kern, P.ndr(),
                                 (ctx.create_buffer(P.array(ONES)),))
              for _ in range(3)]
    q.finish()
    released = [e for e in events if e.released]
    assert len(released) == 2            # the window kept only the newest
    for ev in released:
        assert ev.wall_s == ev.dispatch_s >= 0.0
        assert ev.modeled is not None and ev.modeled.total_s > 0.0
        assert ev.energy_j is not None and ev.energy_j > 0.0
        assert ev.outputs == ()
        with pytest.raises(RuntimeError, match="released"):
            ev.wait()
    assert q.total_modeled_s() == pytest.approx(
        sum(e.modeled.total_s for e in events))
    return ([e.modeled.total_s for e in events],
            [e.energy_j for e in events], q.total_modeled_s(),
            q.total_energy_j(), q.released_count)


def test_released_event_metadata_survives_profiling_window():
    assert _released_metadata(PORT) == _released_metadata(JAX)


@BOTH
def test_queue_span_carries_dispatch_s(P):
    tr = P.obs.Tracer()
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, tracer=tr)
    ev = q.enqueue_nd_range(P.mm_kernel(), P.ndr(),
                            (ctx.create_buffer(P.array(ONES)),))
    wr = q.enqueue_write_buffer(ctx.create_buffer(P.array(ONES)),
                                P.array(ONES))
    q.finish()
    spans = [s for s in tr.spans if s.track.startswith("queue:")]
    assert [s.attrs["dispatch_s"] for s in spans] == [ev.dispatch_s, 0.0]
    assert ev.dispatch_s > 0.0 and wr.dispatch_s == 0.0


# -- tests/test_serve.py: the bounded profiling window --------------------------------
def _bounded_window(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, max_events=2)
    a = ctx.create_buffer(P.array(np.ones(64, np.float32)))
    evs = []
    for _ in range(5):
        evs.append(q.enqueue_nd_range(P.counts_kernel(), P.ndr(), (a,)))
        q.finish()
    assert len(q.events) == 2            # window, not full history
    assert q.released_count == 3
    one = evs[0].modeled.total_s
    assert q.total_modeled_s() == pytest.approx(5 * one)
    return one, q.total_modeled_s(), q.total_energy_j(), q.released_count


def test_bounded_profiling_window():
    assert _bounded_window(PORT) == _bounded_window(JAX)


# -- capture on an unprofiled queue ----------------------------------------------------
def _unprofiled_capture(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, profile=False)
    a = ctx.create_buffer(P.array(ONES))
    with q.capture() as graph:
        ev = q.enqueue_nd_range(P.mm_kernel(), P.ndr(), (a,))
        q.enqueue_read_buffer(ev.outputs[0])
    assert all(n.modeled is None and n.energy_j is None for n in graph.nodes)
    (out,) = graph.launch()
    q.finish()
    assert q.events == () and q.released_count == len(graph.nodes)
    return (graph.fused_modeled(), graph.total_modeled_s(),
            graph.total_energy_j(), P.numpy(out.data))


def test_graph_captured_on_an_unprofiled_queue_prices_no_node():
    got, want = _unprofiled_capture(PORT), _unprofiled_capture(JAX)
    assert got[:3] == want[:3] == ((None, 0), 0, 0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-6)


def test_graph_launch_books_its_dispatch_on_the_first_node():
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx)
    a = ctx.create_buffer(torch.ones(8, 8))
    with q.capture() as graph:
        ev = q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(), (a,))
        q.enqueue_nd_range(PORT.mm_kernel(), PORT.ndr(), ev.outputs)
    graph.launch()
    first, second = q.events
    assert first.dispatch_s > 0.0 and second.dispatch_s == 0.0


# -- the option grid over the registry's GeMM and TinyBio families ---------------------
def _family_commands(P):
    """(family, inputs, params, counts_params) at small sizes, the same
    numpy draws for both packages."""
    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [
        ("gemm", (rng.integers(-8, 8, (32, 32)).astype(np.int32),
                  rng.integers(-8, 8, (32, 32)).astype(np.int32)),
         {}, {"m": 32, "n": 32, "k": 32}),
        ("fir", (f32(256), f32(16)), {}, {"n": 256, "taps": 16}),
        ("delineate", (f32(256),), {}, {"n": 256}),
        ("stockham_fft", (f32(8, 64),), {}, {"n": 64}),
        ("svm", (f32(8, 4), f32(16, 4), f32(16), np.float32(0.1)),
         {"gamma": 0.5}, {"q": 8, "m": 16, "d": 4}),
    ]


def _run_grid(P, opts, transfer_blocking, rounds=2):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, **opts)
    prog = P.core.Program.build(P.core.EGPU_16T)
    booked = []                          # (name, done on return, event)
    outs = []
    for _ in range(rounds):
        for family, ins, params, cp in _family_commands(P):
            kern = prog.create_kernel(family)
            bufs = tuple(ctx.create_buffer(P.array(a)) for a in ins)
            ndr = P.core.optimal_ndrange(int(np.size(ins[0])),
                                         P.core.EGPU_16T)
            ev = q.enqueue_nd_range(kern, ndr, bufs, params=params,
                                    counts_params=cp)
            booked.append((family, ev.done, ev))
            outs.append(ev.outputs[0])
        dst = ctx.create_buffer(P.array(np.zeros(256, np.float32)))
        wr = q.enqueue_write_buffer(dst, P.array(np.ones(256, np.float32)),
                                    blocking=transfer_blocking)
        rd = q.enqueue_read_buffer(outs[-1], blocking=transfer_blocking)
        mk = q.enqueue_marker()
        booked += [("write", wr.done, wr), ("read", rd.done, rd),
                   ("marker", mk.done, mk)]
        q.finish()
    return {
        "events": len(q.events),
        "released_count": q.released_count,
        "total_modeled_s": q.total_modeled_s(),
        "total_energy_j": q.total_energy_j(),
        "booked": [(name, done, ev.released, ev.done,
                    None if ev.modeled is None else ev.modeled.total_s,
                    ev.energy_j, ev.dispatch_s == 0.0)
                   for name, done, ev in booked],
    }, [P.numpy(o.data) for o in outs]


GRID = [
    ({}, False),
    ({"profile": False}, False),
    ({"profile": False, "blocking": True}, False),
    ({"blocking": True}, False),
    ({"max_events": 2}, False),
    ({"max_events": 0}, True),
    ({"profile": True, "max_events": 2, "blocking": True}, True),
    ({"profile": False}, True),
    ({"profile": False, "blocking": True, "out_of_order": True}, False),
    ({"max_events": 2, "out_of_order": True}, True),
]


def _totals(run):
    return run["total_modeled_s"], run["total_energy_j"]


@pytest.mark.parametrize("opts,transfer_blocking", GRID,
                         ids=[f"{'-'.join(f'{k}={v}' for k, v in o.items()) or 'default'}"
                              f"{'-blocking_transfers' if b else ''}"
                              for o, b in GRID])
def test_option_grid_matches_jax(opts, transfer_blocking):
    got, got_outs = _run_grid(PORT, opts, transfer_blocking)
    want, want_outs = _run_grid(JAX, opts, transfer_blocking)
    windowed = opts.get("max_events") is not None
    if not windowed:
        assert got == want
    else:
        # A windowed queue's totals equal a full-history queue's: the
        # port's bit for bit (one left fold in enqueue order), and so the
        # JAX package's full-history totals.  The JAX package's windowed
        # queue adds the released sum to the retained sum, which can move
        # the last place (it pins this with pytest.approx).
        full = dict(opts, max_events=None)
        port_full = _run_grid(PORT, full, transfer_blocking)[0]
        jax_full = _run_grid(JAX, full, transfer_blocking)[0]
        assert _totals(got) == _totals(port_full) == _totals(jax_full)
        assert _totals(want) == pytest.approx(_totals(jax_full), rel=1e-12)
        strip = lambda r: {k: v for k, v in r.items()
                           if k not in ("total_modeled_s", "total_energy_j")}
        assert strip(got) == strip(want)
    # outputs: the same kernels' plain versions (gemm int32 exact; the
    # float families summed in another order by XLA and PyTorch)
    for g, w in zip(got_outs, want_outs):
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
