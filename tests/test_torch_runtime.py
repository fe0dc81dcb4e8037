"""The port's Tiny-OpenCL runtime: its own semantics, on the CPU.

Capture executes nothing, graph outputs equal eager outputs bitwise, launch
and flag errors are raised as in the JAX package, and releasing or draining
events keeps the queue's modeled totals exact (and equal to the JAX
package's for the same commands).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
import repro_torch.core as tcore
from repro.core import ndrange as jnd
from repro_torch.core import (APU, EGPU_16T, Buffer, CommandQueue, Context,
                              Device, GraphBuffer, Kernel, NDRange,
                              Program, Stage, WorkCounts, crop_from_groups,
                              pad_to_groups)
from repro_torch.kernels.common import LAUNCHES

NDR = NDRange((8, 8), (4, 4))


def _ctx():
    return Context(Device(EGPU_16T), "cpu")


def _counts(**kw):
    return WorkCounts(ops=1000.0, dcache_bytes=256.0, host_bytes=128.0,
                      working_set=64.0)


def _mm():
    return Kernel("mm", executor=lambda a, b: a @ b, counts=_counts)


class _Spy:
    """An executor that records the device type of every call's inputs."""

    def __init__(self, fn):
        self.fn = fn
        self.devices = []

    def __call__(self, *tensors, **params):
        self.devices.append(tuple(t.device.type for t in tensors))
        return self.fn(*tensors, **params)


# -- capture -------------------------------------------------------------------------
def test_capture_executes_nothing():
    spy = _Spy(lambda a, b: a @ b)
    kern = Kernel("mm", executor=spy, counts=_counts)
    ctx = _ctx()
    q = CommandQueue(ctx)
    a = ctx.create_buffer(torch.arange(64, dtype=torch.float32).reshape(8, 8))
    with q.capture() as graph:
        e1 = q.enqueue_nd_range(kern, NDR, (a, a))
        e2 = q.enqueue_nd_range(kern, NDR, e1.outputs + (a,))
    assert spy.devices == [("meta", "meta"), ("meta", "meta")]
    assert isinstance(e2.outputs[0], GraphBuffer)
    assert e2.outputs[0].shape == (8, 8)
    with pytest.raises(RuntimeError, match="no data"):
        e2.outputs[0].read()
    assert q.events == ()                    # nothing booked while capturing
    (out,) = graph.launch()
    assert spy.devices[2:] == [("cpu", "cpu"), ("cpu", "cpu")]
    torch.testing.assert_close(out.data, a.data @ a.data @ a.data,
                               rtol=0, atol=0)


def test_tinybio_capture_launches_no_kernel_and_runs_only_meta():
    from repro_torch.apps.tinybio import tinybio_stages
    apu = APU(EGPU_16T, device="cpu")
    stages, inputs = tinybio_stages(EGPU_16T, 0, "cpu")
    spies = [_Spy(s.kernel.executor) for s in stages]
    spied = [Stage(Kernel(s.kernel.name, sp, s.kernel.counts), s.params,
                   s.counts_params, s.consts)
             for s, sp in zip(stages, spies)]
    before = dict(LAUNCHES)
    graph = apu.capture_pipeline(spied, inputs)
    assert all(sp.devices and all(set(d) == {"meta"} for d in sp.devices)
               for sp in spies)
    assert LAUNCHES == before
    assert [n.kernel.name for n in graph.nodes] == \
        ["fir", "delineate_keep", "fft_features", "svm"]
    assert graph.n_request_inputs == 1 and graph.n_external == 5
    assert [tuple(a.shape) for a in graph.out_avals] == [(128,)]
    assert graph.node_deps() == ((), (0,), (1,), (2,))


# -- graph vs eager --------------------------------------------------------------------
def test_graph_outputs_equal_eager_bitwise():
    from repro_torch.apps.tinybio import run_tinybio
    d_graph, r_graph = run_tinybio(EGPU_16T, device="cpu", mode="graph")
    d_eager, r_eager = run_tinybio(EGPU_16T, device="cpu", mode="eager")
    assert torch.equal(d_graph, d_eager)
    assert r_graph.stages == r_eager.stages
    assert r_graph.egpu_fused is not None and r_eager.egpu_fused is None


def test_graph_relaunch_with_new_inputs_equals_eager():
    ctx = _ctx()
    fir = Program.build(EGPU_16T).create_kernel("fir")
    rng = np.random.default_rng(0)
    x0 = ctx.create_buffer(rng.standard_normal(300).astype(np.float32))
    h = ctx.create_buffer(rng.standard_normal(9).astype(np.float32))
    q = CommandQueue(ctx)
    with q.capture() as graph:
        q.enqueue_nd_range(fir, NDR, (x0, h), counts_params={"n": 300, "taps": 9})
    x1 = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    (g,) = graph.launch_prefix([x1])
    (e,) = q.enqueue_nd_range(fir, NDR, (Buffer(x1), h),
                              counts_params={"n": 300, "taps": 9}).wait()
    assert torch.equal(g.data, e.data)
    assert len(q.events) == 2                 # the launch booked one node


# -- errors, as the JAX runtime raises them --------------------------------------------
def test_launch_errors_match_reference():
    for core, arr in ((jcore, jnp.ones), (tcore, torch.ones)):
        ctx = core.Context(core.Device(core.EGPU_16T),
                           *(("cpu",) if core is tcore else ()))
        q = core.CommandQueue(ctx)
        kern = core.Kernel("mm", executor=lambda a, b: a @ b)
        a = ctx.create_buffer(arr((8, 8)))
        with q.capture() as graph:
            q.enqueue_nd_range(kern, NDR, (a, a))
            with pytest.raises(RuntimeError, match="still capturing"):
                graph.launch()
        with pytest.raises(ValueError, match="re-capture"):
            graph.launch(arr((4, 4)))
        with pytest.raises(ValueError, match="external inputs"):
            graph.launch(arr((8, 8)), arr((8, 8)))
        with pytest.raises(ValueError, match="only 1 externals"):
            graph.launch_prefix([arr((8, 8)), arr((8, 8))])
        with pytest.raises(ZeroDivisionError):
            with q.capture() as broken:
                q.enqueue_nd_range(kern, NDR, (a, a))
                1 / 0
        with pytest.raises(RuntimeError, match="cleanly"):
            broken.launch()
        with q.capture() as empty:
            pass
        with pytest.raises(RuntimeError, match="empty"):
            empty.launch()
        with q.capture():
            with pytest.raises(RuntimeError, match="already capturing"):
                q.capture().__enter__()


def test_launch_rejects_another_dtype_or_device():
    ctx = _ctx()
    q = CommandQueue(ctx)
    a = ctx.create_buffer(torch.ones(8, 8))
    with q.capture() as graph:
        q.enqueue_nd_range(_mm(), NDR, (a, a))
    with pytest.raises(ValueError, match="re-capture"):
        graph.launch(torch.ones(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="lies on meta"):
        graph.launch(torch.ones(8, 8, device="meta"))


def test_buffer_flags_enforced_as_in_reference():
    for core, arr in ((jcore, jnp.ones), (tcore, torch.ones)):
        ctx = core.Context(core.Device(core.EGPU_16T),
                           *(("cpu",) if core is tcore else ()))
        q = core.CommandQueue(ctx)
        kern = core.Kernel("mm", executor=lambda a, b: a @ b)
        w = ctx.create_buffer(arr((8, 8)), flags="w")
        r = ctx.create_buffer(arr((8, 8)), flags="r")
        with pytest.raises(ValueError, match="write-only"):
            q.enqueue_nd_range(kern, NDR, (r, w))
        with q.capture():
            with pytest.raises(ValueError, match="write-only"):
                q.enqueue_nd_range(kern, NDR, (w, r))
        with pytest.raises(ValueError, match="invalid buffer flags"):
            ctx.create_buffer(arr((2,)), flags="x")
        assert r.readable and not r.writable and w.writable


# -- event lifecycle and totals -----------------------------------------------------------
def _run_queue(core, arr):
    ctx = core.Context(core.Device(core.EGPU_16T),
                       *(("cpu",) if core is tcore else ()))
    q = core.CommandQueue(ctx)
    kern = core.Kernel("mm", executor=lambda a, b: a @ b,
                       counts=lambda **kw: core.WorkCounts(
                           ops=1000.0 * kw["k"], dcache_bytes=256.0,
                           host_bytes=128.0, working_set=64.0))
    a = ctx.create_buffer(arr((8, 8)))
    evs = [q.enqueue_nd_range(kern, NDR, (a, a), counts_params={"k": k + 1},
                              _resident=k % 2 == 1)
           for k in range(6)]
    return q, evs


def test_release_events_and_drain_keep_totals_exact_and_equal_reference():
    jq, _ = _run_queue(jcore, jnp.ones)
    tq, tevs = _run_queue(tcore, torch.ones)
    total_s, total_j = tq.total_modeled_s(), tq.total_energy_j()
    assert (total_s, total_j) == (jq.total_modeled_s(), jq.total_energy_j())
    assert tq.release_events() == 0          # nothing drained yet
    tq.drain(2)
    jq.drain(2)
    assert tevs[0].done and tevs[1].done and not tevs[2].done
    assert tq.release_events(upto=5) == 2    # only drained events go
    assert jq.release_events(upto=5) == 2
    assert tq.released_count == 2 and len(tq.events) == 4
    assert tq.total_modeled_s() == total_s and tq.total_energy_j() == total_j
    tq.finish()
    jq.finish()
    assert tq.release_events() == jq.release_events() == 4
    assert tq.events == () and tq.released_count == 6
    assert (tq.total_modeled_s(), tq.total_energy_j()) == \
        (jq.total_modeled_s(), jq.total_energy_j())
    assert tq.total_modeled_s() == total_s


def test_event_retain_release_and_wait():
    tq, evs = _run_queue(tcore, torch.ones)
    kept = evs[0].retain()
    tq.finish()
    tq.release_events()
    assert kept.outputs and not kept.released     # retained: outputs alive
    kept.release()
    assert kept.released and kept.outputs == ()
    assert kept.modeled is not None               # cost metadata survives
    with pytest.raises(RuntimeError, match="released"):
        kept.wait()
    with pytest.raises(RuntimeError, match="released"):
        kept.retain()
    kept.release()                                # idempotent


def test_in_order_chain_and_dataflow_deps():
    ctx = _ctx()
    q = CommandQueue(ctx)
    a = ctx.create_buffer(torch.eye(8))
    e1 = q.enqueue_nd_range(_mm(), NDR, (a, a))
    e2 = q.enqueue_nd_range(_mm(), NDR, e1.outputs + (a,))
    assert e1 in e2.deps
    e2.wait()
    assert e1.done and e2.done and e2.deps == ()


def test_graph_launch_books_on_the_callers_queue():
    ctx = _ctx()
    home, caller = CommandQueue(ctx), CommandQueue(ctx)
    a = ctx.create_buffer(torch.ones(8, 8))
    with home.capture() as graph:
        e = home.enqueue_nd_range(_mm(), NDR, (a, a))
        home.enqueue_nd_range(_mm(), NDR, e.outputs + (a,))
    graph.launch(queue=caller)
    assert home.events == () and len(caller.events) == 2
    assert caller.total_modeled_s() == graph.total_modeled_s()
    fused, energy = graph.fused_modeled()
    assert graph.fused_modeled()[0] is fused
    assert energy == graph.total_energy_j()
    assert fused.startup == graph.nodes[0].modeled.startup   # paid once


# -- kernel objects and the program registry -------------------------------------------------
def test_kernel_arg_info_set_args_and_enqueue_kernel():
    prog = Program.build(EGPU_16T)
    svm = prog.create_kernel("svm")
    assert [(a.name, a.kind) for a in svm.arg_info] == [
        ("x", "buffer"), ("sv", "buffer"), ("alpha", "buffer"),
        ("b", "buffer"), ("gamma", "param")]
    # gamma is a defaulted positional: it widens the buffer arity's max
    assert svm.n_buffer_args == (4, 5) == jcore.Program.build(
        jcore.EGPU_16T).create_kernel("svm").n_buffer_args
    with pytest.raises(ValueError, match="4..5"):
        svm.set_args(torch.zeros(2, 2))
    fir = prog.create_kernel("fir")
    ctx = _ctx()
    x = torch.arange(40, dtype=torch.float32)
    fir.set_arg(0, x).set_arg(1, torch.ones(3))
    ev = CommandQueue(ctx).enqueue_kernel(fir, counts_params={"n": 40, "taps": 3})
    (y,) = ev.wait()
    assert torch.equal(y.data[2:], x[2:] + x[1:-1] + x[:-2])


def test_program_registry_memoizes_and_lists_only_ported_families():
    from repro_torch.core.program import BUILTIN_FAMILIES
    assert sorted(BUILTIN_FAMILIES) == ["decode_attention", "delineate", "fir",
                                        "gemm", "mamba_scan", "stockham_fft",
                                        "svm"]
    p1, p2 = Program.build(EGPU_16T), Program.build(EGPU_16T)
    assert p1 is p2
    k = p1.create_kernel("stockham_fft")
    assert k is p2.create_kernel("stockham_fft")
    assert (k.family, k.config) == ("stockham_fft", EGPU_16T)
    assert k is not Program.build(tcore.EGPU_8T).create_kernel(
        "stockham_fft")
    with pytest.raises(KeyError, match="unknown kernel family"):
        p1.create_kernel("flash_attention")


# -- devices and NDRange ---------------------------------------------------------------------
def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert APU().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        APU()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Context(Device(EGPU_16T))
    assert APU(device="cpu").device.type == "cpu"


def test_create_buffer_adopts_or_copies():
    ctx = _ctx()
    t = torch.ones(3)
    assert ctx.create_buffer(t).data is t
    assert ctx.create_buffer(np.ones(3, np.float32)).data.dtype == torch.float32
    b = ctx.create_buffer(np.float32(0.1))
    assert b.shape == () and b.dtype == torch.float32 and b.nbytes == 4


@pytest.mark.parametrize("g,l,axis", [((10,), (4,), 0), ((6, 10), (4, 4), 1),
                                      ((6, 10), (4, 4), 0)])
def test_pad_and_crop_match_reference(g, l, axis):
    shape = (6, 10) if len(g) == 2 else (10,)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jn, tn = jnd.NDRange(g, l), NDRange(g, l)
    jp = np.asarray(jnd.pad_to_groups(jnp.asarray(x), jn, axis, fill=-1))
    tp = pad_to_groups(torch.from_numpy(x), tn, axis, fill=-1)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(
        crop_from_groups(tp, tn, axis).numpy(),
        np.asarray(jnd.crop_from_groups(jnp.asarray(jp), jn, axis)))
    assert (tn.num_groups, tn.padded_size, tn.total_work_items) == \
        (jn.num_groups, jn.padded_size, jn.total_work_items)

