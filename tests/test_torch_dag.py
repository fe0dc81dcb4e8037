"""Event-dependency DAGs and explicit transfers: the port against the JAX
package, on the CPU.

Every capture below is built identically in both packages (the JAX
package's ``tests/test_multiqueue.py`` and ``tests/test_program.py``
scenarios: out-of-order queues, ``wait_events``, markers, barriers,
multi-queue ``join``, write/read/copy transfer nodes) and must give the
same graph: node kinds, dependency edges, transfer bytes, every modeled
breakdown and the fused critical path, equal with no tolerance.  The
port's graph launches must agree with the JAX package's outputs
(``rtol=1e-5`` plus ``atol=1e-6``: XLA's CPU matmul differs from PyTorch's
by a few ulps, and ``rtol`` alone fails near zero).  Eager ordering
semantics (the events a command depends on) are pinned as the JAX tests
pin them, and the DAG benches' modeled ratios equal the JAX benches'.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
from repro.kernels.gemm.ref import counts as j_counts
from repro.kernels.gemm.ref import gemm_ref as j_gemm_ref
import repro_torch.core as tcore
from repro_torch.kernels.gemm.ref import counts as t_counts
from repro_torch.kernels.gemm.ref import gemm_ref as t_gemm_ref

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:              # the benchmark packages
    sys.path.insert(0, str(ROOT))

JAX = SimpleNamespace(
    core=jcore, gemm_ref=j_gemm_ref, counts=j_counts,
    ctx=lambda cfg=jcore.EGPU_16T: jcore.Context(jcore.Device(cfg)),
    array=jnp.asarray, zeros_like=jnp.zeros_like,
    numpy=np.asarray)
PORT = SimpleNamespace(
    core=tcore, gemm_ref=t_gemm_ref, counts=t_counts,
    ctx=lambda cfg=tcore.EGPU_16T: tcore.Context(tcore.Device(cfg), "cpu"),
    array=lambda x: torch.from_numpy(np.ascontiguousarray(x)),
    zeros_like=torch.zeros_like,
    numpy=lambda t: t.numpy())


def _x(seed=0, shape=(8, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mm(P, name="mm"):
    return P.core.Kernel(name=name, executor=P.gemm_ref,
                         counts=lambda **kw: P.counts(m=8, n=8, k=8))


def _ndr(P):
    return P.core.NDRange((8, 8), (4, 4))


# -- scenarios, each written once for both packages --------------------------
def ooo_independent(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, b))
    return [g]


def in_order_chain(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, b))
    return [g]


def wait_events(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        e0 = q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, b), wait_events=[e0])
    return [g]


def diamond(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    with q.capture() as g:
        a = ctx.create_buffer(P.array(_x(3)))
        e0 = q.enqueue_nd_range(_mm(P, "A"), _ndr(P), (a, a))
        e1 = q.enqueue_nd_range(_mm(P, "B"), _ndr(P), e0.outputs + (a,),
                                wait_events=[e0])
        e2 = q.enqueue_nd_range(_mm(P, "C"), _ndr(P), e0.outputs + (a,),
                                wait_events=[e0])
        q.enqueue_nd_range(_mm(P, "D"), _ndr(P),
                           (e1.outputs[0], e2.outputs[0]),
                           wait_events=[e1, e2])
    return [g]


def marker(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        e0 = q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        e1 = q.enqueue_nd_range(_mm(P), _ndr(P), (b, b))
        m = q.enqueue_marker(wait_events=[e0, e1])
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, b), wait_events=[m])
    return [g]


def barrier(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, b))
        q.enqueue_barrier()
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, b))
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, a))
    return [g]


def empty_wait_list(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    a, b = ctx.create_buffer(P.array(_x(1))), ctx.create_buffer(P.array(_x(2)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_barrier(wait_events=[])
        q.enqueue_nd_range(_mm(P), _ndr(P), (b, b))
    return [g]


def barrier_cross_queue(P):
    ctx = P.ctx()
    host_q = P.core.CommandQueue(P.ctx(P.core.HOST))
    q = P.core.CommandQueue(ctx)
    a = ctx.create_buffer(P.array(_x(1)))
    with q.capture() as g:
        with g.join(host_q):
            host_ev = host_q.enqueue_nd_range(_mm(P, "host"), _ndr(P), (a, a))
        q.enqueue_barrier(wait_events=[host_ev])
        q.enqueue_nd_range(_mm(P, "egpu"), _ndr(P), (a, a))
    with q.capture() as g2:
        with g2.join(host_q):
            hev = host_q.enqueue_nd_range(_mm(P, "host"), _ndr(P), (a, a))
        q.enqueue_barrier(wait_events=[hev])
        q.enqueue_nd_range(_mm(P, "e1"), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P, "e2"), _ndr(P), (a, a))
    return [g, g2]


def consecutive_sync(P):
    ctx = P.ctx()
    host_q = P.core.CommandQueue(P.ctx(P.core.HOST))
    q = P.core.CommandQueue(ctx)
    a = ctx.create_buffer(P.array(_x(1)))
    with q.capture() as g:
        with g.join(host_q):
            host_ev = host_q.enqueue_nd_range(_mm(P, "host"), _ndr(P), (a, a))
        q.enqueue_barrier(wait_events=[host_ev])
        q.enqueue_marker()
        q.enqueue_nd_range(_mm(P, "egpu"), _ndr(P), (a, a))
    q2 = P.core.CommandQueue(ctx, out_of_order=True)
    b = ctx.create_buffer(P.array(_x(2)))
    with q2.capture() as g2:
        with g2.join(host_q):
            hev = host_q.enqueue_nd_range(_mm(P, "host"), _ndr(P), (a, a))
        q2.enqueue_barrier(wait_events=[hev])
        e1 = q2.enqueue_nd_range(_mm(P, "e1"), _ndr(P), (a, a))
        q2.enqueue_barrier(wait_events=[e1])
        q2.enqueue_nd_range(_mm(P, "e2"), _ndr(P), (b, b))
    return [g, g2]


def trailing_barrier(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    a = ctx.create_buffer(P.array(_x(1)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_barrier()
    return [g]


def join_host_egpu(P):
    ctx = P.ctx()
    host_q = P.core.CommandQueue(P.ctx(P.core.HOST))
    q = P.core.CommandQueue(ctx)
    with q.capture() as g:
        a = ctx.create_buffer(P.array(_x(4)))
        e0 = q.enqueue_nd_range(_mm(P, "egpu_mm"), _ndr(P), (a, a))
        with g.join(host_q):
            host_q.enqueue_nd_range(_mm(P, "host_mm"), _ndr(P),
                                    e0.outputs + (a,), wait_events=[e0])
    return [g]


def nested_join(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    a = ctx.create_buffer(P.array(_x(6)))
    with q.capture() as g:
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        with g.join(q):                  # q is already capturing g
            q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
        q.enqueue_nd_range(_mm(P), _ndr(P), (a, a))
    return [g]


def write_kernel_read(P):
    """``tests/test_program.py::test_capture_records_transfer_nodes_and_matches_eager``."""
    ctx = P.ctx()
    x = P.array(_x(9))
    q = P.core.CommandQueue(ctx)
    with q.capture() as g:
        buf = P.core.Buffer(P.zeros_like(x))
        q.enqueue_write_buffer(buf, x)
        kev = q.enqueue_nd_range(_mm(P), _ndr(P), (buf, buf), _resident=True)
        q.enqueue_read_buffer(kev.outputs[0])
    return [g]


def write_after_read(P):
    ctx = P.ctx()
    x = P.array(_x(17))
    q = P.core.CommandQueue(ctx, out_of_order=True)
    with q.capture() as g:
        buf = P.core.Buffer(P.zeros_like(x))
        q.enqueue_write_buffer(buf, x)
        q.enqueue_read_buffer(buf)
        q.enqueue_nd_range(_mm(P), _ndr(P), (buf, buf), _resident=True)
        q.enqueue_write_buffer(buf, x * 2)
    return [g]


def copy_rebinds(P):
    ctx = P.ctx()
    x = P.array(_x(16))
    q = P.core.CommandQueue(ctx)
    with q.capture() as g:
        src = ctx.create_buffer(x)
        dst = P.core.Buffer(P.zeros_like(x))
        q.enqueue_copy_buffer(src, dst)
        kev = q.enqueue_nd_range(_mm(P), _ndr(P), (dst, dst), _resident=True)
        q.enqueue_read_buffer(kev.outputs[0])
    return [g]


def trailing_reads(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    with q.capture() as g:
        a = ctx.create_buffer(P.array(_x(10)))
        e1 = q.enqueue_nd_range(_mm(P, "A"), _ndr(P), (a, a))
        e2 = q.enqueue_nd_range(_mm(P, "B"), _ndr(P), (e1.outputs[0], a))
        q.enqueue_read_buffer(e1.outputs[0])
        q.enqueue_marker()
        q.enqueue_read_buffer(e2.outputs[0])
    return [g]


def branch_transfers(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx, out_of_order=True)
    xa, xb = P.array(_x(11)), P.array(_x(12))
    with q.capture() as g:
        ba, bb = P.core.Buffer(P.zeros_like(xa)), P.core.Buffer(P.zeros_like(xb))
        q.enqueue_write_buffer(ba, xa)
        q.enqueue_write_buffer(bb, xb)
        ka = q.enqueue_nd_range(_mm(P, "A"), _ndr(P), (ba, ba), _resident=True)
        kb = q.enqueue_nd_range(_mm(P, "B"), _ndr(P), (bb, bb), _resident=True)
        q.enqueue_nd_range(_mm(P, "combine"), _ndr(P),
                           (ka.outputs[0], kb.outputs[0]),
                           wait_events=[ka, kb], _resident=True)
    return [g]


SCENARIOS = {f.__name__: f for f in (
    ooo_independent, in_order_chain, wait_events, diamond, marker, barrier,
    empty_wait_list, barrier_cross_queue, consecutive_sync, trailing_barrier,
    join_host_egpu, nested_join, write_kernel_read, write_after_read,
    copy_rebinds, trailing_reads, branch_transfers)}

#: the edges the JAX tests pin, per scenario and graph
EXPECTED_DEPS = {
    "ooo_independent": [((), ())],
    "in_order_chain": [((), (0,))],
    "wait_events": [((), (0,))],
    "diamond": [((), (0,), (0,), (1, 2))],
    "marker": [((), (), (0, 1), (2,))],
    "barrier": [((), (), (0, 1), (2,), (2,))],
    "empty_wait_list": [((), (0,), (1,))],
    "barrier_cross_queue": [((), (0,), (1,)), ((), (0,), (1,), (2,))],
    "consecutive_sync": [((), (0,), (1,), (2,)),
                         ((), (0,), (1,), (1, 2), (3,))],
    "join_host_egpu": [((), (0,))],
    "write_kernel_read": [((), (0,), (1,))],
    "branch_transfers": [((), (), (0,), (1,), (2, 3))],
}


def _structure(g):
    return {
        "kinds": [n.kind for n in g.nodes],
        "names": [n.kernel.name for n in g.nodes],
        "deps": g.node_deps(),
        "nbytes": [n.nbytes for n in g.nodes],
        "overwrites": [n.overwrites for n in g.nodes],
        "n_items": [n.n_items for n in g.nodes],
        "modeled": [None if m is None else dataclasses.asdict(m)
                    for m in g.modeled_breakdowns()],
        "energy": [n.energy_j for n in g.nodes],
        "counts": [None if n.counts is None else dataclasses.asdict(n.counts)
                   for n in g.nodes],
        "fused": dataclasses.asdict(g.fused_modeled()[0]),
        "fused_energy": g.fused_modeled()[1],
        "n_external": g.n_external,
        "out_shapes": [tuple(a.shape) for a in g.out_avals],
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_capture_equals_reference(name):
    jgraphs, tgraphs = SCENARIOS[name](JAX), SCENARIOS[name](PORT)
    for i, (jg, tg) in enumerate(zip(jgraphs, tgraphs)):
        assert _structure(tg) == _structure(jg), (name, i)
        if name in EXPECTED_DEPS:
            assert tg.node_deps() == EXPECTED_DEPS[name][i]
        jouts, touts = jg.launch(), tg.launch()
        assert len(touts) == len(jouts)
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data),
                                       rtol=1e-5, atol=1e-6)


def test_critical_path_overlaps_and_transfer_pricing():
    """The modeled claims of the JAX tests, on the port's graphs."""
    (g,) = diamond(PORT)
    fused, _ = g.fused_modeled()
    chain = tcore.fuse_breakdowns(g.modeled_breakdowns())
    per = g.nodes[0].modeled
    assert fused.total_s < chain.total_s
    assert fused.compute == pytest.approx(3 * per.compute)
    (g,) = branch_transfers(PORT)
    fused, _ = g.fused_modeled()
    assert fused.transfer == pytest.approx(g.nodes[0].modeled.transfer)
    assert fused.compute == pytest.approx(2 * g.nodes[2].modeled.compute)
    (g,) = write_kernel_read(PORT)
    expect = tcore.transfer_time(tcore.EGPU_16T, 8 * 8 * 4)
    assert g.fused_modeled()[0].transfer == pytest.approx(2 * expect.transfer)
    (g,) = write_after_read(PORT)
    assert set(g.node_deps()[3]) >= {1, 2}          # write-after-read edges
    (g,) = trailing_reads(PORT)
    assert len(g.launch()) == 2                     # one per trailing read
    (g,) = join_host_egpu(PORT)
    assert g.nodes[0].modeled.scheduling > 0.0 == g.nodes[1].modeled.scheduling


def test_diamond_graph_equals_eager_bitwise():
    (g,) = diamond(PORT)
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx, out_of_order=True)
    a = ctx.create_buffer(PORT.array(_x(3)))
    f0 = q.enqueue_nd_range(_mm(PORT, "A"), _ndr(PORT), (a, a))
    f1 = q.enqueue_nd_range(_mm(PORT, "B"), _ndr(PORT), f0.outputs + (a,),
                            wait_events=[f0])
    f2 = q.enqueue_nd_range(_mm(PORT, "C"), _ndr(PORT), f0.outputs + (a,),
                            wait_events=[f0])
    f3 = q.enqueue_nd_range(_mm(PORT, "D"), _ndr(PORT),
                            (f1.outputs[0], f2.outputs[0]),
                            wait_events=[f1, f2])
    assert set(f3.deps) == {f1, f2}
    (eager,) = f3.wait()
    (graph_out,) = g.launch()
    assert torch.equal(graph_out.data, eager.data)


def test_capture_flags_and_join_rules():
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx)
    x = PORT.array(_x(8))
    ro = ctx.create_buffer(x, flags="r")
    with q.capture() as g:
        rev = q.enqueue_read_buffer(ro)
        kev = q.enqueue_nd_range(_mm(PORT), _ndr(PORT),
                                 (rev.outputs[0], rev.outputs[0]))
        with pytest.raises(ValueError, match="read-only"):
            q.enqueue_write_buffer(ro, x)
        with pytest.raises(RuntimeError, match="this capture"):
            q.enqueue_marker(wait_events=[tcore.CommandQueue(ctx).enqueue_marker()])
    assert rev.outputs[0].flags == "r" and kev.outputs[0].flags == "rw"
    assert [n.kind for n in g.nodes] == ["read", "kernel"]
    with pytest.raises(RuntimeError, match="active capture"):
        with g.join(q):
            pass
    with q.capture() as g2:
        q.enqueue_marker()
    with pytest.raises(RuntimeError, match="empty"):
        g2.launch()
    (g3,) = nested_join(PORT)
    assert len(g3.nodes) == 3 and len(g3.launch()) == 1


# -- eager semantics ----------------------------------------------------------
def test_eager_marker_barrier_and_wait_events():
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx, out_of_order=True)
    a = ctx.create_buffer(torch.ones(8, 8))
    b = ctx.create_buffer(torch.ones(8, 8))
    e0 = q.enqueue_nd_range(_mm(PORT), _ndr(PORT), (a, a))
    e_free = q.enqueue_nd_range(_mm(PORT), _ndr(PORT), (b, b))
    assert e_free.deps == ()                 # out-of-order: no implicit edge
    m = q.enqueue_marker()
    assert {e0, e_free} <= set(m.deps)
    bar = q.enqueue_barrier()
    e1 = q.enqueue_nd_range(_mm(PORT), _ndr(PORT), (a, a))
    assert e1.deps == (bar,)                 # barrier edge only
    e2 = q.enqueue_nd_range(_mm(PORT), _ndr(PORT), (b, b), wait_events=[e0])
    assert set(e2.deps) == {e0, bar}
    m.wait()
    assert e0.done and e_free.done
    q.finish()
    assert e1.done and e2.done
    mq = tcore.CommandQueue(ctx, out_of_order=True)
    e3 = mq.enqueue_nd_range(_mm(PORT), _ndr(PORT), (a, a))
    assert e3 in mq.enqueue_marker(wait_events=[]).deps   # empty list = all
    with pytest.raises(TypeError, match="must contain Events"):
        mq.enqueue_marker(wait_events=[a])
    e3.release()
    with pytest.raises(RuntimeError, match="released"):
        mq.enqueue_barrier(wait_events=[e3])
    with q.capture():
        cap = q.enqueue_marker()
    with pytest.raises(RuntimeError, match="capture-time"):
        q.enqueue_nd_range(_mm(PORT), _ndr(PORT), (a, a), wait_events=[cap])


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_eager_transfers_are_transfer_only_events(P):
    ctx = P.ctx()
    q = P.core.CommandQueue(ctx)
    x = P.array(_x(4))
    dst = ctx.create_buffer(P.zeros_like(x))
    wev = q.enqueue_write_buffer(dst, x)
    expect = P.core.transfer_time(P.core.EGPU_16T, 8 * 8 * 4)
    assert dataclasses.asdict(wev.modeled) == dataclasses.asdict(expect)
    assert wev.modeled.compute == wev.modeled.startup == 0.0
    assert wev.energy_j > 0
    np.testing.assert_array_equal(P.numpy(dst.data), _x(4))
    rev = q.enqueue_read_buffer(dst)
    assert wev in rev.deps                   # in-order chain
    (out,) = rev.wait()
    assert out is dst
    cpy = ctx.create_buffer(P.zeros_like(x))
    cev = q.enqueue_copy_buffer(dst, cpy)
    q.finish()
    np.testing.assert_array_equal(P.numpy(cpy.data), _x(4))
    assert cev.modeled.transfer == expect.transfer
    assert q.total_modeled_s() == pytest.approx(3 * expect.total_s)
    k = q.enqueue_nd_range(_mm(P), _ndr(P), (cpy, cpy))
    assert cev in k.deps                     # dataflow from the copy
    with pytest.raises(ValueError, match="does not match"):
        q.enqueue_write_buffer(dst, P.array(np.zeros((4, 4), np.float32)))
    ro, wo = ctx.create_buffer(x, flags="r"), ctx.create_buffer(x, flags="w")
    with pytest.raises(ValueError, match="read-only"):
        q.enqueue_write_buffer(ro, x)
    with pytest.raises(ValueError, match="read-only"):
        q.enqueue_copy_buffer(dst, ro)
    with pytest.raises(ValueError, match="write-only"):
        q.enqueue_read_buffer(wo)
    with pytest.raises(ValueError, match="write-only"):
        q.enqueue_write_buffer(dst, wo)


def test_write_source_moves_to_the_context_device():
    """A numpy or CPU source of a write becomes a buffer on the context's
    device, eagerly and as a capture's external slot."""
    ctx = PORT.ctx()
    q = tcore.CommandQueue(ctx)
    dst = ctx.create_buffer(torch.zeros(8, 8))
    src = _x(5)
    q.enqueue_write_buffer(dst, src)
    assert isinstance(dst.data, torch.Tensor)
    assert dst.data.device == ctx.torch_device
    src[0, 0] = 99.0                          # a later host edit ...
    np.testing.assert_array_equal(dst.data.numpy(), _x(5))   # ... is not seen
    with q.capture() as g:
        q.enqueue_write_buffer(dst, _x(6))
        q.enqueue_read_buffer(dst)
    assert all(v.device == ctx.torch_device for v in g._ext_values)
    np.testing.assert_array_equal(g.launch()[0].data.numpy(), _x(6))


# -- the DAG benches -----------------------------------------------------------
def test_bench_transfer_modeled_equals_reference():
    from benchmarks import bench_transfer as jb
    from benchmarks_torch import bench_transfer as tb
    jctx = JAX.ctx()
    tctx = PORT.ctx()
    for jcap, tcap in ((jb._capture_explicit, tb._capture_explicit),
                       (jb._capture_naive, tb._capture_naive)):
        assert _structure(tcap(tctx)) == _structure(jcap(jctx))
    row = tb.run("cpu")
    jdag, _ = jb._capture_explicit(jctx).fused_modeled()
    jchain, _ = jb._capture_naive(jctx).fused_modeled()
    assert row["explicit_vs_naive_speedup"] == jchain.total_s / jdag.total_s
    assert row["modeled_explicit_dag_us"] == jdag.total_s * 1e6
    assert (row["explicit_transfer_nodes"], row["naive_transfer_nodes"]) == (6, 17)


def test_bench_multiqueue_modeled_equals_reference():
    from benchmarks import bench_multiqueue as jb
    from benchmarks_torch import bench_multiqueue as tb
    jctx, tctx = JAX.ctx(), PORT.ctx()
    for ooo in (True, False):
        assert _structure(tb._capture(tctx, ooo)) == \
            _structure(jb._capture(jctx, ooo))
    row = tb.run("cpu")
    jdag, _ = jb._capture(jctx, True).fused_modeled()
    jchain, _ = jb._capture(jctx, False).fused_modeled()
    assert row["critical_path_speedup"] == jchain.total_s / jdag.total_s
    assert row["modeled_chain_us"] == jchain.total_s * 1e6
