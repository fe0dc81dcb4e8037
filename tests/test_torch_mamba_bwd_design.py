"""The algorithm of the port's Mamba backward kernel, in plain PyTorch,
against the JAX package's gradient and the exact one, on the CPU.

``csrc/mamba_scan_bwd.cu`` runs only on the card (``chip_smoke.py`` phase
2 holds it against the plain backward there).  What can be checked here is
its algorithm, with the chunk, the threads a block, the most states a
thread and the sum kernel's runs read from the kernel's source and the
lanes and channels from :func:`plan_mamba_bwd`:

* a forward sweep keeping the state at the start of every chunk;
* then, chunk by chunk from the last, the chunk run forward again from its
  state, keeping each step's h_{t-1} and da_t = 2^(delta_t a log2 e), and
  the reverse walk with dh_t = dy_t c_t + carry and carry = da_t dh_t,
  which takes no exponential: two exponentials a step, channel and state
  in all;
* a channel's N states split over ``lanes`` threads of ``states`` each,
  each thread summing its states in order and the lanes' (sum_n dh b,
  ddelta) meeting by the kernel's reduce-scatter of shuffles;
* db_t and dc_t summed over channels as the kernel sums them: the halvings
  of a reduce-scatter of shuffles over the channels of each warp, then the
  block's shares in order (warp by warp, lane by lane), then
  ``mamba_bwd_sum_kernel``'s runs of consecutive blocks, each in order, and
  the runs in order; da over the steps in walk order, then over b in
  order.

``chunked_backward`` below is that algorithm step for step; nothing but
this test uses it.  Its exponentials are ``torch.exp2`` where the kernel
takes ``ex2.approx``.  Inputs are numpy arrays from a seed, in f32.

Tolerances: against ``jax.grad`` of the JAX package's XLA path, 1e-5 of
each gradient's largest magnitude (f32 sums in another order, as
``tests/test_torch_scan_backward.py`` holds the plain version); against
the gradient of the sequential recurrence in float64, 1e-4.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba_scan
from repro_torch.kernels.mamba_scan import mamba_scan as mm

SOURCE = (Path(mm.__file__).resolve().parents[2] / "csrc"
          / "mamba_scan_bwd.cu").read_text()
LOG2E = 1.4426950408889634


def _constant(name):
    m = re.search(rf"\bconstexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in csrc/mamba_scan_bwd.cu"
    return int(m.group(1))


THREADS = _constant("kThreads")
CHUNK = _constant("kC")
MAX_STATES = _constant("kMaxStates")
SUM_GROUPS = _constant("kSumGroups")


def reduce_scatter(v, top, lo):
    """The kernel's ``warp_reduce_scatter`` (csrc/common.cuh) over the lane
    axis (the last) of each tensor in the list ``v``: halvings at lane bits
    ``top``, ``top / 2``, .. while more than one value is left, then whole
    adds down to bit ``lo`` -> (the value each lane ends with, its index)."""
    lanes = torch.arange(32)
    idx = torch.zeros(32, dtype=torch.long)
    m = top
    while m >= lo:
        up = (lanes & m) != 0
        other = lanes ^ m
        if len(v) > 1:
            half = len(v) // 2
            v = [torch.where(up, v[e + half], v[e])
                 + torch.where(up, v[e], v[e + half])[..., other]
                 for e in range(half)]
            idx = idx + torch.where(up, half, 0)
        else:
            v = [v[0] + v[0][..., other]]
        m //= 2
    return v[0], idx


def _warp_shares(vals, lanes, states):
    """The threads' ``states`` values (..., warps, 32, states) after the
    halvings of the kernel's channel reduce-scatter, as the lanes leave
    them in shared memory -> (..., warps, G, N): G = 32 / (lanes states)
    lanes hold parts of each sum."""
    v, idx = reduce_scatter([vals[..., j] for j in range(states)], 16,
                            32 // states)
    g = 32 // lanes // states
    lane = torch.arange(32)
    out = torch.zeros(vals.shape[:-2] + (g, lanes * states))
    out[..., (lane // lanes) & (g - 1), (lane % lanes) * states + idx] = v
    return out


def _channel_sum(vals, lanes, states):
    """db_t or dc_t of one step: ``vals`` (B, blocks, warps, 32, states) ->
    (B, N): each block's shares in order (warp by warp, each warp's lanes
    in order), then the sum kernel's runs."""
    red = _warp_shares(vals, lanes, states).flatten(2, 3)
    part = red[:, :, 0]
    for w in range(1, red.shape[2]):
        part = part + red[:, :, w]
    blocks = part.shape[1]
    per = -(-blocks // SUM_GROUPS)
    runs = []
    for g in range(SUM_GROUPS):
        q0 = min(blocks, g * per)
        acc = torch.zeros(part.shape[0], part.shape[2])
        for q in range(q0, min(blocks, q0 + per)):
            acc = acc + part[:, q]
        runs.append(acc)
    total = runs[0]
    for r in runs[1:]:
        total = total + r
    return total


def chunked_backward(x, delta, a, b, c, dy):
    """The kernel's algorithm: x/delta/dy (B,T,Dm), a (Dm,N), b/c (B,T,N),
    all f32 -> (dx, ddelta (B,T,Dm), da (Dm,N), db, dc (B,T,N))."""
    bsz, t, dm = x.shape
    n = a.shape[1]
    plan = mm.plan_mamba_bwd(dm, n)
    lanes, states, ch = plan.lanes, plan.states, plan.channels
    assert (lanes, states, ch) == (n // min(n, MAX_STATES), min(n, MAX_STATES),
                                   THREADS // lanes)
    assert plan.chunk == CHUNK
    dmp = plan.blocks * ch                    # channels past Dm run as zeros
    chunks = -(-t // CHUNK)
    tp = chunks * CHUNK                       # steps past T run as zeros

    def pad(z, steps, chans):
        out = torch.zeros(z.shape[0], steps, chans)
        out[:, :z.shape[1], :z.shape[2]] = z
        return out

    x, delta, dy = (pad(z, tp, dmp) for z in (x, delta, dy))
    b, c = (pad(z, tp, n) for z in (b, c))
    ap = torch.zeros(dmp, n)
    ap[:dm] = a
    ap2 = ap * LOG2E
    warps = THREADS // 32

    def threads(z):
        """(B, Dmp, N) -> (B, blocks, warps, 32 lanes, states): thread
        cl * lanes + part holds channel cl's states [part S, part S + S)."""
        return z.reshape(bsz, plan.blocks, warps, 32, states)

    def lane_sum(z):
        """(B, Dmp, N) -> (B, Dmp, lanes): each thread's states in order."""
        z = z.reshape(bsz, dmp, lanes, states)
        acc = z[..., 0]
        for j in range(1, states):
            acc = acc + z[..., j]
        return acc

    def step(h, tt):
        da = torch.exp2(delta[:, tt, :, None] * ap2)
        inc = (delta[:, tt] * x[:, tt])[..., None] * b[:, tt, None, :]
        return da, da * h + inc

    # 1. the sweep: the state at the start of every chunk
    h = torch.zeros(bsz, dmp, n)
    starts = [h]
    for q in range(chunks - 1):
        for tt in range(q * CHUNK, (q + 1) * CHUNK):
            h = step(h, tt)[1]
        starts.append(h)

    dx, ddelta = torch.zeros(bsz, tp, dmp), torch.zeros(bsz, tp, dmp)
    db, dc = torch.zeros(bsz, tp, n), torch.zeros(bsz, tp, n)
    carry = torch.zeros(bsz, dmp, n)
    dav = torch.zeros(bsz, dmp, n)
    for q in range(chunks - 1, -1, -1):
        # 2. the chunk forward again, keeping h_{t-1} and da_t
        h = starts[q]
        kept = []
        for tt in range(q * CHUNK, (q + 1) * CHUNK):
            da, h_next = step(h, tt)
            kept.append((h, da))
            h = h_next
            dc[:, tt] = _channel_sum(threads(h * dy[:, tt, :, None]), lanes, states)
        # 3. the reverse walk
        for tt in range((q + 1) * CHUNK - 1, q * CHUNK - 1, -1):
            hp, da = kept[tt - q * CHUNK]
            g = dy[:, tt, :, None] * c[:, tt, None, :] + carry
            qv = g * (da * hp)
            dav = dav + delta[:, tt, :, None] * qv
            gb = lane_sum(g * b[:, tt, None, :])
            gd = x[:, tt, :, None] * gb + lane_sum(ap[None] * qv)
            if lanes > 1:
                pair = torch.stack([gb, gd], -1).reshape(bsz, dmp // (32 // lanes),
                                                         32, 2)
                v, which = reduce_scatter([pair[..., 0], pair[..., 1]],
                                          lanes // 2, 1)
                v = v.reshape(bsz, dmp, lanes)
                gb, gd = v[..., 0], v[..., lanes // 2]
                assert which[0] == 0 and which[lanes // 2] == 1
            else:
                gb, gd = gb[..., 0], gd[..., 0]
            dx[:, tt] = delta[:, tt] * gb
            ddelta[:, tt] = gd
            db[:, tt] = _channel_sum(
                threads(g * (delta[:, tt] * x[:, tt])[..., None]), lanes, states)
            carry = da * g
    da_sum = dav[0]
    for r in range(1, bsz):
        da_sum = da_sum + dav[r]
    return (dx[:, :t, :dm], ddelta[:, :t, :dm], da_sum[:dm], db[:, :t],
            dc[:, :t])


def sequential_grad64(x, delta, a, b, c, dy):
    """The gradient of sum(y * dy) for the sequential recurrence in
    float64 (autograd)."""
    leaves = [torch.from_numpy(z).double().requires_grad_()
              for z in (x, delta, a, b, c)]
    xs, ds, av, bs, cs = leaves
    h = torch.zeros(x.shape[0], x.shape[2], a.shape[1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(ds[:, t, :, None] * av) * h
             + (ds[:, t] * xs[:, t])[..., None] * bs[:, t, None, :])
        ys.append((h * cs[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1)
    return torch.autograd.grad(y, leaves, torch.from_numpy(dy).double())


def _inputs(seed, b, t, dm, n):
    """x, delta (softplus of a normal, as the model makes it), a (negative),
    b, c and dy, f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, dm))
    delta = np.log1p(np.exp(rng.standard_normal((b, t, dm)) - 1.0))
    a = -np.exp(0.5 * rng.standard_normal((dm, n)))
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    dy = rng.standard_normal((b, t, dm))
    return tuple(z.astype(np.float32) for z in (x, delta, a, bm, cm, dy))


def _jax_grads(ins):
    *xs, dy = (jnp.asarray(z) for z in ins)
    zero_d = jnp.zeros((ins[0].shape[2],), jnp.float32)   # the scan alone

    def loss(*args):
        return jnp.sum(j_mamba_scan(*args, zero_d, impl="xla")[0] * dy)

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(*xs)]


def _check(got, want, tol):
    for name, g, w in zip(("dx", "ddelta", "da", "db", "dc"), got, want):
        g = np.asarray(g.detach() if torch.is_tensor(g) else g, np.float64)
        w = np.asarray(w.detach() if torch.is_tensor(w) else w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


#: (B, T, Dm, N): N 2 (one lane a channel), 16 (4 lanes) and 32 (8 lanes);
#: T not a multiple of the chunk, Dm not a multiple of a block's channels
#: (over two blocks at N 16 and 32); against float64 also a T of one chunk
#: (each JAX shape costs a compile of ~2 s, the float64 gradient little)
SHAPES = [(2, 21, 130, 2), (2, 19, 100, 16), (2, 13, 40, 32)]


def test_the_plan_is_the_kernels_and_reads_no_batch():
    for n in mm.COMPILED_N:
        for dm in (1, 20, 300, 16384):
            plan = mm.plan_mamba_bwd(dm, n)
            assert plan.lanes * plan.states == n
            assert plan.states == min(n, MAX_STATES)
            assert plan.channels == THREADS // plan.lanes
            assert plan.blocks * plan.channels >= dm > (plan.blocks - 1) * plan.channels
    channels = THREADS // 4                  # jamba's N = 16: 4 lanes
    assert mm.plan_mamba_bwd(16384, 16) == (4, 4, channels, 16384 // channels,
                                            CHUNK)
    with pytest.raises(ValueError):
        mm.plan_mamba_bwd(64, 3)


def test_the_reverse_walk_takes_no_exponential():
    """Two ex2_sfu calls in the kernel: the sweep's and the recomputed
    chunk's; the walk reads the kept da."""
    body = SOURCE[SOURCE.index("mamba_bwd_kernel("):]
    body = body[:body.index("\n}\n")]
    assert body.count("ex2_sfu(") == 2
    walk = body[body.index("// 4. The reverse walk"):]
    assert "ex2_sfu(" not in walk


@pytest.mark.parametrize("b,t,dm,n", SHAPES)
def test_chunked_backward_matches_jax_grad(b, t, dm, n):
    ins = _inputs(t + dm + n, b, t, dm, n)
    got = chunked_backward(*(torch.from_numpy(z) for z in ins))
    _check(got, _jax_grads(ins), 1e-5)


@pytest.mark.parametrize("b,t,dm,n", SHAPES + [(1, 8, 40, 16)])
def test_chunked_backward_matches_the_float64_gradient(b, t, dm, n):
    ins = _inputs(2 * t + dm + n, b, t, dm, n)
    got = chunked_backward(*(torch.from_numpy(z) for z in ins))
    _check(got, sequential_grad64(*ins), 1e-4)
