"""The algorithm of the port's norm kernel, in plain PyTorch, against the
JAX package's norms on the CPU, and the plan and row stride that choose how
the kernel launches.

``csrc/norm.cu`` runs only on the card (``chip_smoke.py`` phase 2 holds it
against the plain versions there, a row alone against its batch row).
What can be checked here is its algorithm: a group cut into 16-byte
vectors, ``plan_norm(group, dtype)``'s threads a group each holding
``loads`` vectors (thread l the vectors l, l + threads, ...), each thread
adding its values in order, a butterfly over the group's lanes of a warp,
then the group's warps' sums in warp order; the mean (LayerNorm) and the
squared deviations from the registers; ``(x - mu) * rstd * scale (+
bias)``.  ``kernel_norm`` below is that algorithm step for step, with the
plan's constants read from the kernel's source; nothing but this test uses
it.  It takes the same numpy inputs, made from a seed, as the JAX package's
``apply_norm``, ``rms_norm_1d``, rwkv's ``_group_norm`` and the audio
frontend's LayerNorm, at every width the models use, in f32 and bf16.

Tolerances (``tests/test_torch_norm.py``'s): f32 within 1e-6 of the
largest magnitude (the same f32 arithmetic, sums in another order); bf16,
which both round from f32, within one bf16 ulp of each value plus the same
1e-6.  The kernel's fused multiply-add of a squared deviation is one in
float64 here, a rounding apart.
"""

import dataclasses
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro_torch.kernels.norm import norm as nk
from repro_torch.kernels.norm import ops
from repro_torch.kernels.norm.norm import plan_norm, row_stride

SOURCE = (Path(nk.__file__).resolve().parents[2] / "csrc" / "norm.cu").read_text()


def _constant(name):
    m = re.search(rf"\bconstexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in csrc/norm.cu"
    return int(m.group(1))


F32, BF16 = torch.float32, torch.bfloat16
WIDTHS = [512, 1280, 1536, 2048, 2560, 4096, 8192]


def test_the_plan_reads_the_kernels_constants():
    assert nk.VEC_BYTES == _constant("kVecBytes")
    assert nk.MAX_GROUP_THREADS == _constant("kMaxGroupThreads")
    assert nk.MAX_LOADS == _constant("kMaxLoads")
    for loads in (1, 2, 4, 8):
        assert f"case {loads}: launch_loads<T, {loads}>" in SOURCE


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("group", [64] + WIDTHS + [12288, 100, 7])
def test_the_plan_covers_the_group_from_its_width_and_dtype(group, dtype):
    plan = plan_norm(group, dtype)
    assert list(inspect.signature(plan_norm).parameters) == ["group", "dtype"]
    assert plan.vec == 16 // torch.empty((), dtype=dtype).element_size()
    assert plan.loads * plan.threads * plan.vec >= group
    assert (plan.loads - 1) * plan.threads * plan.vec < group or plan.loads == 1
    if plan.threads <= 32:
        assert plan.threads & (plan.threads - 1) == 0
    else:
        assert plan.threads % 32 == 0
    assert plan.threads * plan.groups <= nk.MAX_GROUP_THREADS
    assert plan_norm(group, dtype) == plan


def test_the_plans_of_the_models_widths():
    """2048 bf16: 256 threads, one load each; rwkv's groups of 64 bf16: 8
    lanes, 32 groups a block; 8192 f32: 512 threads, four loads each."""
    assert plan_norm(2048, BF16) == (8, 1, 256, 1)
    assert plan_norm(64, BF16) == (8, 1, 8, 32)
    assert plan_norm(512, BF16) == (8, 1, 64, 4)
    assert plan_norm(8192, F32) == (4, 4, 512, 1)


def kernel_norm(x, scale, bias, group, eps, layer):
    """The kernel's algorithm: x (..., d) in f32 or bf16, scale and bias
    (d,) f32 -> y in x's dtype."""
    plan = plan_norm(group, x.dtype)
    d = x.shape[-1]
    xs = x.float().reshape(-1, group)                       # units
    units = xs.shape[0]
    width = plan.loads * plan.threads * plan.vec
    xv = torch.zeros(units, width)
    xv[:, :group] = xs
    valid = torch.arange(width) < group
    # element (l * threads + t) * vec + i: [unit, l, t, i]
    xv = xv.reshape(units, plan.loads, plan.threads, plan.vec)
    ok = valid.reshape(plan.loads, plan.threads, plan.vec)

    def tree(s):                                             # (units, threads)
        lanes = min(plan.threads, 32)
        s = s.reshape(units, -1, lanes)
        o = lanes // 2
        while o:
            s = s + s[:, :, torch.arange(lanes) ^ o]
            o //= 2
        total = s[:, 0, 0]
        for w in range(1, s.shape[1]):
            total = total + s[:, w, 0]
        return total

    n = torch.tensor(float(group))
    mu = torch.zeros(units)
    if layer:
        s = torch.zeros(units, plan.threads)
        for l_ in range(plan.loads):
            for i in range(plan.vec):
                s = s + torch.where(ok[l_, :, i], xv[:, l_, :, i], 0.0)
        mu = tree(s) / n
    q = torch.zeros(units, plan.threads)
    for l_ in range(plan.loads):
        for i in range(plan.vec):
            c = xv[:, l_, :, i] - mu[:, None]
            fma = (c.double() * c.double() + q.double()).float()
            q = torch.where(ok[l_, :, i], fma, q)
    rstd = torch.rsqrt(tree(q) / n + eps)
    y = ((xs - mu[:, None]) * rstd[:, None]).reshape(x.shape) * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _x(shape, seed, loc=0.5):
    rng = np.random.default_rng(seed)
    return (loc + 3 * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, dtype):
    g = np.asarray(torch.as_tensor(got).float(), np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert g.shape == w.shape
    tol = 1e-6 * np.abs(w).max()
    if dtype == BF16:
        tol = tol + 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
    assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


def _jdtype(dtype):
    return jnp.float32 if dtype == F32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("width", WIDTHS)
def test_rms_and_layernorm_match_apply_norm(width, dtype):
    x = _x((3, 4, width), width)
    scale, bias = _x(width, 1, 0.0), _x(width, 2, 0.0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(_jdtype(dtype))
    for kind, eps, layer in (("rmsnorm", 1e-6, False), ("layernorm", 1e-5, True)):
        cfg = SimpleNamespace(norm=kind, norm_eps=eps)
        want = jlayers.apply_norm({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)}, xj, cfg)
        got = kernel_norm(xt, torch.from_numpy(scale),
                          torch.from_numpy(bias) if layer else None, width,
                          eps, layer)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("width", [512, 1536])
def test_the_latent_norms_match_rms_norm_1d(width, dtype):
    x, scale = _x((2, 5, width), 3 + width), _x(width, 4, 0.0)
    want = jlayers.rms_norm_1d(jnp.asarray(x).astype(_jdtype(dtype)),
                               jnp.asarray(scale), 1e-6)
    got = kernel_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
                      None, width, 1e-6, False)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rwkv_group_norm_matches_the_reference(dtype):
    h, hd = 40, 64                                # rwkv6-3b: 40 heads of 64
    y, scale = _x((2, 3, h * hd), 5), _x(h * hd, 6, 0.0)
    want = jrwkv._group_norm(jnp.asarray(y).astype(_jdtype(dtype)),
                             jnp.asarray(scale), h, hd, 1e-5)
    got = kernel_norm(torch.from_numpy(y).to(dtype), torch.from_numpy(scale),
                      None, hd, 1e-5, True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_audio_layernorm_matches_the_reference(dtype):
    """hubert's width: frames through an identity adapter into the first
    columns, positions added, then the frontend's LayerNorm with a bias;
    the kernel's input is the JAX frontend's own sum."""
    width, feat, s = 1280, jfrontends.AUDIO_FEATURE_DIM, 6
    jcfg = dataclasses.replace(J_ARCHS["hubert-xlarge"].reduced(),
                               d_model=width, dtype=str(jnp.dtype(_jdtype(dtype))))
    frames = _x((2, s, feat), 7)
    scale, bias = _x(width, 8, 0.0), _x(width, 9, 0.0)
    proj = jnp.eye(feat, width, dtype=jnp.float32)
    p = {"proj": proj, "ln_scale": jnp.asarray(scale),
         "ln_bias": jnp.asarray(bias)}
    want = jfrontends.embed_audio(p, jnp.asarray(frames), jcfg)
    dt = _jdtype(dtype)
    x = (jnp.dot(jnp.asarray(frames).astype(dt), proj.astype(dt))
         + jlayers.sinusoidal_positions(s, width).astype(dt)[None])
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
    got = kernel_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                      width, jcfg.norm_eps, True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("width", [64, 512, 2048, 8192])
def test_a_row_gets_the_same_bits_at_any_row_count(width, dtype):
    """Rows 1, 4 and 64: the plan reads no row count, so row 0's bits do
    not move."""
    x = torch.from_numpy(_x((64, width), 10 + width)).to(dtype)
    scale = torch.from_numpy(_x(width, 11, 0.0))
    bias = torch.from_numpy(_x(width, 12, 0.0))
    group = 64 if width == 64 else width
    for layer in (False, True):
        b_ = bias if layer else None
        alone = kernel_norm(x[:1], scale, b_, group, 1e-5, layer)
        for rows in (4, 64):
            assert torch.equal(kernel_norm(x[:rows], scale, b_, group, 1e-5,
                                           layer)[:1], alone)


def test_the_latent_slice_is_read_in_place(monkeypatch):
    """deepseek's kv_a[..., :512] of (B, S, 512 + 64): its rows lie 576
    apart, so the wrapper launches on the view itself (no copy) with that
    stride, and the kernel's algorithm over the view equals it over a
    contiguous copy."""
    kv_a = torch.from_numpy(_x((2, 3, 576), 13)).to(BF16)
    view = kv_a[..., :512]
    assert row_stride(view) == 576
    assert row_stride(kv_a[:, :, 64:]) == 576
    assert row_stride(kv_a.transpose(0, 1)) is None
    assert row_stride(kv_a.transpose(1, 2)) is None
    scale = torch.from_numpy(_x(512, 14, 0.0))
    seen = {}

    def fake_launch(x, y, scale_, bias, mean, rstd, *, group, eps, layer,
                    stride):
        seen.update(ptr=x.data_ptr(), stride=stride, shape=tuple(x.shape))
        y.copy_(kernel_norm(x, scale_, bias, group, eps, layer))

    monkeypatch.setattr(ops, "launch_norm", fake_launch)
    y = ops._forward(view, scale, None, 512, 1e-6, False, stats=False)[0]
    assert seen == {"ptr": kv_a.data_ptr(), "stride": 576,
                    "shape": (2, 3, 512)}
    assert y.is_contiguous() and y.shape == view.shape
    assert torch.equal(y, kernel_norm(view.contiguous(), scale, None, 512,
                                      1e-6, False))
    want = jlayers.rms_norm_1d(
        jnp.asarray(view.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(scale.numpy()), 1e-6)
    _close(y, want, BF16)
