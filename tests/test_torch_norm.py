"""The norm kernel family (``repro_torch.kernels.norm``) on the CPU.

The card runs ``csrc/norm.cu``; here the wrappers run their plain versions,
which must be the models' norms exactly as the call sites computed them
before the kernel existed (the copies below), bit for bit, so that the CPU
tokens held against the JAX package do not move.  Against the JAX
package's norms on numpy inputs from a seed, in f32: within 1e-6 of the
largest magnitude (the same f32 arithmetic, sums in another order).

The card path's backward (``ops._Norm``, PyTorch ops on the kernel's saved
statistics) runs here on a forward that computes the statistics in plain
PyTorch (monkeypatched): its gradients against autograd of the plain
version, within 1e-5 of each gradient's largest magnitude (f32 sums in
another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro_torch import configs
from repro_torch.kernels import common
from repro_torch.kernels.norm import ops
from repro_torch.kernels.norm.ops import group_norm, layer_norm, rms_norm
from repro_torch.kernels.norm.ref import (group_norm_ref, layer_norm_ref,
                                          rms_norm_ref)
from repro_torch.models import frontends, layers, rwkv


# the call sites' code before the kernel (models/layers.py apply_norm and
# rms_norm_1d, models/rwkv.py _group_norm, models/frontends.py embed_audio)
def _old_apply_norm(scale, bias, x, kind, eps):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.float() + bias.float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        y = y * scale.float()
    return y.to(x.dtype)


def _old_rms_norm_1d(x, scale, eps):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _old_group_norm(x, scale, h, hd, eps):
    b, t, _ = x.shape
    xh = x.reshape(b, t, h, hd).float()
    mu = xh.mean(-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)
    xn = (xh - mu) * torch.rsqrt(var + eps)
    return (xn.reshape(b, t, h * hd) * scale.float()).to(x.dtype)


def _old_audio_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _x(shape, seed, loc=0.0):
    rng = np.random.default_rng(seed)
    return (loc + 3 * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rtol):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


DTYPES = [torch.float32, torch.bfloat16]
SHAPES = [(1, 1, 64), (3, 5, 256), (2, 7, 2560)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forms_are_the_call_sites_code_bit_for_bit(dtype, shape):
    x = torch.from_numpy(_x(shape, 1, 0.5)).to(dtype)
    d = shape[-1]
    scale = torch.from_numpy(_x(d, 2))
    bias = torch.from_numpy(_x(d, 3))
    assert torch.equal(rms_norm_ref(x, scale, 1e-6),
                       _old_apply_norm(scale, None, x, "rms", 1e-6))
    assert torch.equal(rms_norm_ref(x, scale, 1e-5),
                       _old_rms_norm_1d(x, scale, 1e-5))
    assert torch.equal(layer_norm_ref(x, scale, bias, 1e-5),
                       _old_apply_norm(scale, bias, x, "layernorm", 1e-5))
    assert torch.equal(group_norm_ref(x, scale, None, 32, 1e-5),
                       _old_group_norm(x, scale, d // 32, 32, 1e-5))
    assert torch.equal(group_norm_ref(x, scale, bias, d, 1e-5),
                       _old_audio_norm(x, scale, bias, 1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_run_the_plain_forms_on_the_cpu_and_launch_nothing(dtype):
    x = torch.from_numpy(_x((4, 3, 128), 4)).to(dtype)
    scale, bias = torch.from_numpy(_x(128, 5)), torch.from_numpy(_x(128, 6))
    before = dict(common.LAUNCHES)
    assert torch.equal(rms_norm(x, scale, 1e-6), rms_norm_ref(x, scale, 1e-6))
    assert torch.equal(layer_norm(x, scale, bias, 1e-5),
                       layer_norm_ref(x, scale, bias, 1e-5))
    assert torch.equal(group_norm(x, scale, None, 64, 1e-5),
                       group_norm_ref(x, scale, None, 64, 1e-5))
    assert torch.equal(group_norm(x, scale, bias, 128, 1e-5),
                       group_norm_ref(x, scale, bias, 128, 1e-5))
    assert common.LAUNCHES == before


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "stablelm-1.6b"])
def test_apply_norm_matches_the_reference(arch):
    cfg = configs.get(arch).reduced()
    jcfg = J_ARCHS[arch].reduced()
    d = cfg.d_model
    x = _x((3, 9, d), 7, 0.5)
    p = {"scale": _x(d, 8), "bias": _x(d, 9)}
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg)
    _close(got.numpy(), want, 1e-6)


def test_latent_norms_match_the_reference():
    for width in (32, 512, 1536):
        x, scale = _x((2, 3, width), 10, 0.5), _x(width, 11)
        _close(layers.rms_norm_1d(torch.from_numpy(x), torch.from_numpy(scale),
                                  1e-6).numpy(),
               jlayers.rms_norm_1d(jnp.asarray(x), jnp.asarray(scale), 1e-6),
               1e-6)


def test_rwkv_group_norm_matches_the_reference():
    cfg = configs.get("rwkv6-3b")
    h, hd = cfg.n_heads, cfg.head_dim                 # 40 heads of 64
    y, scale = _x((2, 5, h * hd), 12, 0.5), _x(h * hd, 13)
    _close(rwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale), h,
                            hd, cfg.norm_eps).numpy(),
           jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), h, hd,
                             cfg.norm_eps), 1e-6)


def test_audio_frontend_norm_matches_the_reference():
    """The frontend's LayerNorm alone: an identity adapter at d_model = the
    feature width, so the JAX frontend's output is its norm of frames +
    positions."""
    d = frontends.AUDIO_FEATURE_DIM
    cfg = dataclasses.replace(configs.get("hubert-xlarge").reduced(),
                              d_model=d)
    jcfg = dataclasses.replace(J_ARCHS["hubert-xlarge"].reduced(), d_model=d)
    frames = _x((2, 11, d), 14)
    scale, bias = _x(d, 15), _x(d, 16)
    pj = {"proj": jnp.eye(d, dtype=jnp.float32), "ln_scale": jnp.asarray(scale),
          "ln_bias": jnp.asarray(bias)}
    x = torch.from_numpy(frames) + layers.sinusoidal_positions(11, d)[None]
    got = group_norm(x, torch.from_numpy(scale), torch.from_numpy(bias), d,
                     cfg.norm_eps)
    _close(got.numpy(), jfrontends.embed_audio(pj, jnp.asarray(frames), jcfg),
           1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_run_on_meta_tensors(dtype):
    x = torch.empty((2, 3, 256), dtype=dtype, device="meta")
    scale = torch.empty(256, device="meta")
    for y in (rms_norm(x, scale, 1e-6), layer_norm(x, scale, scale, 1e-5),
              group_norm(x, scale, None, 64, 1e-5)):
        assert y.shape == x.shape and y.dtype == dtype and y.is_meta


def test_group_must_divide_the_row():
    with pytest.raises(ValueError, match="does not divide"):
        group_norm(torch.zeros(2, 100), torch.ones(100), None, 64, 1e-5)


def _plain_forward(x, scale, bias, group, eps, layer, *, stats):
    """``ops._forward`` in plain PyTorch on the CPU: y and each group's f32
    mean and rstd."""
    d = x.shape[-1]
    xg = x.float().reshape(-1, d // group, group)
    mu = xg.mean(-1) if layer else torch.zeros(xg.shape[:-1])
    var = ((xg - mu[..., None]) ** 2).mean(-1)
    rstd = torch.rsqrt(var + eps)
    y = ((xg - mu[..., None]) * rstd[..., None]).reshape(x.shape) * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype), (mu if layer else None), rstd


@pytest.mark.parametrize("form", ["rms", "layer", "group", "group_bias"])
def test_card_backward_matches_autograd_of_the_plain_version(monkeypatch,
                                                             form):
    monkeypatch.setattr(ops, "_forward", _plain_forward)
    d, eps = 256, 1e-5
    x0 = torch.from_numpy(_x((3, 5, d), 17, 0.5)).double().float()
    s0 = torch.from_numpy(_x(d, 18) + 1)
    b0 = torch.from_numpy(_x(d, 19))
    dy = torch.from_numpy(_x((3, 5, d), 20))
    group, layer, with_bias = {"rms": (d, False, False),
                               "layer": (d, True, True),
                               "group": (64, True, False),
                               "group_bias": (32, True, True)}[form]

    def plain(x, s, b):
        if form == "rms":
            return rms_norm_ref(x, s, eps)
        if form == "layer":
            return layer_norm_ref(x, s, b, eps)
        return group_norm_ref(x, s, b if with_bias else None, group, eps)

    leaves = [t.clone().requires_grad_() for t in (x0, s0, b0)]
    y = ops._Norm.apply(leaves[0], leaves[1],
                        leaves[2] if with_bias else None, group, eps, layer)
    got = torch.autograd.grad(y, leaves[:3] if with_bias else leaves[:2], dy)
    leaves2 = [t.clone().requires_grad_() for t in (x0, s0, b0)]
    want_y = plain(*leaves2)
    want = torch.autograd.grad(want_y, leaves2[:3] if with_bias
                               else leaves2[:2], dy)
    _close(y.detach().numpy(), want_y.detach().numpy(), 1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g.numpy(), w.numpy(), 1e-5)


def test_card_backward_takes_bf16_inputs(monkeypatch):
    """A bf16 x gets a bf16 gradient (autograd of the plain version casts
    its f32 gradient the same way); scale's gradient stays f32."""
    monkeypatch.setattr(ops, "_forward", _plain_forward)
    x = torch.from_numpy(_x((4, 128), 21)).bfloat16().requires_grad_()
    s = torch.from_numpy(_x(128, 22)).requires_grad_()
    y = ops._Norm.apply(x, s, None, 128, 1e-6, False)
    gx, gs = torch.autograd.grad(y, (x, s), torch.ones_like(y))
    assert gx.dtype == torch.bfloat16 and gs.dtype == torch.float32
    x2 = x.detach().clone().requires_grad_()
    s2 = s.detach().clone().requires_grad_()
    wx, ws = torch.autograd.grad(rms_norm_ref(x2, s2, 1e-6), (x2, s2),
                                 torch.ones_like(y))
    _close(gs.numpy(), ws.numpy(), 1e-5)
    g, w = gx.float().numpy(), wx.float().numpy()
    assert (np.abs(g - w) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
            + 1e-5 * np.abs(w).max()).all()


def test_models_call_the_wrappers(monkeypatch):
    """apply_norm, rms_norm_1d, rwkv's group norm and the audio frontend
    reach the family's wrappers (so the card path launches the kernel)."""
    calls = []
    for name in ("rms_norm", "layer_norm"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    for mod in (rwkv, frontends):
        real = mod.group_norm
        monkeypatch.setattr(mod, "group_norm", lambda *a, _r=real, **k: (
            calls.append("group_norm"), _r(*a, **k))[1])
    x = torch.zeros(2, 3, 64)
    cfg_r = dataclasses.replace(configs.get("qwen2.5-3b").reduced(), d_model=64)
    cfg_l = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                                d_model=64)
    layers.apply_norm({"scale": torch.ones(64)}, x, cfg_r)
    layers.apply_norm({"scale": torch.ones(64), "bias": torch.zeros(64)}, x,
                      cfg_l)
    layers.rms_norm_1d(x, torch.ones(64), 1e-6)
    rwkv._group_norm(x, torch.ones(64), 2, 32, 1e-5)
    hub = configs.get("hubert-xlarge").reduced()
    frontends.embed_audio(
        {"proj": torch.zeros(frontends.AUDIO_FEATURE_DIM, hub.d_model),
         "ln_scale": torch.ones(hub.d_model),
         "ln_bias": torch.zeros(hub.d_model)},
        torch.zeros(1, 4, frontends.AUDIO_FEATURE_DIM), hub)
    assert calls == ["rms_norm", "layer_norm", "rms_norm", "group_norm",
                     "group_norm"]
