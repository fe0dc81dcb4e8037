"""TinyBio — the paper's 4-stage biosignal pipeline (MBio-Tracker, Fig 4).

    raw signal → FIR band-pass → delineation (peaks/troughs)
               → Stockham-FFT spectral features (+ time features)
               → SVM cognitive-workload decision

Workload (fixed, the paper's own): a 65536-sample recording (≈ 34 min of
respiration @ 32 Hz), 128-tap FIR, spectral features over 128 windows of 512
samples, an RBF SVM over 256 support vectors x 36 features (32 bands + 4
time-domain statistics), gamma = 0.5.

Every stage runs functionally (the hand-written CUDA kernels on the card,
their plain PyTorch versions on the CPU) AND is costed by the machine model —
the APU report carries both.  Inputs are made with numpy from the seed,
exactly as the JAX package makes them, so both packages see the same bits.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..core import (APU, EGPUConfig, EGPU_16T, Kernel, PipelineReport,
                    Program, Stage, kernel_family)
from ..core.runtime import resolve_device
from ..kernels.delineate import ops as delineate_ops
from ..kernels.stockham_fft import ops as fft_ops
from ..kernels.stockham_fft.ref import counts as fft_counts

TINYBIO_WORKLOAD = dict(n=65_536, taps=128, win=512, n_windows=128,
                        n_sv=256, n_features=36)   # 32 bands + 4 stats


def synth_signal(n: int, seed: int = 0) -> np.ndarray:
    """Synthetic respiration-like signal: slow oscillation + drift + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 32.0
    breath = np.sin(2 * np.pi * 0.25 * t) + 0.3 * np.sin(2 * np.pi * 0.08 * t)
    sig = breath + 0.1 * rng.standard_normal(n)
    return np.asarray(sig, np.float32)


def _feature_kernel(win: int, n_windows: int):
    """Stage 3: windowed power-spectrum features + time-domain stats.

    All windows go through the batched FFT kernel in ONE launch on
    (n_windows, win); the band means, statistics and normalization are plain
    tensor operations."""
    def features(x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
        w = x[: win * n_windows].reshape(n_windows, win)
        spec = fft_ops.power_spectrum(w)                    # (NW, win)
        nf = TINYBIO_WORKLOAD["n_features"]
        bands = spec[:, :win // 2].reshape(n_windows, nf - 4, -1).mean(-1)
        mean = w.mean(dim=1, keepdim=True)
        rms = torch.sqrt((w * w).mean(dim=1, keepdim=True))
        f = flags[: win * n_windows].reshape(n_windows, win)
        peaks = (f > 0).sum(dim=1, keepdim=True).to(torch.float32)
        troughs = (f < 0).sum(dim=1, keepdim=True).to(torch.float32)
        feats = torch.cat([bands, mean, rms, peaks, troughs], dim=1)
        # normalize for the RBF kernel
        return feats / (feats.abs().amax(dim=0, keepdim=True) + 1e-6)
    return features


# App-level Tiny-OpenCL registration: TinyBio's two composite stages join the
# same kernel registry the built-in families live in, so repeated
# ``tinybio_stages`` calls reuse the exact kernel objects.

@kernel_family("tinybio.delineate_keep")
def _build_delineate_keep(config: EGPUConfig = EGPU_16T) -> Kernel:
    """Delineation that also passes the filtered signal through:
    x -> (x, flags)."""
    del_k = Program.build(config).create_kernel("delineate")
    return Kernel("delineate_keep",
                  executor=lambda x: (x, delineate_ops.delineate(x, 0)),
                  counts=del_k.counts)


@kernel_family("tinybio.fft_features")
def _build_fft_features(config: EGPUConfig = EGPU_16T, *, win: int = 512,
                        n_windows: int = 128) -> Kernel:
    """Stage-3 spectral+time features at a fixed windowing."""
    return Kernel(name="fft_features",
                  executor=_feature_kernel(win, n_windows),
                  counts=lambda **kw: fft_counts(n=win).scaled(n_windows))


def tinybio_stages(config: EGPUConfig = EGPU_16T, seed: int = 0,
                   device: Any = "cuda"):
    """(stages, inputs) for :meth:`repro_torch.core.APU.offload`, with every
    constant and the input signal on ``device``."""
    dev = resolve_device(device)
    wl = TINYBIO_WORKLOAD
    n, taps, win, nw = wl["n"], wl["taps"], wl["win"], wl["n_windows"]
    rng = np.random.default_rng(seed + 1)
    h = np.asarray(np.hamming(taps) * np.sinc(np.linspace(-4, 4, taps)),
                   np.float32)
    h /= np.abs(h).sum()
    sv = np.asarray(rng.standard_normal((wl["n_sv"], wl["n_features"])),
                    np.float32)
    alpha = np.asarray(rng.standard_normal(wl["n_sv"]) / wl["n_sv"],
                       np.float32)

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(dev)

    program = Program.build(config)
    stages = [
        Stage(program.create_kernel("fir"), consts=(on(h),),
              counts_params={"n": n, "taps": taps, "itemsize": 2}),
        # delineate consumes the filtered signal; passes (signal, flags) on
        Stage(program.create_kernel("tinybio.delineate_keep"),
              counts_params={"n": n}),
        Stage(program.create_kernel("tinybio.fft_features", win=win,
                                    n_windows=nw),
              counts_params={}),
        Stage(program.create_kernel("svm"),
              consts=(on(sv), on(alpha), on(np.float32(0.1))),
              params={"gamma": 0.5},
              counts_params={"q": nw, "m": wl["n_sv"],
                             "d": wl["n_features"]}),
    ]
    inputs = (on(synth_signal(n, seed)),)
    return stages, inputs


def run_tinybio(config: EGPUConfig = EGPU_16T, seed: int = 0,
                mode: str = "graph", device: Any = "cuda"
                ) -> Tuple[torch.Tensor, PipelineReport]:
    """Run the full pipeline on an APU; returns (decisions, report).

    ``mode="graph"`` (default) captures all four stages into one TinyCL
    :class:`~repro_torch.core.runtime.CommandGraph` and launches it once;
    ``mode="eager"`` dispatches each stage as its own launch (on the e-GPU
    queue and again on the host queue).  ``device`` is the torch device the
    kernels run on.
    """
    apu = APU(config, device=device)
    outs, report = apu.offload(*tinybio_stages(config, seed, apu.device),
                               mode=mode)
    return outs[0].data, report
