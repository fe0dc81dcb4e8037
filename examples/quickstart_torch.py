"""Quickstart of the PyTorch port — the e-GPU paper's workflow on one GPU.

1. configure an e-GPU (Table-II knobs),
2. offload an int32 GeMM through the Tiny-OpenCL (TinyCL) runtime — the
   hand-written CUDA kernel ``csrc/gemm.cu`` on the card — and read the
   paper-calibrated speed-up / energy report,
3. one LM train step (a reduced qwen2.5-3b, remat "full"), whose attention
   gradient on the card is the hand-written ``csrc/flash_attention_bwd.cu``.

The three sections of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (APU, EGPU_16T, EGPU_4T, Program, Stage,
                              characterize, egpu_active_power_mw)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda",
                    help="torch device the kernels run on (default: cuda)")
device = parser.parse_args().device

print("=" * 70)
print("1) configure an e-GPU (paper Table II/III)")
print("=" * 70)
for cfg in (EGPU_4T, EGPU_16T):
    ch = characterize(cfg)
    print(f"  {cfg.name}: {cfg.compute_units} CUs x {cfg.threads_per_cu} "
          f"threads x {cfg.warps_per_cu} warps | D$ {cfg.dcache_bytes//1024} "
          f"KiB/{cfg.dcache_banks} banks | {ch.total_area_mm2:.2f} mm2, "
          f"{egpu_active_power_mw(cfg):.1f} mW")

print()
print("=" * 70)
print("2) offload a GeMM through TinyCL and compare against the host")
print("=" * 70)
rng = np.random.default_rng(0)
a = rng.integers(-64, 64, (256, 256)).astype(np.int32)   # int math:
b = rng.integers(-64, 64, (256, 256)).astype(np.int32)   # no FPU!
apu = APU(EGPU_16T, device=device)
# Tiny-OpenCL host API: build the program once, create kernel objects from
# the registry (clCreateProgramWithBuiltInKernels / clCreateKernel)
program = Program.build(EGPU_16T)
print(f"  program kernels: {', '.join(program.kernel_names)}")
stage = Stage(program.create_kernel("gemm"),
              counts_params={"m": 256, "n": 256, "k": 256})
# default NDRange = the paper's §VIII-B trick (work-items == hw threads,
# each looping internally) — scheduling collapses to the constant ~25 us
(out,), report = apu.offload([stage], (a, b))
np.testing.assert_array_equal(out.data.cpu().numpy(), a @ b)
st = report.stages[0]
print(f"  C=A@B 256x256 int32 on {apu.device.type} OK | modeled speed-up "
      f"{st.speedup:.1f}x | energy reduction {st.energy_reduction:.1f}x")
print(f"  phases: sched {st.egpu.scheduling_fraction*100:.1f}% | "
      f"transfer {st.egpu.transfer_fraction*100:.1f}%")

print()
print("=" * 70)
print("3) the same knob discipline at datacenter scale: one train step")
print("=" * 70)
import torch

from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.params import map_tree
from repro_torch.optim import constant_schedule
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)

cfg = ARCHS["qwen2.5-3b"].reduced()
tcfg = TrainConfig(remat="full")
step = make_train_step(cfg, tcfg, constant_schedule(1e-3))
state = init_train_state(cfg, tcfg, 0, device=device)
data = SyntheticLMData(DataConfig(4, 64, cfg.vocab), cfg)
batch = map_tree(lambda a: torch.from_numpy(a).to(device), data.batch_at(0))
state, metrics = step(state, batch)
print(f"  {cfg.name}: loss {float(metrics['loss']):.3f}, "
      f"grad-norm {float(metrics['grad_norm']):.2f} — same remat knob the "
      "JAX package's 398B dry-run uses")
print("\nquickstart OK")
