"""TinyBio on the PyTorch port — the paper's Fig-4 application, end to end.

Runs the 4-stage biosignal pipeline (FIR band-pass → peak/trough
delineation → Stockham-FFT spectral features → SVM cognitive-workload
decision) on every e-GPU configuration, through the port's hand-written
CUDA kernels on the card, printing the per-stage speed-up / energy table
the paper reports, plus the functional outputs.  The port of
``examples/tinybio_pipeline.py``.

Run:  PYTHONPATH=src python examples/tinybio_pipeline_torch.py [--device cpu]
"""

import argparse

from repro_torch.apps.tinybio import TINYBIO_WORKLOAD, run_tinybio
from repro_torch.core import EGPU_4T, EGPU_8T, EGPU_16T

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda",
                    help="torch device the kernels run on (default: cuda)")
device = parser.parse_args().device

print(f"workload: {TINYBIO_WORKLOAD}")
print()
header = f"{'config':10s} {'stage':15s} {'speed-up':>9s} {'energy x':>9s}"
for cfg in (EGPU_4T, EGPU_8T, EGPU_16T):
    decisions, report = run_tinybio(cfg, device=device)
    print(header)
    for st in report.stages:
        print(f"{cfg.name:10s} {st.name:15s} {st.speedup:8.2f}x "
              f"{st.energy_reduction:8.2f}x")
    print(f"{cfg.name:10s} {'WHOLE APP':15s} {report.overall_speedup:8.2f}x "
          f"{report.overall_energy_reduction:8.2f}x")
    pos = int((decisions > 0).sum())
    print(f"  -> {pos}/{decisions.shape[0]} windows classified "
          f"high-workload\n")

print("paper Fig 4: fir 3.6-15.1x | delineation 3.1-13.1x | fft 3.3-14.0x "
      "| app 3.4-14.3x | energy 1.7-3.1x")
