"""Hand-written Hopper kernels, one family per sub-package.

Each family has ``ref.py`` (the plain PyTorch version and the machine
model's ``counts``) and ``ops.py`` (the dispatching wrapper that launches the
CUDA kernel from ``repro_torch/csrc`` on a CUDA tensor, plus the family's
registry builder).
"""
