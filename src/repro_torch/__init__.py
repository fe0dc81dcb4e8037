"""repro_torch — the e-GPU system in PyTorch, with hand-written Hopper kernels.

A port of the JAX package ``repro`` (which stays the reference): the
Tiny-OpenCL runtime, the analytic e-GPU machine model, ``APU.offload``, the
TinyBio pipeline and the GeMM of Fig. 3, and the LM serving path of the
dense archs (``models``, ``train.serve``).  Their kernels (FIR, delineation,
Stockham FFT, SVM, GeMM, flash attention) are CUDA C++ for ``sm_90a`` under
``repro_torch/csrc``.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where each kernel's plain PyTorch
version runs instead.
"""
