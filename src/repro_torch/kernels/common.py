"""Shared helpers for the Hopper kernels: sizes, dispatch, build, launch.

Every kernel of this package is CUDA C++ under ``repro_torch/csrc/``,
compiled for ``sm_90a`` into one shared library with a plain C interface and
bound with ``ctypes``.  Each family's ``ops`` module has a dispatching
wrapper with one rule (:func:`on_card`):

* a CUDA tensor launches the hand-written kernel (or the wrapper raises);
* a CPU tensor runs the plain PyTorch version beside it;
* a ``meta`` tensor runs the plain version too, which only propagates
  shapes and dtypes — that is how a capture infers its output shapes.

A wrapper whose kernel serves batched requests reaches its launch through
a custom op (:func:`card_op`) with a vmap rule, so ``torch.func.vmap`` of
the wrapper on the card is one launch over the whole batch.

The library is built at first use, by :func:`kernel_library`, into
``build/repro_torch/`` at the root of the checkout: ``nvcc`` from
``torch.utils.cpp_extension.CUDA_HOME`` compiles every source at once, one
process each, then links them.  Nothing is built or loaded at import time,
so the CPU-only tests import every module without a CUDA toolkit.

Every launch goes through :func:`launch`, which raises on a non-zero
``cudaError_t`` and then adds one to :data:`LAUNCHES` for the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
#: build output, at the root of the checkout (``src/repro_torch/kernels``
#: -> three levels up); listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: kernel name -> launches of its CUDA kernel in this process.  Each wrapper
#: adds one where it launches (through :func:`launch`) and nowhere else;
#: the plain versions never count.
LAUNCHES: Dict[str, int] = {"fir": 0, "delineate": 0, "stockham_fft": 0,
                            "svm": 0, "gemm": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0,
                            "decode_attention": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0, "rwkv6_scan": 0,
                            "rwkv6_scan_bwd": 0, "norm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_dim(x: torch.Tensor, axis: int, multiple: int, fill=0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` with ``fill`` up to a multiple of ``multiple``."""
    axis = axis % x.dim()
    size = x.shape[axis]
    target = round_up(size, multiple)
    if target == size:
        return x
    pads = [0, 0] * (x.dim() - axis)
    pads[-1] = target - size
    return F.pad(x, pads, value=fill)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel);
    False for CPU or ``meta`` tensors (run the plain version).  Raises for
    tensors on different devices or on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"kernel inputs lie on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def check_dtype(what: str, t: torch.Tensor, allowed: Sequence[torch.dtype]) -> None:
    if t.dtype not in allowed:
        names = ", ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"{what} must be one of {names}; got {t.dtype}")


def check_contiguous(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer for ctypes (NULL for None).  A DTensor
    raises ``TypeError``: a kernel takes a rank's block only through
    :func:`repro_torch.distributed.sharding.on_blocks`, which places it
    first; its local tensor is never taken here."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        raise TypeError("a kernel was handed a DTensor: kernel wrappers run "
                        "on each rank's block through sharding.on_blocks")
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream on ``t``'s device, for ctypes."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# Card launches as custom ops (batching under ``torch.func.vmap``)
# ---------------------------------------------------------------------------
#: namespace of the custom ops that carry the card launches: the package's
#: own top-level name, so a second copy of the package loaded under another
#: name registers its own ops
OP_NAMESPACE = __name__.split(".")[0]


def card_op(name: str):
    """Register the decorated function, a wrapper's card path, as the custom
    op ``OP_NAMESPACE::name`` (for every device: the public wrapper decides
    where it runs).  ``torch.func.vmap`` cannot look inside a ctypes launch,
    so each such op gets a fake (shapes for ``meta``) and a vmap rule that
    folds the vmapped batch into the kernel's own batch axis: a vmapped
    call is one launch."""
    return torch.library.custom_op(f"{OP_NAMESPACE}::{name}", mutates_args=())


def unbatched_rest(op: str, in_dims: Sequence[Optional[int]],
                   n_batched: int = 1) -> None:
    """Raise unless only the first ``n_batched`` arguments of a vmapped
    card op carry the batch axis (the rest — taps, support vectors, bias —
    are broadcast constants)."""
    if any(d is not None for d in in_dims[n_batched:]):
        raise NotImplementedError(
            f"{op}: only the first {n_batched} argument(s) may carry a vmap "
            "batch axis; the others are constants of the batch")


def fold_batch(x: torch.Tensor, bdim: Optional[int], inner: int
               ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A vmapped argument with its batch axis moved first and every axis
    before its last ``inner`` ones folded into one leading axis, contiguous,
    and the leading shape to restore on the output."""
    x = x.movedim(bdim, 0) if bdim is not None else x
    lead = tuple(x.shape[:x.dim() - inner])
    return x.reshape((-1,) + tuple(x.shape[x.dim() - inner:])).contiguous(), lead


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (torch.utils.cpp_extension.CUDA_HOME is "
            "None); the kernels need nvcc to build")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    """Where the library for the current sources lives: the name carries a
    digest of every source and header and of the flags, so an edited source
    builds anew and a stale library is never loaded."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, Any]:
    """Compile ``csrc/*.cu`` for sm_90a into one shared library, unless the
    library for these exact sources exists already.

    Every source compiles in its own ``nvcc`` process, all started together;
    one more ``nvcc`` links the objects.  Returns ``{"path", "built",
    "seconds"}``.
    """
    out = library_path()
    if out.exists():
        return {"path": out, "built": False, "seconds": 0.0}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _obj, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _src, obj, _p in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _src, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    return {"path": out, "built": True, "seconds": time.perf_counter() - t0}


_LIBRARY: Optional[ctypes.CDLL] = None


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        lib = ctypes.CDLL(str(build_kernels()["path"]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBRARY = lib
    return _LIBRARY


def launch(kernel: str, symbol: str, argtypes: Sequence[Any],
           *args: Any) -> None:
    """Call the C function ``symbol`` (which launches ``kernel`` on the
    stream passed last and returns its ``cudaError_t``), raise if the launch
    failed, and count it."""
    lib = kernel_library()
    fn = getattr(lib, symbol)
    if fn.argtypes is None:                  # first call: declare the types
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1
