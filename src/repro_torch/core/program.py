"""Tiny-OpenCL host API — ``Program`` / ``KernelRegistry`` objects.

The paper's Tiny-OpenCL (§IV) is a *real* (if tiny) OpenCL host API: the
host builds a program, creates kernel objects from it, sets their arguments
and enqueues them.  This module is the clProgram/clKernel analogue:

* every kernel family registers a **builder** through the
  :func:`kernel_family` decorator into one :class:`KernelRegistry`
  (``clCreateProgramWithBuiltInKernels`` semantics — the e-GPU ships its
  kernels pre-compiled, there is no runtime source compiler);
* :meth:`Program.build` binds the registry to one
  :class:`~repro_torch.core.device.EGPUConfig` (the clBuildProgram
  analogue);
* :meth:`Program.create_kernel` returns a configured
  :class:`~repro_torch.core.runtime.Kernel` — **memoized** per
  ``(family, config, variant)``, so repeated builds reuse the same kernel
  object and keep a stable identity;
* the created kernel carries its registry identity (``kernel.family`` /
  ``kernel.config`` / ``kernel.variant``).

Builders are plain functions ``builder(config, **variant) -> Kernel``.  The
built-in families live in ``repro_torch.kernels.*.ops`` and are imported
lazily on first :meth:`Program.build`; applications may register their own
families (namespaced names like ``"tinybio.fft_features"`` recommended).

OpenCL mapping::

    clCreateProgramWithBuiltInKernels  ->  Program.build(config)
    clCreateKernel(program, name)      ->  program.create_kernel(name)
    clCreateKernelsInProgram           ->  program.create_kernels()
    clGetKernelArgInfo                 ->  kernel.arg_info
    clSetKernelArg                     ->  kernel.set_arg / kernel.set_args
    clEnqueueNDRangeKernel             ->  queue.enqueue_kernel(kernel, ndr)
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

from .device import EGPUConfig, EGPU_16T
from .runtime import Kernel

#: built-in kernel families -> module whose import registers them.  Imports
#: are lazy (first ``Program.build``) so ``import repro_torch.core`` stays
#: light.  Only the families that have a Hopper kernel are listed.
BUILTIN_FAMILIES: Dict[str, str] = {
    "stockham_fft": "repro_torch.kernels.stockham_fft.ops",
    "fir": "repro_torch.kernels.fir.ops",
    "delineate": "repro_torch.kernels.delineate.ops",
    "svm": "repro_torch.kernels.svm.ops",
    "gemm": "repro_torch.kernels.gemm.ops",
}


class KernelRegistry:
    """Name -> builder mapping populated by :func:`kernel_family`.

    One process-wide instance (:data:`REGISTRY`) backs every
    :class:`Program`; tests may instantiate private registries.
    """

    def __init__(self) -> None:
        self._builders: Dict[str, Callable[..., Kernel]] = {}

    def register(self, name: str, builder: Callable[..., Kernel],
                 replace: bool = False) -> None:
        if not name or not isinstance(name, str):
            raise ValueError(f"kernel family name must be a non-empty str, "
                             f"got {name!r}")
        if name in self._builders and not replace:
            existing = self._builders[name]
            if existing is builder:        # idempotent re-import
                return
            raise ValueError(
                f"kernel family {name!r} is already registered "
                f"({existing.__module__}.{existing.__qualname__}); pass "
                "replace=True to override")
        self._builders[name] = builder

    def builder(self, name: str) -> Callable[..., Kernel]:
        try:
            return self._builders[name]
        except KeyError:
            known = ", ".join(sorted(self._builders)) or "<none>"
            raise KeyError(
                f"unknown kernel family {name!r}; registered: {known}"
            ) from None

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._builders))

    def __contains__(self, name: str) -> bool:
        return name in self._builders

    def __len__(self) -> int:
        return len(self._builders)


#: the process-wide registry every ``Program`` builds from by default
REGISTRY = KernelRegistry()


def kernel_family(name: str, registry: Optional[KernelRegistry] = None,
                  replace: bool = False):
    """Decorator registering ``builder(config, **variant) -> Kernel``.

    ::

        @kernel_family("fir")
        def build_kernel(config=EGPU_16T) -> Kernel:
            ...

    The builder must be deterministic in ``(config, variant)`` — the
    resulting kernel is memoized on exactly that key.
    """
    def deco(builder: Callable[..., Kernel]) -> Callable[..., Kernel]:
        (registry if registry is not None else REGISTRY).register(
            name, builder, replace=replace)
        return builder
    return deco


def _variant_key(builder: Callable[..., Kernel],
                 variant: Dict[str, Any]) -> Tuple[Tuple[str, Hashable], ...]:
    """Canonical hashable variant key: the builder's keyword defaults merged
    with the caller's overrides, so ``create_kernel("tinybio.fft_features")``
    and ``create_kernel("tinybio.fft_features", win=512)`` share one memo
    entry."""
    merged = dict(variant)
    try:
        params = list(inspect.signature(builder).parameters.values())
    except (TypeError, ValueError):
        params = []
    for p in params[1:]:                       # skip the config positional
        if (p.default is not p.empty and p.name not in merged
                and p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)):
            merged[p.name] = p.default
    try:
        return tuple(sorted((k, v) for k, v in merged.items()))
    except TypeError as e:
        raise TypeError(
            f"kernel variant values must be hashable "
            f"(memoization key): {variant!r}") from e


class Program:
    """A built Tiny-OpenCL program: the registry bound to one device config.

    ``Program.build(config)`` is memoized per ``(config, registry)``;
    :meth:`create_kernel` is memoized per ``(family, config, variant)`` in a
    process-wide table, so two programs built for the same config hand out
    the *same* kernel objects.
    """

    _programs: Dict[Tuple[int, EGPUConfig], "Program"] = {}
    _kernels: Dict[Tuple[int, str, EGPUConfig,
                         Tuple[Tuple[str, Hashable], ...]], Kernel] = {}

    def __init__(self, config: EGPUConfig = EGPU_16T,
                 registry: Optional[KernelRegistry] = None):
        self.config = config
        self.registry = registry if registry is not None else REGISTRY
        if self.registry is REGISTRY:
            self._ensure_builtins()

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, config: EGPUConfig = EGPU_16T,
              registry: Optional[KernelRegistry] = None) -> "Program":
        """clBuildProgram analogue (memoized — building twice is free).

        The key is the *whole* frozen config, so a program (and below, every
        kernel) builds once per (structural knobs, DVFS operating point).
        """
        reg = registry if registry is not None else REGISTRY
        key = (id(reg), config)
        prog = cls._programs.get(key)
        if prog is None:
            prog = cls(config, reg)
            cls._programs[key] = prog
        return prog

    def _ensure_builtins(self) -> None:
        for name, module in BUILTIN_FAMILIES.items():
            if name not in self.registry:
                importlib.import_module(module)

    # -- kernel creation ----------------------------------------------------
    @property
    def kernel_names(self) -> Tuple[str, ...]:
        """Every kernel family this program can create (sorted)."""
        return self.registry.names()

    def create_kernel(self, name: str, **variant: Any) -> Kernel:
        """clCreateKernel analogue: a configured, memoized :class:`Kernel`.

        ``variant`` keywords are forwarded to the family's builder; distinct
        variants are distinct kernels.
        """
        builder = self.registry.builder(name)
        vkey = _variant_key(builder, variant)
        key = (id(self.registry), name, self.config, vkey)
        kern = Program._kernels.get(key)
        if kern is None:
            built = builder(self.config, **variant)
            if not isinstance(built, Kernel):
                raise TypeError(
                    f"builder for family {name!r} returned "
                    f"{type(built).__name__}, expected Kernel")
            kern = built.with_identity(family=name, config=self.config,
                                       variant=vkey)
            Program._kernels[key] = kern
        return kern

    def create_kernels(self, **variant: Any) -> Dict[str, Kernel]:
        """clCreateKernelsInProgram analogue: one kernel per family."""
        return {name: self.create_kernel(name, **variant)
                for name in self.kernel_names}

    def __contains__(self, name: str) -> bool:
        return name in self.registry

    def __repr__(self) -> str:
        return (f"Program(config={self.config.name!r}, "
                f"families={len(self.registry)})")
