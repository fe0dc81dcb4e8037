"""e-GPU device configuration — the paper's Table II/III knobs.

The e-GPU paper's central contribution is a *configurability discipline*: the
accelerator's parallelism hierarchy (compute units / warps / threads) and its
memory hierarchy (I$ / D$ size, banks, line) are exposed as first-class knobs,
and a minimal NDRange runtime schedules arbitrary kernels onto whatever
configuration was instantiated.

This module holds:

* :class:`EGPUConfig` — the exact hardware knobs of paper Table II, with the
  three presets of Table III (4T / 8T / 16T) plus the X-HEEP host baseline.
* :class:`OperatingPoint` — a DVFS (frequency, voltage) pair.  The paper
  characterizes everything at 300 MHz / 0.8 V TSMC16 (:data:`OP_ANCHOR`);
  a config can be rebased onto any point with :meth:`EGPUConfig.at` and the
  power model (:mod:`repro_torch.core.power`) scales dynamic power ∝ f·V²
  and leakage with voltage.  ``freq_hz``/``voltage_v`` are ordinary config
  fields, so every memoization key that includes the config (program and
  kernel registries) keys on the operating point too.

A config is the *modeled* e-GPU; the torch device the kernels execute on is a
separate argument carried by :class:`~repro_torch.core.runtime.Context` and
:class:`~repro_torch.core.apu.APU`.  The projection of these knobs onto
Hopper kernel tiling is not part of this module.

Configs are plain frozen dataclasses, field for field the same as the JAX
package's, so the machine model built on them gives identical numbers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

KIB = 1024
MIB = 1024 * KIB


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One DVFS point: the (frequency, voltage) pair a config runs at.

    The paper's post-synthesis characterization is pinned at
    300 MHz / 0.8 V (:data:`OP_ANCHOR`); the named table
    :data:`OPERATING_POINTS` adds a low-voltage retention-class point and a
    turbo point in the ranges X-HEEP-class TSMC16 platforms expose.  Points
    are plain frozen dataclasses so they hash into memoization keys.
    """

    name: str
    freq_hz: float
    voltage_v: float

    def validate(self) -> "OperatingPoint":
        if self.freq_hz <= 0.0:
            raise ValueError(f"freq_hz must be positive, got {self.freq_hz}")
        if self.voltage_v <= 0.0:
            raise ValueError(
                f"voltage_v must be positive, got {self.voltage_v}")
        return self


#: the paper's calibration anchor: every fitted power/area constant in
#: :mod:`repro_torch.core.power` describes silicon at this point, and the
#: model's scale factors are exactly 1.0 here.
OP_ANCHOR = OperatingPoint("nominal", 300e6, 0.8).validate()

#: named DVFS points (f scales roughly linearly with V over this range, the
#: usual near-threshold..nominal TSMC16 corridor)
OPERATING_POINTS: Dict[str, OperatingPoint] = {
    p.name: p for p in (
        OperatingPoint("low", 100e6, 0.60).validate(),
        OP_ANCHOR,
        OperatingPoint("turbo", 450e6, 0.95).validate(),
    )
}


def env_op_point(value: Optional[str] = None) -> Optional[OperatingPoint]:
    """Resolve the ``REPRO_OP_POINT`` environment override.

    ``value`` (or the env var) is a name from :data:`OPERATING_POINTS` or an
    explicit ``"<freq_hz>:<voltage_v>"`` pair, e.g. ``"200e6:0.7"``.
    Returns ``None`` when unset/empty.
    """
    raw = os.environ.get("REPRO_OP_POINT", "") if value is None else value
    raw = raw.strip()
    if not raw:
        return None
    if raw in OPERATING_POINTS:
        return OPERATING_POINTS[raw]
    parts = raw.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"REPRO_OP_POINT={raw!r}: expected a name in "
            f"{sorted(OPERATING_POINTS)} or '<freq_hz>:<voltage_v>'")
    return OperatingPoint(f"env:{raw}", float(parts[0]),
                          float(parts[1])).validate()


@dataclasses.dataclass(frozen=True)
class EGPUConfig:
    """Hardware configuration of one e-GPU instance (paper Table II).

    All sizes in bytes.  The paper's presets (Table III) are exposed below as
    ``EGPU_4T`` / ``EGPU_8T`` / ``EGPU_16T``.
    """

    name: str = "e-gpu"
    compute_units: int = 2
    threads_per_cu: int = 8         # parallel threads (processing elements)
    warps_per_cu: int = 4           # concurrent warps (latency hiding)
    icache_bytes_per_cu: int = 2 * KIB
    icache_banks: int = 1
    icache_line_bytes: int = 16     # 4 instructions
    dcache_bytes: int = 16 * KIB    # shared across CUs
    dcache_banks: int = 8
    dcache_line_bytes: int = 32     # T x 4B  (one word per thread)
    # --- micro-architectural constants used by the machine model ---
    dcache_latency_cycles: int = 4  # paper §VII-A: shared D$ access latency
    host_bus_bytes_per_cycle: int = 4  # 32-bit OBI beats (paper §VIII-B)
    freq_hz: float = 300e6          # paper: 300 MHz @ 0.8 V, TSMC16
    has_fpu: bool = False           # removed for TinyAI (paper §IV-A)
    voltage_v: float = 0.8          # supply voltage of the operating point

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def total_threads(self) -> int:
        """Max resident work-items = CUs x warps x threads (paper §VIII-B)."""
        return self.compute_units * self.warps_per_cu * self.threads_per_cu

    @property
    def parallel_lanes(self) -> int:
        """Work executed per cycle across the device (one warp per CU issues)."""
        return self.compute_units * self.threads_per_cu

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.freq_hz

    @property
    def operating_point(self) -> OperatingPoint:
        """This config's DVFS point (a named table entry when it matches
        one exactly, else a ``custom`` point)."""
        for p in OPERATING_POINTS.values():
            if p.freq_hz == self.freq_hz and p.voltage_v == self.voltage_v:
                return p
        return OperatingPoint("custom", self.freq_hz, self.voltage_v)

    def at(self, point: OperatingPoint) -> "EGPUConfig":
        """The same silicon rebased onto another DVFS point.

        Only ``freq_hz``/``voltage_v`` change — name and every structural
        knob stay put, so ``config.at(OP_ANCHOR)`` round-trips exactly and
        area (:func:`repro_torch.core.power.characterize`) is invariant.
        """
        point.validate()
        return dataclasses.replace(self, freq_hz=point.freq_hz,
                                   voltage_v=point.voltage_v)

    def validate(self) -> "EGPUConfig":
        if self.compute_units < 1 or self.threads_per_cu < 1 or self.warps_per_cu < 1:
            raise ValueError(f"non-positive parallelism knob in {self}")
        if self.freq_hz <= 0.0 or self.voltage_v <= 0.0:
            raise ValueError(
                f"operating point must be positive: freq_hz={self.freq_hz}, "
                f"voltage_v={self.voltage_v}")
        for field in ("icache_bytes_per_cu", "dcache_bytes"):
            v = getattr(self, field)
            if v <= 0 or v & (v - 1):
                raise ValueError(f"{field}={v} must be a positive power of two")
        if self.dcache_line_bytes % 4:
            raise ValueError("dcache line must be a multiple of 4B (32-bit words)")
        if self.dcache_bytes % (self.dcache_banks * self.dcache_line_bytes):
            raise ValueError("dcache must divide evenly into banks x lines")
        return self


def _preset(name: str, threads: int) -> EGPUConfig:
    """Paper Table III: 2 CUs, 4 warps, 2 KiB I$/CU (1 bank, 16 B line),
    16 KiB shared D$ with T banks and T x 4 B lines."""
    return EGPUConfig(
        name=name,
        compute_units=2,
        threads_per_cu=threads,
        warps_per_cu=4,
        icache_bytes_per_cu=2 * KIB,
        icache_banks=1,
        icache_line_bytes=16,
        dcache_bytes=16 * KIB,
        dcache_banks=2 * threads // 2,   # 2 / 4 / 8 banks for 4T / 8T / 16T
        dcache_line_bytes=4 * threads,   # T x 4 B
    ).validate()


EGPU_4T = _preset("e-gpu-4t", 2)    # 2 threads/CU x 2 CUs = 4 parallel threads
EGPU_8T = _preset("e-gpu-8t", 4)
EGPU_16T = _preset("e-gpu-16t", 8)

#: X-HEEP host baseline: a single-issue scalar RISC-V CPU (paper §VI-B).
HOST = EGPUConfig(
    name="x-heep-host",
    compute_units=1,
    threads_per_cu=1,
    warps_per_cu=1,
    icache_bytes_per_cu=4 * KIB,
    icache_banks=1,
    icache_line_bytes=16,
    dcache_bytes=4 * KIB,
    dcache_banks=1,
    dcache_line_bytes=4,
)

PRESETS = {c.name: c for c in (EGPU_4T, EGPU_8T, EGPU_16T, HOST)}
