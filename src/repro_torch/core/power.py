"""Area / leakage / energy model, calibrated to the paper's TSMC16 data.

The paper characterizes post-synthesis netlists at 300 MHz / 0.8 V in TSMC
16 nm SVT (Figs 2 & 4).  We reproduce that characterization with a
component-level analytic model whose free constants are fitted to the
published endpoints and whose *structure* follows the paper's observations:

* I$ area is constant across configs (not scaled with threads) — §VIII-A;
* D$ area grows slightly with banking (sub-banking is less area-efficient);
* CU area/leakage nearly doubles per 2x thread step (more ALUs, larger
  register files, wider control) — §VIII-A;
* leakage tracks area with SRAM leaking less per mm² than logic;
* dynamic power scales with active lanes; the power controller clock-gates
  finished CUs (SLEEP_REQ, §IV-A/C), so idle CUs contribute leakage only.

Published anchors (paper abstract + §VIII-A):
  host:   0.15 mm²,  29.50 uW leakage,  ~5.5 mW active
  systems (host + e-GPU): 0.24..0.38 mm² (1.6x..2.5x), 130.13..305.32 uW
  (4.4x..10.3x), <= 28 mW total power for the 16T config.

DVFS: every fitted constant above describes silicon at the
:data:`~repro_torch.core.device.OP_ANCHOR` point (300 MHz / 0.8 V).  A config
rebased onto another :class:`~repro_torch.core.device.OperatingPoint` via
``config.at(point)`` scales

* **dynamic power** by ``(f / f0) * (V / V0)**2`` — the CV²f law
  (:func:`dynamic_scale`);
* **leakage** by ``(V / V0)**LEAK_VOLTAGE_EXP`` — a power-law fit to the
  super-linear leakage-vs-supply behavior (DIBL + gate leakage) of
  short-channel SVT devices (:func:`leakage_scale`);
* **area** not at all — :func:`characterize` geometry is voltage-invariant,
  only its leakage columns move.

Both scale factors are *exactly* 1.0 at the anchor, so anchor-point numbers
stay bit-identical to the pre-DVFS model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from .device import EGPUConfig, HOST, KIB, OP_ANCHOR
from .machine import PhaseBreakdown

# --- fitted component constants (mm², uW, mW) ------------------------------
HOST_AREA_MM2 = 0.15
HOST_LEAK_UW = 29.50
HOST_ACTIVE_MW = 5.5          # scalar core + SRAM active power at 300 MHz

CU_AREA_BASE_MM2 = 0.0020     # per-CU control/front-end, thread-independent
CU_AREA_PER_THREAD_MM2 = 0.0110  # ALUs + register-file slice per PE
ICACHE_AREA_PER_KIB_MM2 = 0.0030
DCACHE_AREA_PER_KIB_MM2 = 0.0019
DCACHE_BANK_SPLIT_MM2 = 0.0011   # periphery duplicated per extra bank

LOGIC_LEAK_UW_PER_MM2 = 1296.0   # SVT logic leakage density (fitted)
SRAM_LEAK_UW_PER_MM2 = 884.0     # SRAM macros leak less per area (fitted)

EGPU_DYN_MW_PER_LANE = 1.27      # active power per busy processing element
EGPU_DYN_BASE_MW = 5.6           # caches + controller + interconnect + clocks
HOST_IDLE_MW = 0.9               # host waiting on e-GPU interrupt (§VI-A)

#: leakage-vs-supply exponent: leakage ~ (V/V0)**3 captures the combined
#: sub-threshold (DIBL) + gate-leakage super-linearity of 16 nm SVT over the
#: 0.6..0.95 V corridor; exactly 1.0 at the 0.8 V anchor.
LEAK_VOLTAGE_EXP = 3.0


def dynamic_scale(config: EGPUConfig) -> float:
    """CV²f scaling of every dynamic-power constant vs the anchor point.

    ``(f/f0) * (V/V0)**2`` — exactly 1.0 for a config at
    :data:`~repro_torch.core.device.OP_ANCHOR` (the fitted constants' native
    point), monotone increasing in both frequency and voltage.
    """
    return ((config.freq_hz / OP_ANCHOR.freq_hz)
            * (config.voltage_v / OP_ANCHOR.voltage_v) ** 2)


def leakage_scale(config: EGPUConfig) -> float:
    """Leakage scaling vs the anchor supply: ``(V/V0)**LEAK_VOLTAGE_EXP``.

    Frequency-independent (leakage burns whether or not the clock runs),
    monotone increasing in voltage, exactly 1.0 at 0.8 V.
    """
    return (config.voltage_v / OP_ANCHOR.voltage_v) ** LEAK_VOLTAGE_EXP


@dataclasses.dataclass(frozen=True)
class StaticCharacter:
    """Fig 2: per-component area and leakage of one system instance."""

    name: str
    host_area_mm2: float
    icache_area_mm2: float
    dcache_area_mm2: float
    cu_area_mm2: float
    host_leak_uw: float
    icache_leak_uw: float
    dcache_leak_uw: float
    cu_leak_uw: float

    @property
    def total_area_mm2(self) -> float:
        return (self.host_area_mm2 + self.icache_area_mm2 +
                self.dcache_area_mm2 + self.cu_area_mm2)

    @property
    def total_leak_uw(self) -> float:
        return (self.host_leak_uw + self.icache_leak_uw +
                self.dcache_leak_uw + self.cu_leak_uw)

    @property
    def area_overhead(self) -> float:
        return self.total_area_mm2 / self.host_area_mm2

    @property
    def leak_overhead(self) -> float:
        return self.total_leak_uw / self.host_leak_uw

    def as_dict(self) -> Dict[str, float]:
        return {
            "area_mm2": self.total_area_mm2,
            "leak_uw": self.total_leak_uw,
            "area_overhead_x": self.area_overhead,
            "leak_overhead_x": self.leak_overhead,
        }


@functools.lru_cache(maxsize=512)
def characterize(config: EGPUConfig) -> StaticCharacter:
    """Area/leakage of an APU built from the host plus this e-GPU config.

    Geometry is operating-point-invariant; leakage columns scale with the
    config's supply voltage (:func:`leakage_scale` — a factor of exactly
    1.0 at the 0.8 V anchor, so anchor numbers are bit-identical).  Memoized:
    configs are frozen, and the serve path re-derives power per launch.
    """
    ls = leakage_scale(config)
    if config.name == HOST.name:
        return StaticCharacter(config.name, HOST_AREA_MM2, 0, 0, 0,
                               HOST_LEAK_UW * ls, 0, 0, 0)
    icache_kib = config.icache_bytes_per_cu * config.compute_units / KIB
    icache = ICACHE_AREA_PER_KIB_MM2 * icache_kib
    dcache = (DCACHE_AREA_PER_KIB_MM2 * config.dcache_bytes / KIB
              + DCACHE_BANK_SPLIT_MM2 * max(0, config.dcache_banks - 1))
    cus = config.compute_units * (
        CU_AREA_BASE_MM2 + CU_AREA_PER_THREAD_MM2 * config.threads_per_cu)
    return StaticCharacter(
        name=config.name,
        host_area_mm2=HOST_AREA_MM2,
        icache_area_mm2=icache,
        dcache_area_mm2=dcache,
        cu_area_mm2=cus,
        host_leak_uw=HOST_LEAK_UW * ls,
        icache_leak_uw=icache * SRAM_LEAK_UW_PER_MM2 * ls,
        dcache_leak_uw=dcache * SRAM_LEAK_UW_PER_MM2 * ls,
        cu_leak_uw=cus * LOGIC_LEAK_UW_PER_MM2 * ls,
    )


def egpu_active_power_mw(config: EGPUConfig) -> float:
    """Total APU power while the e-GPU runs a kernel (host idles on IRQ).

    Dynamic terms scale with the config's operating point (CV²f,
    :func:`dynamic_scale`); leakage arrives voltage-scaled from
    :func:`characterize`.
    """
    lanes = config.parallel_lanes
    return (dynamic_scale(config)
            * (HOST_IDLE_MW + EGPU_DYN_BASE_MW + EGPU_DYN_MW_PER_LANE * lanes)
            + characterize(config).total_leak_uw / 1000.0)


def egpu_idle_power_mw(config: EGPUConfig) -> float:
    """Power of a *quiescent* APU lane: every CU clock-gated via SLEEP_REQ
    (§IV-A/C) and the host asleep between requests, so only leakage burns.
    The serving layer integrates this over idle lane-time so fleet energy
    accounting is honest."""
    return characterize(config).total_leak_uw / 1000.0


def host_active_power_mw() -> float:
    return HOST_ACTIVE_MW + HOST_LEAK_UW / 1000.0


def egpu_energy_j(config: EGPUConfig, t: PhaseBreakdown) -> float:
    """Energy of an offloaded kernel.  During startup/scheduling/transfer the
    CUs are mostly idle (clock-gated via SLEEP_REQ's converse — they have not
    started), so those phases burn base+leakage only.  Wall time enters via
    ``t.freq_hz`` (the breakdown's own clock) and power via the config's
    operating point, so the DVFS energy trade is modeled end to end: lower
    V² beats the longer runtime for dynamic energy, while leakage energy
    *grows* as the clock slows."""
    p_active = egpu_active_power_mw(config) * 1e-3
    p_idle = (dynamic_scale(config) * (HOST_IDLE_MW + EGPU_DYN_BASE_MW)
              + characterize(config).total_leak_uw / 1000.0) * 1e-3
    t_active = t.compute / t.freq_hz
    t_idle = (t.startup + t.scheduling + t.transfer) / t.freq_hz
    return p_active * t_active + p_idle * t_idle


def host_energy_j(t: PhaseBreakdown) -> float:
    return host_active_power_mw() * 1e-3 * t.total_s


def energy_reduction(host_t: PhaseBreakdown, config: EGPUConfig,
                     egpu_t: PhaseBreakdown) -> float:
    return host_energy_j(host_t) / egpu_energy_j(config, egpu_t)
