"""Tiny-OpenCL scheduling model (paper §V-B, §VIII-B).

The paper's runtime executes a kernel in three phases:

1. **startup**  — each CU in single-thread mode: activate threads/warps, set
   up per-thread stacks;
2. **scheduling** — read global/local sizes from the kernel-args region,
   combine with CSR-reported hardware resources, and iterate work-items onto
   (CU × warp × thread) slots;
3. **processing** — the user kernel runs.

§VIII-B reports scheduling time is ~25 µs and *constant* when the number of
work-items equals the number of hardware threads, growing with the number of
scheduling iterations (= ceil(work_items / total_threads)); startup is part of
the same fixed cost.  We model exactly that and calibrate the constants to the
paper's 300 MHz numbers.

This model reproduces Fig. 3's overhead split, and `core/runtime.py`
attaches it to every launched kernel's Event.
"""

from __future__ import annotations

import dataclasses
import math

from .device import EGPUConfig
from .ndrange import NDRange

# Calibration (cycles @ 300 MHz).  25 us = 7500 cycles for one scheduling
# iteration (paper: work-items == total threads -> constant ~25 us).
STARTUP_CYCLES_BASE = 2200       # single-thread init: stacks, warp activation
STARTUP_CYCLES_PER_WARP = 120    # per (warp x CU) resource activation
SCHED_CYCLES_BASE = 2540         # read kernel args region + CSRs, set-up loop
SCHED_CYCLES_PER_ITER = 1800     # one pass distributing items over all slots


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static schedule of an NDRange onto an e-GPU configuration."""

    ndrange: NDRange
    config: EGPUConfig
    # derived
    iterations: int            # scheduling passes over the thread slots
    groups_per_cu: int         # work-groups each CU executes (ceil)
    occupancy: float           # fraction of thread slots doing real work

    @property
    def startup_cycles(self) -> int:
        c = self.config
        return STARTUP_CYCLES_BASE + STARTUP_CYCLES_PER_WARP * c.warps_per_cu * c.compute_units

    @property
    def scheduling_cycles(self) -> int:
        return SCHED_CYCLES_BASE + SCHED_CYCLES_PER_ITER * self.iterations

    @property
    def overhead_cycles(self) -> int:
        return self.startup_cycles + self.scheduling_cycles

    @property
    def overhead_s(self) -> float:
        return self.overhead_cycles * self.config.cycle_s


def schedule(ndr: NDRange, config: EGPUConfig) -> Schedule:
    """Distribute ``ndr``'s work-items over ``config``'s thread slots.

    Mirrors the paper's scheduler: work-groups go to CUs round-robin; within a
    CU, work-items pack onto (warp x thread) slots; leftover slots are
    deactivated (for power). ``iterations`` counts how many times the
    scheduling loop must refill the slots.
    """
    total_items = ndr.total_work_items
    slots = config.total_threads
    iterations = max(1, math.ceil(total_items / slots))
    groups_per_cu = max(1, math.ceil(ndr.total_groups / config.compute_units))
    # Occupancy of the last iteration's slots; earlier iterations are full.
    tail = total_items - (iterations - 1) * slots
    occupancy = (min(total_items, slots) if iterations == 1 else
                 (slots * (iterations - 1) + tail) / iterations) / slots
    return Schedule(ndrange=ndr, config=config, iterations=iterations,
                    groups_per_cu=groups_per_cu, occupancy=min(1.0, occupancy))


def optimal_ndrange(total_items_hint: int, config: EGPUConfig) -> NDRange:
    """The paper's §VIII-B trick: pick work-items == hardware threads so the
    scheduling cost is a single constant iteration; each work-item then loops
    over ``ceil(total/slots)`` elements internally."""
    slots = config.total_threads
    return NDRange(global_size=(slots,), local_size=(config.threads_per_cu,))
