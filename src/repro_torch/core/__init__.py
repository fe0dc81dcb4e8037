"""repro_torch.core — the e-GPU paper's contribution, in PyTorch.

Public API:

* configs/knobs:  :class:`EGPUConfig`, presets ``EGPU_4T/8T/16T``, ``HOST``,
  DVFS :class:`OperatingPoint`\\ s (``OP_ANCHOR``, ``OPERATING_POINTS``,
  ``EGPUConfig.at``)
* execution model: :class:`NDRange`, :func:`schedule`, :func:`optimal_ndrange`
* runtime (Tiny-OpenCL subset): :class:`Context`, :class:`Device`,
  :class:`CommandQueue`, :class:`Kernel`, :class:`Buffer`, :class:`Event`,
  :class:`CommandGraph` (capture/replay dispatch)
* host API: :class:`Program` / :class:`KernelRegistry` /
  :func:`kernel_family` (see also the ``repro_torch.tinycl`` façade)
* models: :func:`egpu_time`, :func:`host_time` (machine), :func:`characterize`,
  energy helpers (power)
* APU: :class:`APU`, :class:`PipelineReport`
"""

from .apu import APU, PipelineReport, Stage, StageReport
from .device import (EGPU_4T, EGPU_8T, EGPU_16T, HOST, OP_ANCHOR,
                     OPERATING_POINTS, PRESETS, EGPUConfig, OperatingPoint,
                     env_op_point)
from .machine import (CAL, PhaseBreakdown, WorkCounts, egpu_time,
                      fuse_breakdowns, host_time, speedup, transfer_time)
from .ndrange import NDRange, crop_from_groups, pad_to_groups
from .power import (StaticCharacter, characterize, dynamic_scale,
                    egpu_active_power_mw, egpu_energy_j, egpu_idle_power_mw,
                    energy_reduction, host_active_power_mw, host_energy_j,
                    leakage_scale)
from .program import (BUILTIN_FAMILIES, REGISTRY, KernelRegistry, Program,
                      kernel_family)
from .runtime import (ArgInfo, Buffer, CommandGraph, CommandQueue, Context,
                      Device, Event, GraphBuffer, Kernel, resolve_device)
from .scheduler import Schedule, optimal_ndrange, schedule

__all__ = [
    "APU", "PipelineReport", "Stage", "StageReport",
    "EGPU_4T", "EGPU_8T", "EGPU_16T", "HOST", "OP_ANCHOR", "OPERATING_POINTS",
    "PRESETS", "EGPUConfig", "OperatingPoint", "env_op_point",
    "CAL", "PhaseBreakdown", "WorkCounts", "egpu_time", "fuse_breakdowns",
    "host_time", "speedup", "transfer_time",
    "NDRange", "crop_from_groups", "pad_to_groups",
    "StaticCharacter", "characterize", "dynamic_scale", "egpu_active_power_mw",
    "egpu_energy_j", "egpu_idle_power_mw", "energy_reduction",
    "host_active_power_mw", "host_energy_j", "leakage_scale",
    "BUILTIN_FAMILIES", "REGISTRY", "KernelRegistry", "Program",
    "kernel_family",
    "ArgInfo", "Buffer", "CommandGraph", "CommandQueue", "Context", "Device",
    "Event", "GraphBuffer", "Kernel", "resolve_device",
    "Schedule", "optimal_ndrange", "schedule",
]
