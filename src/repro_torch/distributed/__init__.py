"""repro_torch.distributed — sharding rules, activation constraints,
collectives.

The JAX package's ``repro.distributed`` on ``torch.distributed``: the
Tiny-OpenCL scheduler of the scaled-up system, as GSPMD is there.

* :mod:`.sharding` — logical-axis -> mesh-axis rules (DP/FSDP/TP/EP/SP),
  parameter PartitionSpecs with the divisibility fallback, and the DTensor
  placements they give (:func:`~.sharding.placements_for`), the models'
  ``constrain`` hook and :func:`~.sharding.on_blocks`, by which a kernel
  wrapper handed DTensors runs on each rank's blocks;
* :mod:`.compression` — int8 gradient compression with error feedback,
  around the DP reduction, on a mesh dim's process group;
* :mod:`.elastic` — cross-mesh resharding used by checkpoint restore when
  the device count changed.
"""

from .sharding import (ShardingRules, TRAIN_RULES, TRAIN_FSDP_RULES,
                       SERVE_RULES, activate, active_rules, constrain,
                       param_specs, batch_spec, spec_for, train_rules_for)
from .compression import compress_int8, decompress_int8, compressed_psum
from .elastic import reshard_arrays

__all__ = [
    "ShardingRules", "TRAIN_RULES", "TRAIN_FSDP_RULES", "SERVE_RULES",
    "activate", "active_rules", "constrain", "param_specs", "batch_spec",
    "spec_for", "train_rules_for",
    "compress_int8", "decompress_int8", "compressed_psum", "reshard_arrays",
]
