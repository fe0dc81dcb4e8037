"""repro_torch.checkpoint — async, rotating checkpoints in the JAX
package's on-disk format, elastically restorable under a device mesh."""

from .store import (CheckpointManager, load_checkpoint, restore_sharded,
                    save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "restore_sharded"]
