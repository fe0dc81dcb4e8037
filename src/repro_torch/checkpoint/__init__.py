"""repro_torch.checkpoint — async, rotating checkpoints in the JAX
package's on-disk format."""

from .store import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]
