"""Atomic npz checkpoints with a JSON manifest (see ``checkpoint``)."""

from repro_torch.ckpt.checkpoint import CheckpointManager, config_hash

__all__ = ["CheckpointManager", "config_hash"]
