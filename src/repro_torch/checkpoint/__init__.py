"""Checkpoints of the port, in the reference's format both ways."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
