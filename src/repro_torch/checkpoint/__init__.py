"""Checkpoints of the port: the read side of the reference's format."""
from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint  # noqa: F401
