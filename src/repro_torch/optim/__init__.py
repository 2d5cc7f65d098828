"""Optimizer of the port: AdamW with f32 masters and its schedule."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
