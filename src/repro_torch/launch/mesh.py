"""Meshes over the visible cards, axes ("data", "model").

The port's counterpart of ``src/repro/launch/mesh.py``: functions, so
that importing this module touches no device.  The port's dry-run needs
no mesh (it counts one process's step on ``meta`` tensors), so there
are no placeholder devices: a mesh takes real cards, and asking for
more than are visible raises.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(data: int, model: int = 1) -> Mesh:
    """A (data, model) mesh over the first data * model cards."""
    n = data * model
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"need {n} devices for mesh {(data, model)}, "
                           f"have {have}")
    return Mesh(("data", "model"), (data, model),
                tuple(torch.device("cuda", i) for i in range(n)))


def make_smoke_mesh() -> Mesh:
    """One card with the production axis names."""
    return make_production_mesh(1, 1)
