"""Architecture registry of the port: the archs it serves, by the
reference's ids (``repro.configs.ARCHS``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    CimConfig,
    ModelConfig,
    check_supported,
)

# arch id -> module name; the reference's other six archs (mamba and
# hybrid blocks, frontends) are still to be ported.
ARCHS: dict[str, str] = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "xlstm-1.3b": "xlstm_13b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
