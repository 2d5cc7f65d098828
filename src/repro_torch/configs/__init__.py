"""Architecture registry of the port: the reference's ten archs
(``repro.configs.ARCHS``), by its ids."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    CimConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    check_supported,
)

# arch id -> module name.
ARCHS: dict[str, str] = {
    "internvl2-76b": "internvl2_76b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen25_32b",
    "hymba-1.5b": "hymba_15b",
    "musicgen-medium": "musicgen_medium",
    "xlstm-1.3b": "xlstm_13b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def arch_shape_cells() -> list[tuple[str, str]]:
    """The (arch x shape) cells of the dry-run, in the reference's order:
    long_500k only for an arch that supports long context."""
    return [(arch, shape) for arch in ARCHS for shape in SHAPES
            if shape != "long_500k"
            or get_config(arch).supports_long_context]
