from repro_torch.configs.base import (  # noqa: F401
    CimConfig,
    ModelConfig,
    check_supported,
)
