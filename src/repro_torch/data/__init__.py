"""Data of the port: the deterministic token streams."""
from repro_torch.data.pipeline import (  # noqa: F401
    MemmapTokenDataset,
    SyntheticTokenDataset,
    make_dataset,
)
