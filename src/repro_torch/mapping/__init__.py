"""Mapping strategies of the port: the four legacy pipelines."""
from repro_torch.mapping.columns import IdentityCols  # noqa: F401
from repro_torch.mapping.pipeline import (  # noqa: F401
    LEGACY_MODES,
    MappingPipeline,
    resolve_pipeline,
)
from repro_torch.mapping.rows import IdentityRows, MdmRows  # noqa: F401
