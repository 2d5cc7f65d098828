"""Mapping strategies of the port: the reference's registry of row and
column passes composed into named pipelines (``repro.mapping``)."""
from repro_torch.mapping.base import (  # noqa: F401
    KINDS,
    Strategy,
    available,
    get_strategy,
    register,
    unregister,
)
from repro_torch.mapping.columns import (  # noqa: F401
    IdentityCols,
    SpareLineCols,
    XChangrCols,
)
from repro_torch.mapping.partition import (  # noqa: F401
    DensePartition,
    ExpertPartition,
)
from repro_torch.mapping.pipeline import (  # noqa: F401
    LEGACY_MODES,
    MappingPipeline,
    named_pipelines,
    resolve_pipeline,
)
from repro_torch.mapping.rows import (  # noqa: F401
    FaultAwareRows,
    IdentityRows,
    MdmRows,
    SignificanceWeightedRows,
    SpareLineRows,
)
