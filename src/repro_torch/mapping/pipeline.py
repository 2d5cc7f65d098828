"""MappingPipeline: dataflow orientation + row order + column order.

Port of ``repro.mapping.pipeline`` restricted to the four legacy
pipelines ``baseline | reverse | sort | mdm`` (identity columns,
identity or MDM rows, forward or reversed dataflow).  Any other
strategy raises ``NotImplementedError`` rather than planning something
else.
"""
from __future__ import annotations

import dataclasses

from repro_torch.mapping.columns import IdentityCols
from repro_torch.mapping.rows import IdentityRows, MdmRows

DATAFLOWS = ("conventional", "reversed")
LEGACY_MODES = ("baseline", "reverse", "sort", "mdm")


@dataclasses.dataclass(frozen=True)
class MappingPipeline:
    """Composable mapping strategy (dataflow, rows, cols)."""

    dataflow: str = "reversed"
    rows: IdentityRows | MdmRows = MdmRows()
    cols: IdentityCols = IdentityCols()

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(
                f"dataflow={self.dataflow!r} not in {DATAFLOWS}")

    @property
    def reversed_dataflow(self) -> bool:
        return self.dataflow == "reversed"

    def cache_token(self) -> str:
        """The string that enters per-matrix plan-cache keys: the
        historical mode string of each legacy pipeline, as the
        reference's ``MappingPipeline.cache_token`` returns for them,
        so both packages address the same cache entries."""
        if self.rows == IdentityRows():
            return "reverse" if self.reversed_dataflow else "baseline"
        return "mdm" if self.reversed_dataflow else "sort"


_NAMED = {
    "baseline": MappingPipeline(dataflow="conventional", rows=IdentityRows()),
    "reverse": MappingPipeline(rows=IdentityRows()),
    "sort": MappingPipeline(dataflow="conventional"),
    "mdm": MappingPipeline(),
}


def resolve_pipeline(mode) -> MappingPipeline:
    """A pipeline, or one of the four legacy mode strings."""
    if isinstance(mode, MappingPipeline):
        return mode
    if not isinstance(mode, str):
        raise TypeError(f"expected MappingPipeline or str, got "
                        f"{type(mode).__name__}")
    if mode in _NAMED:
        return _NAMED[mode]
    raise NotImplementedError(
        f"mapping pipeline {mode!r} is not ported yet; the port plans "
        f"the legacy pipelines {LEGACY_MODES}")
