"""MappingPipeline: composed, fingerprinted weight-mapping strategy.

Port of ``repro.mapping.pipeline``.  A pipeline is (dataflow
orientation, row order, column order, tile partition); the passes
compose in a fixed order (orientation, columns, rows).  The legacy
``mode`` strings ``baseline | reverse | sort | mdm`` resolve to the
canonical pipelines, and :meth:`MappingPipeline.cache_token` returns
the historical mode string for exactly those combinations (with
``fault_aware`` rows sharing MDM's, the fault map entering the key
separately) and ``"pipe:df=...;row=...;col=..."`` from the pass
fingerprints for every other one — the reference's tokens, so the two
packages address the same plan-cache entries.  The named pipelines are
the reference's; ``mdm_expert`` deploys MoE expert banks one expert a
matrix (its token is MDM's: the partition never enters a plan key).
"""
from __future__ import annotations

import dataclasses

from repro_torch.mapping.base import Strategy, available, get_strategy
from repro_torch.mapping.columns import IdentityCols, SpareLineCols, XChangrCols
from repro_torch.mapping.partition import DensePartition, ExpertPartition
from repro_torch.mapping.rows import (
    FaultAwareRows,
    IdentityRows,
    MdmRows,
    SignificanceWeightedRows,
    SpareLineRows,
)

DATAFLOWS = ("conventional", "reversed")
LEGACY_MODES = ("baseline", "reverse", "sort", "mdm")


@dataclasses.dataclass(frozen=True)
class MappingPipeline:
    """Composable mapping strategy (dataflow, rows, cols, partition)."""

    dataflow: str = "reversed"
    rows: Strategy = MdmRows()
    cols: Strategy = IdentityCols()
    partition: Strategy = DensePartition()

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(
                f"dataflow={self.dataflow!r} not in {DATAFLOWS}")

    @property
    def reversed_dataflow(self) -> bool:
        return self.dataflow == "reversed"

    def fingerprint(self) -> str:
        """Full stable identity of the pipeline (includes partition)."""
        return (f"df={self.dataflow};row={self.rows.fingerprint()};"
                f"col={self.cols.fingerprint()};"
                f"part={self.partition.fingerprint()}")

    def cache_token(self) -> str:
        """The string that enters per-matrix plan-cache keys (exact
        equality with the canonical strategies, as the reference's: a
        parametrised variant falls through to its fingerprint)."""
        if self.cols == IdentityCols():
            if self.rows == IdentityRows():
                return "reverse" if self.reversed_dataflow else "baseline"
            if self.rows == MdmRows() or self.rows == FaultAwareRows():
                return "mdm" if self.reversed_dataflow else "sort"
        return (f"pipe:df={self.dataflow};row={self.rows.fingerprint()};"
                f"col={self.cols.fingerprint()}")

    def spec(self) -> str:
        """Config-friendly spec string; inverse of :meth:`from_spec`."""
        return (f"df={self.dataflow},row={self.rows.name},"
                f"col={self.cols.name},part={self.partition.name}")

    @staticmethod
    def from_spec(spec: str) -> "MappingPipeline":
        """Parse ``"df=reversed,row=mdm,col=xchangr,part=dense"``; every
        field defaults to the MDM pipeline's, unknown keys or names
        raise."""
        kw: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"bad pipeline spec item {item!r} "
                                 f"in {spec!r} (want key=value)")
            k, v = (s.strip() for s in item.split("=", 1))
            if k == "df":
                kw["dataflow"] = v
            elif k in ("row", "rows"):
                kw["rows"] = get_strategy("rows", v)
            elif k in ("col", "cols"):
                kw["cols"] = get_strategy("cols", v)
            elif k in ("part", "partition"):
                kw["partition"] = get_strategy("partition", v)
            else:
                raise ValueError(f"unknown pipeline spec key {k!r} "
                                 f"in {spec!r}")
        return MappingPipeline(**kw)

    def replace(self, **kw) -> "MappingPipeline":
        return dataclasses.replace(self, **kw)


_NAMED = {
    "baseline": MappingPipeline(dataflow="conventional", rows=IdentityRows()),
    "reverse": MappingPipeline(rows=IdentityRows()),
    "sort": MappingPipeline(dataflow="conventional"),
    "mdm": MappingPipeline(),
    "fault_aware": MappingPipeline(rows=FaultAwareRows()),
    "significance_weighted": MappingPipeline(
        rows=SignificanceWeightedRows()),
    "xchangr": MappingPipeline(cols=XChangrCols()),
    "xchangr_fault_aware": MappingPipeline(rows=FaultAwareRows(),
                                           cols=XChangrCols()),
    "spare_line": MappingPipeline(rows=SpareLineRows(),
                                  cols=SpareLineCols()),
    "mdm_expert": MappingPipeline(partition=ExpertPartition()),
}


def register_pipeline(name: str, pipe: MappingPipeline,
                      override: bool = False) -> MappingPipeline:
    """Register a named pipeline; a duplicate name raises unless
    ``override=True`` (silent replacement would change what a config's
    ``mode`` means)."""
    if not override and name in _NAMED:
        raise ValueError(f"pipeline {name!r} is already registered "
                         f"({_NAMED[name].fingerprint()}); pass "
                         "override=True to replace it")
    _NAMED[name] = pipe
    return pipe


def named_pipelines() -> dict[str, MappingPipeline]:
    return dict(_NAMED)


def resolve_pipeline(mode, have_faults: bool = False) -> MappingPipeline:
    """A pipeline, a named pipeline or spec string, or a legacy mode.

    ``have_faults`` is the legacy side channel: the sorting modes
    ``"sort"`` / ``"mdm"`` resolve to fault-aware rows when fault maps
    are given (an explicit :class:`MappingPipeline` is never upgraded).
    """
    if isinstance(mode, MappingPipeline):
        return mode
    if not isinstance(mode, str):
        raise TypeError(f"expected MappingPipeline or str, got "
                        f"{type(mode).__name__}")
    if have_faults and mode in ("sort", "mdm"):
        return _NAMED[mode].replace(rows=FaultAwareRows())
    if mode in _NAMED:
        return _NAMED[mode]
    if "=" in mode:
        return MappingPipeline.from_spec(mode)
    raise ValueError(
        f"unknown mapping pipeline {mode!r}; named pipelines: "
        f"{tuple(sorted(_NAMED))}, row strategies: {available('rows')}, "
        "or a 'df=...,row=...,col=...,part=...' spec string")
