"""Strategy registry and pass contract for the mapping pipeline.

Port of ``repro.mapping.base``.  A *strategy* is one composable pass of
a :class:`repro_torch.mapping.pipeline.MappingPipeline`, a frozen
dataclass registered under a ``(kind, name)`` pair:

``rows``
    Row-order passes.  ``order(counts, scores, n_cols, stuck, col_sig,
    spec)`` maps the per-row keys of a (T, rows) tile population (active
    counts and Manhattan scores in the placed column layout, as the
    ``manhattan_score`` kernel computes them) to a (T, rows)
    permutation — ``perm[t, p]`` is the logical row hosted at physical
    row ``p`` — or None for the identity.  ``stuck`` is the physical
    (T, rows, cols) int8 cell-state batch (or None), ``col_sig`` the
    per-tile physical-column bit significance (or None).
``cols``
    Column-order passes.  ``order_tiles(placed, stuck, col_sig, spec)``
    maps the dataflow-oriented (T, rows, cols) masks to a (T, cols)
    permutation (``perm[t, p]`` = dataflow-layout column hosted at
    bitline ``p``) or None; ``col_sig`` is the pre-permutation
    significance of each dataflow-layout column.
``partition``
    Tensor partitioning; the port has the dense one only.

A pass declares what it consumes with ``uses_faults`` /
``uses_col_significance``; the planner threads nothing else.  Every
strategy is pure, hashable and fingerprinted: :meth:`Strategy.fingerprint`
is the registry name plus the ``repr`` of each dataclass field, the
reference's string exactly, so cache keys agree between the packages.
"""
from __future__ import annotations

import dataclasses

KINDS = ("rows", "cols", "partition")

_REGISTRY: dict[str, dict[str, type]] = {k: {} for k in KINDS}


class Strategy:
    """Mixin for registered mapping passes (frozen dataclasses)."""

    kind: str = ""
    name: str = ""
    uses_faults: bool = False
    uses_col_significance: bool = False

    def fingerprint(self) -> str:
        """Registry name + params, e.g. ``"spare_line(open_penalty=4.0)"``."""
        fields = dataclasses.fields(self)
        if not fields:
            return self.name
        params = ",".join(f"{f.name}={getattr(self, f.name)!r}"
                          for f in fields)
        return f"{self.name}({params})"


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} not in {KINDS}")


def register(kind: str, name: str, override: bool = False):
    """Class decorator: register a strategy under ``(kind, name)``.
    Duplicate names raise unless ``override=True`` (a silently replaced
    strategy would keep its predecessor's cache token)."""
    _check_kind(kind)

    def deco(cls):
        if not override and name in _REGISTRY[kind]:
            raise ValueError(
                f"{kind} strategy {name!r} is already registered "
                f"({_REGISTRY[kind][name].__name__}); pass "
                "override=True to replace it")
        cls.kind, cls.name = kind, name
        _REGISTRY[kind][name] = cls
        return cls

    return deco


def unregister(kind: str, name: str) -> None:
    """Remove a registered strategy (a test hook)."""
    _check_kind(kind)
    _REGISTRY[kind].pop(name, None)


def available(kind: str) -> tuple[str, ...]:
    """Registered strategy names of one kind, sorted."""
    _check_kind(kind)
    return tuple(sorted(_REGISTRY[kind]))


def get_strategy(kind: str, name: str, **params):
    """Instantiate a registered strategy by name."""
    _check_kind(kind)
    try:
        cls = _REGISTRY[kind][name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} strategy {name!r}; "
            f"available: {available(kind)}") from None
    return cls(**params)
