"""Logical-axis sharding rules with divisibility fallback, and the mesh.

Port of ``repro.distributed.sharding``.  Every tensor dim carries a
*logical* name ("embed", "heads", "tiles", ...).  A rule set maps each
name to an ordered list of mesh-axis candidates; the first candidate
whose axes (a) exist in the mesh, (b) are not already used by another
dim of the same tensor and (c) evenly divide the dim size wins.

:class:`Mesh` is the port's counterpart of a ``jax.sharding.Mesh``:
named axes with their sizes over devices laid out row-major.  Under
``torch.distributed`` the global mesh spans every process: process p
holds the contiguous block ``[p * n, (p + 1) * n)`` of its devices, and
the mesh keeps only this process's ``n`` of them.

:func:`logical_spec` returns a tuple in place of a ``PartitionSpec``:
one entry a dim, ``None`` (replicated), an axis name or a tuple of axis
names, trailing ``None``s trimmed.  The reference's ``shard`` and
``named_sharding`` (constraints on model activations and weights) come
with training.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

# name -> ordered candidates; each candidate is a tuple of mesh axes
# (meaning "shard this dim over the product of these axes").
Rules = dict[str, list[tuple[str, ...]]]

_DEFAULT: Rules = {
    # crossbar solver: the embarrassingly-parallel tile batch axis
    # (repro_torch.distributed.solver_shard); a dedicated "tiles" mesh
    # wins, else the data-parallel axes of a training mesh.
    "tiles":     [("tiles",), ("pod", "data"), ("data",)],
    # activations
    "batch":     [("pod", "data"), ("data",)],
    "seq":       [],                      # replicated (no sequence parallel)
    "act_embed": [],
    "act_mlp":   [("model",)],
    "act_heads": [("model",)],
    "act_kv":    [("model",)],
    "act_head_dim": [("model",)],         # fallback after act_heads/act_kv
    "act_seq_q": [("model",)],            # query-parallel attention
    "act_vocab": [("model",)],
    # weights: "embed" is the FSDP dim, feature dims take the TP axis
    "embed":     [("data",)],
    "mlp":       [("model",)],
    "heads":     [("model",)],
    "kv_heads":  [("model",)],
    "head_dim":  [("model",)],
    "vocab":     [("model",)],
    "experts":   [],                      # E rarely divides an axis; TP inside
    "inner":     [("model",)],
    "state":     [],
    "conv":      [],
    "layers":    [],
    # caches
    "cache_batch": [("pod", "data"), ("data",)],
    "cache_seq":   [],
    "cache_kv":    [("model",)],
    "cache_head_dim": [("model",)],
}

# FSDP extended over the pod axis (params sharded across pods too).
_FSDP_PODS: Rules = dict(_DEFAULT, embed=[("pod", "data"), ("data",)])

# Sequence-parallel activations: seq over "model" between blocks.
_SEQPAR: Rules = dict(_DEFAULT, seq=[("model",)])

# Expert-parallel MoE: the expert dim over the model axis where E
# divides it (else TP inside each expert, as the default).
_EXPERT: Rules = dict(_DEFAULT, experts=[("model",)])

RULE_SETS: dict[str, Rules] = {
    "default": _DEFAULT,
    "fsdp_pods": _FSDP_PODS,
    "seqpar": _SEQPAR,
    "expert": _EXPERT,
}


@dataclass(frozen=True)
class Mesh:
    """Named axes (row-major) over devices.

    ``devices`` are this process's: all ``prod(axis_sizes)`` of them in
    one process, else the block ``process_index`` of ``process_count``
    equal blocks.  Construction resolves every device and raises where
    one is missing (a CUDA device with no card, or an index past the
    visible count): nothing falls back to the CPU."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} vs sizes {sizes}")
        devs = tuple(resolve_device(d) for d in self.devices)
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= \
                    torch.cuda.device_count():
                raise RuntimeError(f"mesh device {d}: only "
                                   f"{torch.cuda.device_count()} visible")
        if math.prod(sizes) != self.process_count * len(devs):
            raise ValueError(f"a mesh of {math.prod(sizes)} devices over "
                             f"{self.process_count} process(es) of "
                             f"{len(devs)}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax`` ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def owner(self, flat: int) -> tuple[int, torch.device | None]:
        """(process, device) of global row-major device ``flat``; the
        device is None where another process owns it."""
        n = len(self.devices)
        p = flat // n
        return p, (self.devices[flat % n] if p == self.process_index
                   else None)


@dataclass(frozen=True)
class ShardingCtx:
    """Mesh + rule set; ``mesh=None`` is the single-device no-op."""

    mesh: Mesh | None = None
    rules_name: str = "default"

    @property
    def rules(self) -> Rules:
        return RULE_SETS[self.rules_name]


def logical_spec(shape: tuple[int, ...], dims: tuple[str | None, ...],
                 mesh: Mesh | None, rules: Rules) -> tuple:
    """Resolve logical dim names to a partition spec (a tuple: one entry
    a dim, ``None``, an axis name or a tuple of names; trailing ``None``s
    trimmed).  ``mesh`` is anything with a ``shape`` mapping of axis
    sizes."""
    if mesh is None:
        return ()
    if len(shape) != len(dims):
        raise ValueError(f"shape {shape} vs dims {dims}")
    axis_sizes = dict(mesh.shape)
    used: set[str] = set()
    out: list = []
    for size, name in zip(shape, dims):
        picked = None
        for cand in (rules.get(name, []) if name else []):
            if not all(a in axis_sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            if size % math.prod(axis_sizes[a] for a in cand) == 0:
                picked = cand
                used.update(cand)
                break
        out.append(picked if picked is None else
                   (picked[0] if len(picked) == 1 else picked))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)
