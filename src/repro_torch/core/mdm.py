"""Manhattan Distance Mapping (MDM) — the paper's core algorithm.

Port of ``repro.core.mdm`` for the legacy pipelines: dataflow
orientation (paper step 1) and the per-row Manhattan sort (steps 2-3)
over a population of crossbar tiles.  The plan is pure bookkeeping —
per-tile row permutations plus the dataflow direction — so inverting it
at the input mux reproduces the original matmul exactly.

Every reduction the planner needs (row counts and scores in the placed
column layout, NF before and after) comes from the ``manhattan_score``
op: the hand-written kernel on CUDA tensors, its plain version on CPU
tensors.  All of them are exact integers in f32, so the plans are
bit-identical either way and bit-identical to the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitslice import bitslice
from repro_torch.core.manhattan import inverse_permutation
from repro_torch.core.tiling import CrossbarSpec, reverse_dataflow, tile_masks
from repro_torch.kernels.manhattan_score.ops import manhattan_score
from repro_torch.mapping import MappingPipeline, resolve_pipeline

MODES = ("baseline", "reverse", "sort", "mdm")


class MdmPlan(NamedTuple):
    """Deployment plan for one weight matrix.

    row_perm:     (Ti, Tn, rows) int32 — physical row p of tile (ti, tn)
                  hosts tile-local weight row ``row_perm[ti, tn, p]``.
    row_position: (Ti, Tn, rows) int32 — the inverse permutation.
    reversed_dataflow: bool.
    nf_before / nf_after: (Ti, Tn) f32 per-tile NF (Manhattan model).
    scale: f32 () quantisation scale of the bit-sliced weights.
    """

    row_perm: torch.Tensor
    row_position: torch.Tensor
    reversed_dataflow: bool
    nf_before: torch.Tensor
    nf_after: torch.Tensor
    scale: torch.Tensor


def plan_tile_population(masks: torch.Tensor, spec: CrossbarSpec,
                         mode: str | MappingPipeline = "mdm"):
    """Plan a flat tile population (T, rows, cols) uint8.

    Returns (row_perm, row_position, nf_before, nf_after): (T, rows)
    int32 twice and (T,) f32 twice.  ``manhattan_score`` passes: NF
    before on the raw masks; the sort keys in the placed column layout
    (the same pass when the dataflow is conventional); NF after with the
    planned row positions (skipped where the placement is the raw
    layout, whose NF is NF before).
    """
    pipe = resolve_pipeline(mode)
    T, rows, cols = masks.shape
    dev = masks.device
    rev = pipe.reversed_dataflow
    unit = spec.nf_unit
    scores, counts, nf_before = manhattan_score(masks, unit, device=dev)
    if rev:
        scores, counts, nf_placed = manhattan_score(masks, unit, reverse=True,
                                                    device=dev)
    else:
        nf_placed = nf_before
    perm = pipe.rows.order(counts, scores, cols)
    if perm is None:
        perm = torch.arange(rows, dtype=torch.int32,
                            device=dev).expand(T, rows).contiguous()
        return perm, perm.clone(), nf_before, nf_placed.clone()
    perm = perm.to(torch.int32)
    position = inverse_permutation(perm)
    _, _, nf_after = manhattan_score(masks, unit, reverse=rev,
                                     row_position=position, device=dev)
    return perm, position, nf_before, nf_after


def plan_from_masks(masks: torch.Tensor, scale: torch.Tensor,
                    spec: CrossbarSpec,
                    mode: str | MappingPipeline = "mdm") -> MdmPlan:
    """MDM plan from tile activity masks (Ti, Tn, rows, cols)."""
    pipe = resolve_pipeline(mode)
    ti, tn, rows, cols = masks.shape
    perm, position, nf_before, nf_after = plan_tile_population(
        masks.reshape(ti * tn, rows, cols), spec, pipe)
    return MdmPlan(perm.reshape(ti, tn, rows), position.reshape(ti, tn, rows),
                   pipe.reversed_dataflow, nf_before.reshape(ti, tn),
                   nf_after.reshape(ti, tn), scale)


def plan_from_bits(bits: torch.Tensor, scale: torch.Tensor,
                   spec: CrossbarSpec,
                   mode: str | MappingPipeline = "mdm") -> MdmPlan:
    """MDM plan from bit-sliced weights (I, N, K)."""
    return plan_from_masks(tile_masks(bits, spec), scale, spec, mode)


def plan_layer(w: torch.Tensor, spec: CrossbarSpec,
               mode: str | MappingPipeline = "mdm") -> MdmPlan:
    """Bit-slice a weight matrix and build its deployment plan."""
    if w.ndim != 2:
        raise ValueError("plan_layer expects a 2-D (in_dim, out_dim) matrix")
    sliced = bitslice(w, spec.n_bits)
    return plan_from_bits(sliced.bits, sliced.scale, spec, mode)


def placed_masks(bits: torch.Tensor, plan: MdmPlan,
                 spec: CrossbarSpec) -> torch.Tensor:
    """Physical tile activity masks under a plan."""
    masks = tile_masks(bits, spec)
    if plan.reversed_dataflow:
        masks = reverse_dataflow(masks)
    idx = plan.row_perm.to(torch.int64)[..., None].expand_as(masks)
    return torch.gather(masks, -2, idx)
