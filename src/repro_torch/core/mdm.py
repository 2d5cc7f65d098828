"""Manhattan Distance Mapping (MDM) — the paper's core algorithm.

Port of ``repro.core.mdm``: a :class:`repro_torch.mapping
.MappingPipeline` of dataflow orientation (paper step 1), an optional
per-tile bitline permutation, and a row order (the Manhattan sort of
steps 2-3, or its fault-aware variants fed by physical fault maps) over
a population of crossbar tiles.  The plan is pure bookkeeping — per-tile
row (and column) permutations plus the dataflow direction — so
inverting it at the input and column muxes reproduces the original
matmul exactly.

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
from repro_torch.mapping import IdentityCols, MappingPipeline, resolve_pipeline

MODES = ("baseline", "reverse", "sort", "mdm")


class MdmPlan(NamedTuple):
    """Deployment plan for one weight matrix.

    row_perm:     (Ti, Tn, rows) int32 — physical row p of tile (ti, tn)
                  hosts tile-local weight row ``row_perm[ti, tn, p]``.
    row_position: (Ti, Tn, rows) int32 — the inverse permutation.
    reversed_dataflow: bool.
    nf_before / nf_after: (Ti, Tn) f32 per-tile NF (Manhattan model).
    scale: f32 () quantisation scale of the bit-sliced weights.
    col_perm:     (Ti, Tn, cols) int32 — physical bitline p hosts
                  dataflow-layout column ``col_perm[ti, tn, p]`` — or
                  None (identity column strategies).
    col_position: (Ti, Tn, cols) int32 inverse of ``col_perm``, or None.
    """

    row_perm: torch.Tensor
    row_position: torch.Tensor
    reversed_dataflow: bool
    nf_before: torch.Tensor
    nf_after: torch.Tensor
    scale: torch.Tensor
    col_perm: torch.Tensor | None = None
    col_position: torch.Tensor | None = None


def physical_column_significance(spec: CrossbarSpec, reversed_df: bool,
                                 col_perm: torch.Tensor | None = None,
                                 n_tiles: int = 1,
                                 device=None) -> torch.Tensor:
    """Bit significance 2^-(k+1) of the plane each physical column hosts,
    (T, cols) f32, after the dataflow orientation and (optionally) a
    per-tile column permutation ``col_perm`` (T, cols)."""
    K = spec.n_bits
    dev = device if col_perm is None else col_perm.device
    k_of = torch.arange(spec.cols, device=dev) % K
    if reversed_df:
        k_of = (K - 1) - k_of
    sig = 2.0 ** -(1.0 + k_of.to(torch.float32))
    if col_perm is None:
        return sig.expand(n_tiles, spec.cols)
    return sig[col_perm.to(torch.int64)]


def plan_tile_population(masks: torch.Tensor, spec: CrossbarSpec,
                         mode: str | MappingPipeline = "mdm",
                         fault_maps: torch.Tensor | None = None):
    """Plan a flat tile population (T, rows, cols) uint8.

    Returns (row_perm, row_position, col_perm, col_position, nf_before,
    nf_after): (T, rows) int32 twice, (T, cols) int32 twice or None for
    identity column strategies, and (T,) f32 twice.  ``fault_maps``
    ((T, rows, cols) int8 physical cell states,
    ``repro_torch.nonideal.models``) feeds the fault-consuming passes;
    they live in physical coordinates and are never reversed or
    permuted.  ``manhattan_score`` passes: NF before on the raw masks;
    the row keys in the placed column layout (the same pass when the
    dataflow is conventional and no column pass runs); NF after with the
    planned row positions (skipped where the placement is the raw
    layout, whose NF is NF before).
    """
    pipe = resolve_pipeline(mode, fault_maps is not None)
    T, rows, cols = masks.shape
    dev = masks.device
    rev = pipe.reversed_dataflow
    unit = spec.nf_unit
    stuck = (fault_maps if (pipe.rows.uses_faults or pipe.cols.uses_faults)
             else None)
    scores, counts, nf_before = manhattan_score(masks, unit, device=dev)

    # The column pass sees the dataflow-oriented masks and, where it asks
    # for it, the pre-permutation significance of each column.
    col_perm = col_position = None
    placed = None
    if not isinstance(pipe.cols, IdentityCols):
        placed = reverse_dataflow(masks) if rev else masks
        pre_sig = (physical_column_significance(spec, rev, None, T, dev)
                   if pipe.cols.uses_col_significance else None)
        col_perm = pipe.cols.order_tiles(placed, stuck, pre_sig, spec)
    if col_perm is not None:
        col_perm = col_perm.to(torch.int32)
        col_position = inverse_permutation(col_perm)
        placed = torch.gather(placed, -1, col_perm.to(torch.int64)[:, None, :]
                              .expand(T, rows, cols)).contiguous()
        scores, counts, nf_placed = manhattan_score(placed, unit, device=dev)
    elif rev:
        placed = None
        scores, counts, nf_placed = manhattan_score(masks, unit, reverse=True,
                                                    device=dev)
    else:
        placed = None
        nf_placed = nf_before

    col_sig = (physical_column_significance(spec, rev, col_perm, T, dev)
               if pipe.rows.uses_col_significance else None)
    perm = pipe.rows.order(counts, scores, cols, stuck, col_sig, spec)
    if perm is None:
        perm = torch.arange(rows, dtype=torch.int32,
                            device=dev).expand(T, rows).contiguous()
        return (perm, perm.clone(), col_perm, col_position, nf_before,
                nf_placed.clone())
    perm = perm.to(torch.int32)
    position = inverse_permutation(perm)
    if placed is None:
        _, _, nf_after = manhattan_score(masks, unit, reverse=rev,
                                         row_position=position, device=dev)
    else:
        _, _, nf_after = manhattan_score(placed, unit,
                                         row_position=position, device=dev)
    return perm, position, col_perm, col_position, nf_before, nf_after


def plan_from_masks(masks: torch.Tensor, scale: torch.Tensor,
                    spec: CrossbarSpec,
                    mode: str | MappingPipeline = "mdm",
                    fault_maps: torch.Tensor | None = None) -> MdmPlan:
    """MDM plan from tile activity masks (Ti, Tn, rows, cols);
    ``fault_maps`` (Ti, Tn, rows, cols) int8 physical cell states."""
    pipe = resolve_pipeline(mode, fault_maps is not None)
    ti, tn, rows, cols = masks.shape
    if fault_maps is not None:
        fault_maps = fault_maps.reshape(ti * tn, rows, cols)
    perm, position, col_perm, col_position, nf_before, nf_after = \
        plan_tile_population(masks.reshape(ti * tn, rows, cols), spec, pipe,
                             fault_maps)
    grid = lambda t, n: None if t is None else t.reshape(ti, tn, n)
    return MdmPlan(perm.reshape(ti, tn, rows), position.reshape(ti, tn, rows),
                   pipe.reversed_dataflow, nf_before.reshape(ti, tn),
                   nf_after.reshape(ti, tn), scale, grid(col_perm, cols),
                   grid(col_position, cols))


def plan_from_bits(bits: torch.Tensor, scale: torch.Tensor,
                   spec: CrossbarSpec,
                   mode: str | MappingPipeline = "mdm",
                   fault_maps: torch.Tensor | None = None) -> MdmPlan:
    """MDM plan from bit-sliced weights (I, N, K)."""
    return plan_from_masks(tile_masks(bits, spec), scale, spec, mode,
                           fault_maps)


def plan_layer(w: torch.Tensor, spec: CrossbarSpec,
               mode: str | MappingPipeline = "mdm",
               fault_maps: torch.Tensor | None = None) -> MdmPlan:
    """Bit-slice a weight matrix and build its deployment plan."""
    if w.ndim != 2:
        raise ValueError("plan_layer expects a 2-D (in_dim, out_dim) matrix")
    sliced = bitslice(w, spec.n_bits)
    return plan_from_bits(sliced.bits, sliced.scale, spec, mode, fault_maps)


def placed_masks(bits: torch.Tensor, plan: MdmPlan,
                 spec: CrossbarSpec) -> torch.Tensor:
    """Physical tile activity masks under a plan."""
    masks = tile_masks(bits, spec)
    if plan.reversed_dataflow:
        masks = reverse_dataflow(masks)
    if plan.col_perm is not None:
        cidx = plan.col_perm.to(torch.int64)[..., None, :].expand_as(masks)
        masks = torch.gather(masks, -1, cidx)
    idx = plan.row_perm.to(torch.int64)[..., None].expand_as(masks)
    return torch.gather(masks, -2, idx)


def permute_inputs(x_tile: torch.Tensor, plan: MdmPlan, ti: int,
                   tn: int) -> torch.Tensor:
    """The digital input mux: the activations (..., rows) feeding tile
    (ti, tn), in physical-row order.  Row sums are order-free, so the
    tile's column outputs are unchanged (MDM preserves the matmul)."""
    return x_tile[..., plan.row_perm[ti, tn].to(torch.int64)]
