"""Whole-model MDM planning, one matrix at a time, through the plan cache.

Port of ``repro.deploy.planner`` without the mesh sharding.  Each
matrix is quantised, bit-sliced and tiled on its own device, and its
tile population is planned in one pass
(:func:`repro_torch.core.mdm.plan_tile_population`, whose reductions
run in the ``manhattan_score`` kernel on the card).  Planning proceeds
in chunks of one matrix: phi3-mini's 7.07M tiles at once would be 29 GB
of uint8 masks, one 8192 x 3072 matrix is 200 MB.

:func:`plan_matrices` looks every matrix up in a
:class:`repro_torch.deploy.cache.PlanCache` first (fingerprints and
probes in a thread pool, one manifest read for a checkpoint deployed
before, else one probe an entry), plans only the misses and writes
their entries and the manifest.  Keys and entries are the reference's.

Without a cache, a deploy plans lazily (:class:`LazyPlans`): each
matrix right before it is packaged.

Fault maps (name -> (Ti, Tn, rows, cols) int8 physical cell states)
feed the fault-consuming passes and enter each key as the reference's
fault fingerprint; a mapping may produce them lazily (the deployment
engine draws a matrix's cells when it is reached).  A bf16 matrix is
keyed on its f32 widening, as the reference keys its f32 host copy.

``quantize_codes_host`` is the numpy mirror of the code rounding; with
the scale fixed, numpy, XLA and PyTorch agree on it bit for bit.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
from repro_torch.core.mdm import MdmPlan, plan_from_bits
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy.cache import (
    PlanCache,
    encode_plan,
    plan_key,
    weight_fingerprint,
)
from repro_torch.mapping import MappingPipeline, resolve_pipeline


def quantize_codes_host(w: np.ndarray, scale: np.float32,
                        n_bits: int) -> np.ndarray:
    """Host mirror of ``quantize_magnitude``'s code rounding (uint32);
    ``scale`` from ``magnitude_scale_host``."""
    levels = (1 << n_bits) - 1
    mag = np.abs(np.asarray(w, np.float32))
    return np.clip(np.round(mag / scale * np.float32(1 << n_bits)),
                   np.float32(0), np.float32(levels)).astype(np.uint32)


def plan_matrix(w: torch.Tensor, spec: CrossbarSpec,
                mode: str | MappingPipeline = "mdm",
                fault_map: torch.Tensor | None = None):
    """Quantise and plan one (I, N) matrix on its device (``fault_map``:
    its (Ti, Tn, rows, cols) physical cell states, or None).

    Returns (plan, codes, sign, scale); the codes and signs feed
    packaging without a second quantisation pass.
    """
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {tuple(w.shape)}")
    codes, sign, scale = quantize_magnitude(w, spec.n_bits)
    plan = plan_from_bits(codes_to_bits(codes, spec.n_bits), scale, spec,
                          mode, fault_map)
    return plan, codes, sign, scale


def _f32_fingerprint(w: torch.Tensor) -> str:
    return weight_fingerprint(w if w.dtype == torch.float32
                              else w.to(torch.float32))


def fingerprint_matrices(mats: Mapping[str, torch.Tensor],
                         spec: CrossbarSpec, mode,
                         fault_maps: Mapping | None = None
                         ) -> dict[str, str]:
    """The plan-cache key of every matrix (of its f32 values, and of its
    fault map where one is given), fingerprinted in a thread pool, one
    host copy a thread at a time."""
    token = resolve_pipeline(mode, fault_maps is not None).cache_token()

    def key_of(name):
        ffp = (None if fault_maps is None or name not in fault_maps
               else weight_fingerprint(fault_maps[name].to(torch.int8)))
        return plan_key(_f32_fingerprint(mats[name]), spec, token, ffp)

    workers = max(1, min(os.cpu_count() or 1, len(mats)))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return dict(zip(mats, ex.map(key_of, mats)))


def _host_plan(plan: MdmPlan) -> MdmPlan:
    return plan._replace(**{f: getattr(plan, f).cpu() for f in (
        "row_perm", "row_position", "nf_before", "nf_after", "scale",
        "col_perm", "col_position") if getattr(plan, f) is not None})


class LazyPlans:
    """name -> plan of an uncached deploy, each matrix planned when it is
    popped (:func:`plan_matrices` with ``lazy``): the deploy packages a
    matrix right after, so one plan is alive at a time (an MoE bank's
    4,320 plans at once would hold ~12 GB of int32 permutations)."""

    def __init__(self, mats, spec, pipe, fault_maps):
        self._mats, self._spec = mats, spec
        self._pipe, self._faults = pipe, fault_maps

    def pop(self, name: str) -> MdmPlan:
        fm = None if self._faults is None else self._faults.get(name)
        return plan_matrix(self._mats[name], self._spec, self._pipe, fm)[0]


def plan_matrices(mats: Mapping[str, torch.Tensor], spec: CrossbarSpec,
                  mode: str | MappingPipeline = "mdm",
                  cache: PlanCache | None = None,
                  fault_maps: Mapping | None = None, lazy: bool = False
                  ) -> tuple[dict[str, MdmPlan], dict]:
    """Plan every (I, N) matrix of ``mats``, through ``cache`` if given.

    Returns ({name: MdmPlan}, report).  Without a cache every plan
    stays on its matrix's device.  With one, every plan is on the CPU
    (decoded hits, and misses copied back after planning on the
    device).  The report counts tiles planned (misses only), cache hits
    and misses, and whether one manifest read resolved the whole set.
    ``fault_maps`` (name -> (Ti, Tn, rows, cols) int8 on the matrix's
    device) steers the fault-consuming passes (the legacy sorting
    modes resolve to fault-aware rows) and keys their plans; a pipeline
    none of whose passes consumes faults drops them, as the reference's.
    ``lazy`` (without a cache) returns a :class:`LazyPlans` instead,
    which plans each matrix when the caller pops it; the report counts
    the tiles those plans will cover.
    """
    pipe = resolve_pipeline(mode, fault_maps is not None)
    if not (pipe.rows.uses_faults or pipe.cols.uses_faults):
        fault_maps = None
    for name, w in mats.items():
        if w.ndim != 2:
            raise ValueError(f"{name}: expected a 2-D matrix, got "
                             f"{tuple(w.shape)}")
    if lazy and cache is None:
        tiles = sum(math.prod(spec.grid(*w.shape)) for w in mats.values())
        return LazyPlans(mats, spec, pipe, fault_maps), {
            "n_matrices": len(mats), "cache_hits": 0,
            "cache_misses": len(mats), "manifest_hit": False,
            "tiles_planned": tiles}
    plans: dict[str, MdmPlan] = {}
    keys: dict[str, str] = {}
    misses = list(mats)
    manifest_hit = False
    if cache is not None:
        keys = fingerprint_matrices(mats, spec, pipe, fault_maps)
        hit_all = cache.get_manifest(keys)
        if hit_all is not None:
            plans, misses, manifest_hit = hit_all, [], True
        else:
            workers = max(1, min(os.cpu_count() or 1, len(keys)))
            with ThreadPoolExecutor(max_workers=workers) as ex:
                hits = list(ex.map(cache.get, keys.values()))
            misses = []
            for name, hit in zip(keys, hits):
                if hit is None:
                    misses.append(name)
                else:
                    plans[name] = hit

    tiles = 0
    blobs: dict[str, bytes] = {}
    for name in misses:
        fm = None if fault_maps is None else fault_maps.get(name)
        plan = plan_matrix(mats[name], spec, pipe, fm)[0]
        tiles += plan.nf_before.numel()
        if cache is not None:
            plan = _host_plan(plan)
            blobs[name] = encode_plan(plan)
            cache.put(keys[name], blobs[name])
        plans[name] = plan
    if cache is not None and not manifest_hit and plans:
        cache.put_manifest(keys, {name: blobs.get(name, plans[name])
                                  for name in keys})
    report = {"n_matrices": len(mats),
              "cache_hits": len(mats) - len(misses),
              "cache_misses": len(misses), "manifest_hit": manifest_hit,
              "tiles_planned": tiles}
    return {name: plans[name] for name in mats}, report
