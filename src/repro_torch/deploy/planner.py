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

``quantize_codes_host`` is the numpy mirror of the code rounding; with
the scale fixed, numpy, XLA and PyTorch agree on it bit for bit.
"""
from __future__ import annotations

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
                mode: str | MappingPipeline = "mdm"):
    """Quantise and plan one (I, N) matrix on its device.

    Returns (plan, codes, sign, scale); the codes and signs feed
    packaging without a second quantisation pass.
    """
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {tuple(w.shape)}")
    codes, sign, scale = quantize_magnitude(w, spec.n_bits)
    plan = plan_from_bits(codes_to_bits(codes, spec.n_bits), scale, spec,
                          mode)
    return plan, codes, sign, scale


def fingerprint_matrices(mats: Mapping[str, torch.Tensor],
                         spec: CrossbarSpec, mode) -> dict[str, str]:
    """The plan-cache key of every matrix, fingerprinted in a thread
    pool, one host copy a thread at a time."""
    token = resolve_pipeline(mode).cache_token()
    workers = max(1, min(os.cpu_count() or 1, len(mats)))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        fps = ex.map(weight_fingerprint, mats.values())
        return {name: plan_key(fp, spec, token)
                for name, fp in zip(mats, fps)}


def _host_plan(plan: MdmPlan) -> MdmPlan:
    return plan._replace(**{f: getattr(plan, f).cpu() for f in (
        "row_perm", "row_position", "nf_before", "nf_after", "scale")})


def plan_matrices(mats: Mapping[str, torch.Tensor], spec: CrossbarSpec,
                  mode: str | MappingPipeline = "mdm",
                  cache: PlanCache | None = None
                  ) -> tuple[dict[str, MdmPlan], dict]:
    """Plan every (I, N) matrix of ``mats``, through ``cache`` if given.

    Returns ({name: MdmPlan}, report).  Without a cache every plan
    stays on its matrix's device.  With one, every plan is on the CPU
    (decoded hits, and misses copied back after planning on the
    device).  The report counts tiles planned (misses only), cache hits
    and misses, and whether one manifest read resolved the whole set.
    """
    for name, w in mats.items():
        if w.ndim != 2:
            raise ValueError(f"{name}: expected a 2-D matrix, got "
                             f"{tuple(w.shape)}")
    plans: dict[str, MdmPlan] = {}
    keys: dict[str, str] = {}
    misses = list(mats)
    manifest_hit = False
    if cache is not None:
        keys = fingerprint_matrices(mats, spec, mode)
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
        plan = plan_matrix(mats[name], spec, mode)[0]
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
