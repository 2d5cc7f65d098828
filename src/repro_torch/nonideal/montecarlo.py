"""Monte-Carlo NF / degradation engine over fault and variation ensembles.

Port of ``repro.nonideal.montecarlo``.  Under stochastic device
nonidealities the quantity of interest is a distribution over
realisations.  This engine produces it without a Python loop over
samples in the solve:

1. ``n_samples`` :class:`repro_torch.nonideal.models.CellSample` draws,
   sample s from the generators keyed by ``derive_key(key, s)``;
2. the perturbed conductance fields are folded into the solver's tile
   axis ((S, T) -> S T): the batched PCG engine is embarrassingly
   parallel over tiles, so the sample axis rides the same loop
   (``repro_torch.crossbar.batched.measured_nf_conductances_checked``);
3. per-sample NF and significance-weighted degradation come back with
   the (S, ...) axes restored; :func:`summarize` reduces them.

:func:`mc_nf_oracle` is the small-case parity reference: the same
per-sample computation as a Python loop over single-sample solves, with
the same draws bit for bit.  JAX's split keys cannot be reproduced in
torch, so parity with the reference moves its sampled cells across
(``repro_torch.convert.cell_sample_from_reference``).

Telemetry (``repro_torch.telemetry``, the reference's names): an
:func:`mc_nf` sweep opens the span ``nonideal/mc_nf`` and observes
``repro_mc_sweep_seconds``; while telemetry is on it also copies the
NF back to count the samples and unconverged tiles and set the mean
and p95 gauges.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.crossbar.batched import (
    measured_nf_conductances,
    measured_nf_conductances_checked,
)
from repro_torch.crossbar.solver import as_tensor
from repro_torch.device import resolve_device, same_device
from repro_torch.nonideal.models import (
    CellSample,
    NonidealModel,
    apply_to_conductances,
    conductances_from_masks,
    derive_key,
    sample_cell_state,
)

_H_MC_SWEEP = tm.histogram(
    "repro_mc_sweep_seconds", "Wall time of one mc_nf ensemble solve.")
_C_MC_SAMPLES = tm.counter(
    "repro_mc_samples_total", "Monte-Carlo samples solved (S x tiles).")
_C_MC_UNCONV = tm.counter(
    "repro_mc_unconverged_total",
    "Ensemble tiles unconverged after escalation.")
_G_MC_NF_MEAN = tm.gauge(
    "repro_mc_nf_mean", "Mean NF of the most recent mc_nf sweep.")
_G_MC_NF_P95 = tm.gauge(
    "repro_mc_nf_p95", "95th-percentile NF of the most recent sweep.")


class McNfResult(NamedTuple):
    """Per-sample, per-tile Monte-Carlo results.

    nf_total:     (S, ...) aggregate |sum di| / sum i0 per tile.
    weighted_err: (S, ...) ``sum_c w_c |di_c| / sum_c w_c i0_c``: with
                  uniform weights a cancellation-free NF, with
                  bit-significance weights the accuracy-degradation proxy.
    residual:     (S, ...) final relative residual per tile.
    iterations:   shared iteration count of the solve.
    unconverged:  tiles that missed tol or produced non-finite output.
    report:       the solver watchdog's SolverReport, or None for the
                  oracle.
    """

    nf_total: object
    weighted_err: object
    residual: object
    iterations: int
    unconverged: int
    report: object = None


def summarize(x) -> dict:
    """Mean / std / p95 over the whole (samples x tiles) ensemble."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    return {"mean": float(np.mean(x)), "std": float(np.std(x)),
            "p95": float(np.percentile(x, 95.0))}


def _weighted_err(currents, ideal, col_weights):
    """Column-weighted error; ``col_weights`` is one (cols,) vector or
    per-tile (..., cols) weights broadcasting against (S, ..., cols)."""
    di = (currents - ideal).abs()
    if col_weights is not None:
        w = torch.as_tensor(col_weights, dtype=di.dtype, device=di.device)
        di = di * w
        ideal = ideal * w
    return di.sum(-1) / ideal.sum(-1).clamp_min(1e-30)


def mc_samples(key: int, masks: torch.Tensor, spec, model: NonidealModel,
               n_samples: int, stuck: torch.Tensor | None = None, *,
               device: str | torch.device = "cuda"):
    """(perturbed g (S, ..., J, K), clean g (..., J, K)) for ``masks``:
    sample s drawn by ``sample_cell_state(derive_key(key, s), ...)``.
    ``stuck`` pins a known physical fault map shared by every sample;
    variation and read noise stay per sample."""
    dev = resolve_device(device)
    masks = as_tensor(masks, dev)
    draws = [sample_cell_state(derive_key(key, s), masks.shape, model,
                               stuck, device=dev) for s in range(n_samples)]
    sample = CellSample(*(None if f[0] is None else torch.stack(f)
                          for f in zip(*draws)))
    return (apply_to_conductances(masks, sample, spec, model),
            conductances_from_masks(masks, spec))


def _flat(masks, stuck, col_weights, dev):
    masks = as_tensor(masks, dev)
    flat = masks.reshape((-1,) + masks.shape[-2:])
    if stuck is not None:
        stuck = as_tensor(stuck, dev, torch.int8).reshape(flat.shape)
    if col_weights is not None:
        col_weights = as_tensor(col_weights, dev)
        if col_weights.dim() > 1:
            col_weights = col_weights.reshape(-1, col_weights.shape[-1])
    return masks.shape[:-2], flat, stuck, col_weights


def mc_nf(masks, spec, model: NonidealModel, n_samples: int, key: int, *,
          stuck=None, precision="mixed", ctx=None, col_weights=None,
          maxiter: int = 4000, chain_impl: str = "lax",
          device: str | torch.device = "cuda") -> McNfResult:
    """NF / degradation distribution of a tile population under ``model``.

    ``masks``: (..., J, K) clean activity masks.  The (n_samples, T)
    ensemble is folded into the solver's tile axis: one checked PCG
    call, whose watchdog escalates failed tiles and reports the rest in
    ``unconverged`` and ``report``.  ``col_weights``: global (cols,) or
    per-tile (..., cols) weights (per tile under column-permuted
    pipelines).  With ``ctx`` the ensemble is solved sharded over the
    ctx's logical "tiles" mesh (``repro_torch.distributed.solver_shard``),
    each shard its slice of the sample x tile axis; the mesh's first
    device must be ``device``, where the ensemble is drawn."""
    dev = resolve_device(device)
    if ctx is not None and ctx.mesh is not None and \
            not same_device(ctx.mesh.devices[0], dev):
        raise ValueError(f"mc_nf: the ensemble is drawn on {dev}, but the "
                         f"ctx's mesh solves on {ctx.mesh.devices[0]}")
    t0 = tm.monotonic()
    with tm.span("nonideal/mc_nf", samples=n_samples):
        batch_shape, flat, stuck, col_weights = _flat(masks, stuck,
                                                      col_weights, dev)
        g, g_ref = mc_samples(key, flat, spec, model, n_samples, stuck,
                              device=dev)
        if ctx is not None:
            from repro_torch.distributed.solver_shard import (
                measured_nf_conductances_sharded_checked,
            )
            res, report = measured_nf_conductances_sharded_checked(
                g, spec, g_ref=g_ref, maxiter=maxiter, precision=precision,
                ctx=ctx, chain_impl=chain_impl, device=dev)
            unconverged = res.unconverged
        else:
            res, report = measured_nf_conductances_checked(
                g, spec, g_ref=g_ref, maxiter=maxiter, precision=precision,
                chain_impl=chain_impl, device=dev)
            unconverged = report.n_failed
        werr = _weighted_err(res.currents, res.ideal, col_weights)
        shape = (n_samples,) + tuple(batch_shape)
        out = McNfResult(res.nf_total.reshape(shape), werr.reshape(shape),
                         res.residual.reshape(shape), res.iterations,
                         unconverged, report)
        if tm.enabled():
            # A telemetry-only host copy (it syncs the card); the
            # computed numbers are untouched.
            nf = out.nf_total.cpu().numpy().astype(np.float64)
            _C_MC_SAMPLES.inc(nf.size)
            _C_MC_UNCONV.inc(int(unconverged))
            _G_MC_NF_MEAN.set(float(nf.mean()))
            _G_MC_NF_P95.set(float(np.percentile(nf, 95.0)))
    _H_MC_SWEEP.observe(tm.monotonic() - t0)
    return out


def mc_nf_oracle(masks, spec, model: NonidealModel, n_samples: int,
                 key: int, *, stuck=None, precision="mixed",
                 col_weights=None, maxiter: int = 4000,
                 device: str | torch.device = "cuda") -> McNfResult:
    """The same computation as a Python loop of one solve a sample (small
    cases only); the draws are :func:`mc_nf`'s bit for bit.  Fields are
    numpy arrays."""
    dev = resolve_device(device)
    batch_shape, flat, stuck, col_weights = _flat(masks, stuck, col_weights,
                                                  dev)
    g_clean = conductances_from_masks(flat, spec)
    nf, werr, resid = [], [], []
    iters = 0
    for s in range(n_samples):
        sample = sample_cell_state(derive_key(key, s), flat.shape, model,
                                   stuck, device=dev)
        g = apply_to_conductances(flat, sample, spec, model)
        res = measured_nf_conductances(g, spec, g_ref=g_clean,
                                       maxiter=maxiter, precision=precision,
                                       device=dev)
        nf.append(res.nf_total.cpu().numpy())
        werr.append(_weighted_err(res.currents, res.ideal,
                                  col_weights).cpu().numpy())
        resid.append(res.residual.cpu().numpy())
        iters = max(iters, res.iterations)
    shape = (n_samples,) + tuple(batch_shape)
    resid = np.stack(resid).reshape(shape)
    # ~(resid <= tol): a NaN residual counts as unconverged.
    return McNfResult(np.stack(nf).reshape(shape),
                      np.stack(werr).reshape(shape), resid, iters,
                      int((~(resid <= 1e-12)).sum()))
