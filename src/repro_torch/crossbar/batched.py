"""Batched crossbar circuit-solver engine with precision policies.

Port of ``repro.crossbar.batched``: one preconditioned-CG loop over a
whole (T, 2, J, K) stack of tiles.

* Every stencil matvec and axpy runs across all tiles at once.
* The preconditioner is the **line (tridiagonal) preconditioner**: the
  nodal matrix is two families of wire chains (wordlines along k,
  bitlines along j) coupled only through the memristor conductances,
  and ``g / cw ~ r / R_on ~ 1e-5`` makes that coupling weak.  Solving
  the chains exactly leaves ``M^-1 A ~= I + O(g / cw)``, so CG converges
  in a handful of iterations where Jacobi needs hundreds.
  ``chain_impl`` picks how: ``"lax"`` (the default) runs the
  hand-written kernel ``repro_torch.kernels.line_solve`` on the card,
  the counterpart of the reference's batched
  ``jax.lax.linalg.tridiagonal_solve`` (its plain version on the CPU);
  ``"assoc"`` applies a Thomas factorisation through log-depth scans in
  torch; ``"jacobi"`` is the diagonal alone.  Tiles with fewer than 3
  rows or columns always take Jacobi, as in the reference.
* Convergence is tracked **per tile**: a converged tile is frozen (zero
  step) while the loop runs the stragglers; the loop exits once every
  tile has converged, read on the host once an iteration.
* **Precision is a policy** (:class:`SolverPrecision`): :data:`F64` is
  the all-f64 solve, :data:`MIXED` runs the CG in f32 and polishes the
  promoted iterate with warm-started f64 CG (1-2 iterations), :data:`F32`
  skips the polish.

The ``*_checked`` entry points add the convergence watchdog: a NaN-aware
per-tile check and a bounded escalation ladder for failed tiles.  They
return the :class:`SolverReport`, and only they record it in the
solver counters (:func:`record_solver_report`, the reference's names),
so an escalated rerun is not counted twice.  Entry points take
``device`` (default the card); tensor inputs must lie there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import telemetry as tm
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.crossbar.solver import (
    F64 as _F64,
    _currents,
    _drive,
    ideal_currents,
    _jacobi_diag,
    _spec_arr,
    _stencil_matvec,
    as_tensor,
    mask_conductances,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.line_solve.ops import line_solve
from repro_torch.kernels.line_solve.ref import chain_bands
from repro_torch.kernels.line_solve.ref import thomas_factor as _thomas_factor

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclass(frozen=True)
class SolverPrecision:
    """How the batched PCG spends its arithmetic (hashable).

    ``cg_dtype``: dtype of the main CG loop ("float64" or "float32").
    ``coarse_tol``: relative-residual target of an f32 main loop (f32 CG
    stalls near ~1e-7, so the caller's ``tol`` is not reachable there).
    ``coarse_maxiter``: stall guard on the f32 loop.  ``polish``: run
    warm-started f64 CG from the promoted f32 iterate down to ``tol``.
    ``polish_maxiter``: cap on the polish loop.
    """

    cg_dtype: str = "float64"
    coarse_tol: float = 1e-5
    coarse_maxiter: int = 64
    polish: bool = False
    polish_maxiter: int = 64

    @property
    def is_f64(self) -> bool:
        return self.cg_dtype == "float64"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cg_dtype]


F64 = SolverPrecision()
MIXED = SolverPrecision(cg_dtype="float32", polish=True)
F32 = SolverPrecision(cg_dtype="float32", polish=False)

_POLICIES = {"f64": F64, "float64": F64, "mixed": MIXED,
             "f32": F32, "float32": F32}


def resolve_precision(
        precision: SolverPrecision | str | None) -> SolverPrecision:
    """None -> F64; strings name the canned policies."""
    if precision is None:
        return F64
    if isinstance(precision, str):
        try:
            return _POLICIES[precision.lower()]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {precision!r}; "
                f"expected one of {sorted(_POLICIES)}") from None
    return precision


class BatchedSolveResult(NamedTuple):
    """Per-tile results, leading axes the tile batch; the fields of
    :class:`repro_torch.crossbar.solver.SolveResult` plus the shared
    iteration count of every loop run (main and polish)."""

    currents: torch.Tensor   # (..., K) actual column currents under PR
    ideal: torch.Tensor      # (..., K) ideal currents (r = 0)
    nf_cols: torch.Tensor    # (..., K) per-column |di / i0|
    nf_total: torch.Tensor   # (...,) aggregate |sum di| / sum i0
    residual: torch.Tensor   # (...,) final per-tile relative residual
    iterations: int          # shared CG iterations until all done


class SolverReport(NamedTuple):
    """The watchdog's verdict on a (possibly escalated) solve: which
    tiles can be trusted, even where the PCG hit its cap or produced
    NaN/Inf iterates."""

    converged: torch.Tensor  # (...,) per tile: finite AND residual <= tol
    iterations: int          # total shared iterations, all stages
    escalations: int         # escalation stages run
    n_failed: int            # tiles still unconverged at the end

    @property
    def all_converged(self) -> bool:
        return bool(self.converged.all())


_C_SOLVES = tm.counter(
    "repro_solver_solves_total",
    "Checked batched circuit solves (one per *_checked call).")
_C_SOLVE_ITERS = tm.counter(
    "repro_solver_iterations_total",
    "Shared PCG iterations across all solve stages.")
_C_SOLVE_ESC = tm.counter(
    "repro_solver_escalations_total",
    "Watchdog escalation rungs actually run.")
_C_SOLVE_FAILED = tm.counter(
    "repro_solver_failed_tiles_total",
    "Tiles still unconverged after the full escalation ladder.")


def record_solver_report(report: SolverReport) -> None:
    """Fold one watchdog verdict into the solver counters.

    Called only by the ``*_checked`` front doors (here and in
    :mod:`repro_torch.distributed.solver_shard`), never by the inner
    stages, so escalated reruns are not counted twice.  The ``int()``
    coercions run only while telemetry is on."""
    if not tm.enabled():
        return
    _C_SOLVES.inc()
    _C_SOLVE_ITERS.inc(int(report.iterations))
    _C_SOLVE_ESC.inc(int(report.escalations))
    _C_SOLVE_FAILED.inc(int(report.n_failed))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-tile inner product over the (2, J, K) node axes."""
    return (a * b).sum(dim=(1, 2, 3))


def _affine_scan(alpha: torch.Tensor, beta: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """y_i = alpha_i y_(i-1) + beta_i along the last axis (y_(i+1) with
    ``reverse``) by a log-depth scan: the affine maps compose
    associatively.  Stable here since diagonal dominance keeps
    |alpha| < 1."""
    a, b = (alpha.flip(-1), beta.flip(-1)) if reverse else (alpha, beta)
    s = 1
    while s < a.shape[-1]:
        b = torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], -1)
        a = torch.cat([a[..., :s], a[..., :-s] * a[..., s:]], -1)
        s *= 2
    return b.flip(-1) if reverse else b


def _thomas_apply(lo, c, denom, r) -> torch.Tensor:
    """Forward and back substitution with a precomputed factorisation,
    each sweep a log-depth scan."""
    y = _affine_scan(-lo / denom, r / denom)
    return _affine_scan(-c, y, reverse=True)


def _line_preconditioner(g: torch.Tensor, cw, chain_impl: str = "lax"):
    """z = M^-1 r for M = blockdiag(wordline chains + diag(g), bitline
    chains + diag(g)): SPD, everything of A but the weak W <-> B
    memristor coupling.  ``chain_impl``: "lax" (the line_solve kernel),
    "assoc" (Thomas factor once, log-depth scans an application) or
    "jacobi".  Chains shorter than 3 nodes always take Jacobi."""
    if chain_impl not in ("lax", "assoc", "jacobi"):
        raise ValueError(f"unknown chain_impl {chain_impl!r}")
    T, J, K = g.shape
    if min(J, K) < 3 or chain_impl == "jacobi":
        diag = _jacobi_diag(g, cw)
        return lambda r: r / diag
    if chain_impl == "lax":
        return lambda r: line_solve(g, r, cw)
    diag = _jacobi_diag(g, cw)
    lo_k, hi_k = chain_bands(cw, K, (T, J, K), g.dtype, g.device)
    lo_j, hi_j = chain_bands(cw, J, (T, K, J), g.dtype, g.device)
    c_w, den_w = _thomas_factor(lo_k, diag[:, 0], hi_k)
    c_b, den_b = _thomas_factor(lo_j, diag[:, 1].transpose(1, 2), hi_j)

    def pre(r):
        z_w = _thomas_apply(lo_k, c_w, den_w, r[:, 0])
        z_b = _thomas_apply(lo_j, c_b, den_b, r[:, 1].transpose(1, 2))
        return torch.stack([z_w, z_b.transpose(1, 2)], dim=1)

    return pre


def _pcg_loop(g: torch.Tensor, cw, b: torch.Tensor, x0, tol,
              maxiter: int, chain_impl: str = "lax"):
    """Preconditioned CG over a (T, 2, J, K) state stack in g's dtype,
    with a per-tile freeze and a shared early exit.  ``x0=None`` starts
    from zero.  Returns (x, residual vectors, iterations)."""
    dtype = g.dtype
    pre = _line_preconditioner(g, cw, chain_impl)
    b_norm2 = _dot(b, b).clamp_min(torch.finfo(dtype).tiny)
    tol2 = torch.tensor(tol, dtype=dtype) ** 2
    if x0 is None:
        x, res = torch.zeros_like(b), b.clone()
    else:
        x = x0.clone()
        res = b - _stencil_matvec(g, cw, x)
    p = pre(res)
    rz = _dot(res, p)
    done = _dot(res, res) <= tol2 * b_norm2
    k = 0
    while k < maxiter and not bool(done.all()):
        Ap = _stencil_matvec(g, cw, p)
        pAp = _dot(p, Ap)
        # Frozen (done) tiles and degenerate directions take a zero step.
        ok = ~done & (pAp > 0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        a4 = alpha[:, None, None, None]
        x += a4 * p
        res -= a4 * Ap
        z = pre(res)
        rz_new = _dot(res, z)
        beta = torch.where(ok, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = torch.where(done[:, None, None, None], p,
                        z + beta[:, None, None, None] * p)
        done = done | (_dot(res, res) <= tol2 * b_norm2)
        rz = torch.where(ok, rz_new, rz)
        k += 1
    return x, res, k


def _solve_core_g(g: torch.Tensor, g_ref: torch.Tensor, v_in: torch.Tensor,
                  spec_arr, maxiter: int, tol, precision: SolverPrecision,
                  chain_impl: str = "lax") -> BatchedSolveResult:
    """Batched solve over explicit per-cell conductances g (T, J, K).

    ``g_ref`` holds the intended (clean) conductances, against which the
    ideal currents, hence the NF, are measured; it is (T, J, K) or one
    (n, J, K) reference repeated T / n times along the tile axis (the
    Monte-Carlo ensemble's layout), repeated in memory only under a
    per-tile drive.  ``v_in`` is (J,) or (T, J)."""
    g = g.to(_F64)
    T, J, K = g.shape
    v_in = v_in.to(_F64)
    cw = 1.0 / float(spec_arr[0])
    b = torch.zeros((T, 2, J, K), dtype=_F64, device=g.device)
    b[:, 0, :, 0] = cw * v_in

    if precision.is_f64:
        x, res, iters = _pcg_loop(g, cw, b, None, tol, maxiter, chain_impl)
    else:
        # The coarse phase: all CG arithmetic in f32.
        cdt = precision.dtype
        x32, _, iters = _pcg_loop(g.to(cdt), cw, b.to(cdt), None,
                                  max(float(tol), precision.coarse_tol),
                                  min(maxiter, precision.coarse_maxiter),
                                  chain_impl)
        x = x32.to(_F64)
        del x32
        if precision.polish:
            x, res, kp = _pcg_loop(g, cw, b, x, tol,
                                   precision.polish_maxiter, chain_impl)
            iters += kp
        else:
            res = b - _stencil_matvec(g, cw, x)      # the true f64 residual
    b_norm2 = _dot(b, b).clamp_min(torch.finfo(_F64).tiny)
    resid = torch.sqrt(_dot(res, res) / b_norm2)
    currents, ideal, nf_cols, nf_total = _currents(
        x, cw, _ideal(g_ref.to(_F64), v_in, T))
    return BatchedSolveResult(currents, ideal, nf_cols, nf_total, resid,
                              iters)


def _ideal(g_ref: torch.Tensor, v_in: torch.Tensor, T: int) -> torch.Tensor:
    """Ideal currents (T, K) of a clean reference of n | T tiles repeated
    along the tile axis (tile t reads reference tile t mod n), under a
    shared (J,) or per-tile (T, J) drive."""
    n = g_ref.shape[0]
    if v_in.dim() == 1:
        return ideal_currents(g_ref, v_in).repeat(T // n, 1)
    return ideal_currents(g_ref.repeat(T // n, 1, 1), v_in)


def _solve_core(active, v_in, spec_arr, maxiter: int, tol,
                precision: SolverPrecision,
                chain_impl: str = "lax") -> BatchedSolveResult:
    g = mask_conductances(active, float(spec_arr[1]), float(spec_arr[2]))
    return _solve_core_g(g, g, v_in, spec_arr, maxiter, tol, precision,
                         chain_impl)


def solve_crossbar_batched(active, v_in, spec_arr, maxiter: int = 4000,
                           tol: float = 1e-12,
                           precision: SolverPrecision = F64,
                           chain_impl: str = "lax", *,
                           device: str | torch.device = "cuda"
                           ) -> BatchedSolveResult:
    """Solve a (T, J, K) batch of activity masks in one PCG loop.

    ``v_in``: (J,) shared or (T, J) per-tile drive voltages; ``spec_arr``
    = (r, r_on, r_off).  Tiles that converge early are frozen while the
    loop finishes the rest; it exits when every tile's relative residual
    is <= ``tol`` or at ``maxiter``."""
    dev = resolve_device(device)
    return _solve_core(as_tensor(active, dev), as_tensor(v_in, dev, _F64),
                       spec_arr, maxiter, tol, precision, chain_impl)


def solve_conductances_batched(g, g_ref, v_in, spec_arr, maxiter: int = 4000,
                               tol: float = 1e-12,
                               precision: SolverPrecision = F64,
                               chain_impl: str = "lax", *,
                               device: str | torch.device = "cuda"
                               ) -> BatchedSolveResult:
    """Solve a (..., J, K) batch of conductance fields in one PCG loop.

    ``g`` carries the perturbed per-cell conductances, ``g_ref`` the
    intended clean ones that define the ideal currents; ``g_ref`` may
    have fewer leading dims than ``g`` (one (T, J, K) reference under an
    (S, T, J, K) ensemble) and is not broadcast in memory.  Results come
    back flat over the leading dims."""
    dev = resolve_device(device)
    g = as_tensor(g, dev)
    g_ref = _ref_layout(as_tensor(g_ref, dev), g.shape)
    J, K = g.shape[-2:]
    return _solve_core_g(g.reshape(-1, J, K), g_ref.reshape(-1, J, K),
                         as_tensor(v_in, dev, _F64), spec_arr, maxiter,
                         tol, precision, chain_impl)


def _ref_layout(g_ref: torch.Tensor, g_shape) -> torch.Tensor:
    """``g_ref`` as it stands when its shape ends g's (one reference
    under a stack of samples: flat tile t reads reference tile t mod n),
    else broadcast to g's shape."""
    if tuple(g_shape[len(g_shape) - g_ref.dim():]) == tuple(g_ref.shape):
        return g_ref
    return g_ref.expand(g_shape)


def _unflatten(res: BatchedSolveResult, lead) -> BatchedSolveResult:
    return BatchedSolveResult(*(f.reshape(tuple(lead) + f.shape[1:])
                                for f in res[:-1]), res.iterations)


def measured_nf_conductances(g, spec: CrossbarSpec, g_ref=None, v_in=None,
                             maxiter: int = 4000, precision=None,
                             chain_impl: str = "lax", *,
                             device: str | torch.device = "cuda"
                             ) -> BatchedSolveResult:
    """Circuit-measured NF of perturbed conductance fields g (..., J, K)
    [S], in one solve; ``g_ref`` the clean conductances (default g; may
    carry fewer leading dims).  The result carries g's leading dims."""
    dev = resolve_device(device)
    g = as_tensor(g, dev)
    v = _drive(v_in, g.shape[-2], spec, dev)
    flat_v = v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v
    res = solve_conductances_batched(
        g, g if g_ref is None else g_ref, flat_v, _spec_arr(spec), maxiter,
        precision=resolve_precision(precision), chain_impl=chain_impl,
        device=dev)
    return _unflatten(res, g.shape[:-2])


def measured_nf_batched(active, spec: CrossbarSpec, v_in=None,
                        maxiter: int = 4000, precision=None,
                        chain_impl: str = "lax", *,
                        device: str | torch.device = "cuda"
                        ) -> BatchedSolveResult:
    """Circuit-measured NF of activity masks (..., J, K) in one solve
    (a single (J, K) tile is a batch of one); the result carries the
    same leading dims.  ``precision``: a policy, its name, or None
    (f64)."""
    dev = resolve_device(device)
    active = as_tensor(active, dev)
    v = _drive(v_in, active.shape[-2], spec, dev)
    flat = active.reshape((-1,) + active.shape[-2:])
    flat_v = v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v
    res = _solve_core(flat, flat_v, _spec_arr(spec), maxiter, 1e-12,
                      resolve_precision(precision), chain_impl)
    return _unflatten(res, active.shape[:-2])


# ------------------------- convergence watchdog ---------------------------

def tile_converged(res: BatchedSolveResult, tol: float) -> torch.Tensor:
    """NaN/Inf-aware per-tile convergence: a tile is healthy iff its
    residual is a finite number <= ``tol`` and every current (hence
    every NF it feeds) is finite.  (``residual > tol`` would count a NaN
    residual as converged.)"""
    finite = (torch.isfinite(res.currents).all(-1)
              & torch.isfinite(res.residual) & torch.isfinite(res.nf_total))
    return finite & (res.residual <= tol)


def _escalation_ladder(precision: SolverPrecision, chain_impl: str,
                       maxiter: int) -> list:
    """Retries for failed tiles, cheapest first: an f32/mixed solve gets
    the full-f64 rerun (same preconditioner); what still fails gets a
    Jacobi-preconditioned f64 rerun with twice the budget (four times
    after an f64 Jacobi solve)."""
    ladder = []
    if not precision.is_f64:
        ladder.append((F64, chain_impl, maxiter))
    if not (precision.is_f64 and chain_impl == "jacobi"):
        ladder.append((F64, "jacobi", 2 * maxiter))
    else:
        ladder.append((F64, "jacobi", 4 * maxiter))
    return ladder


def _escalate_failed(res: BatchedSolveResult, rerun,
                     precision: SolverPrecision, chain_impl: str,
                     maxiter: int, tol: float):
    """Check, then rerun only the failed tiles (``rerun(idx, precision,
    chain_impl, maxiter)``) up the ladder; returns the patched flat
    result and the :class:`SolverReport`."""
    converged = tile_converged(res, tol)
    escalations = 0
    for prec_e, chain_e, mi_e in _escalation_ladder(precision, chain_impl,
                                                    maxiter):
        if bool(converged.all()):
            break
        idx = torch.nonzero(~converged).squeeze(1)
        sub = rerun(idx, prec_e, chain_e, mi_e)
        escalations += 1
        res = BatchedSolveResult(
            *(f.index_copy(0, idx, s) for f, s in zip(res[:5], sub[:5])),
            res.iterations + sub.iterations)
        converged = converged.index_copy(0, idx, tile_converged(sub, tol))
    return res, SolverReport(converged, res.iterations, escalations,
                             int((~converged).sum()))


def _ref_subset(g_ref: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The clean reference's tiles (laid out by :func:`_ref_layout`) at
    flat tile indices ``idx`` of g."""
    flat = g_ref.reshape((-1,) + g_ref.shape[-2:])
    return flat[idx % flat.shape[0]]


def measured_nf_conductances_checked(g, spec: CrossbarSpec, g_ref=None,
                                     v_in=None, maxiter: int = 4000,
                                     precision=None, chain_impl: str = "lax",
                                     tol: float = 1e-12,
                                     escalate: bool = True, *,
                                     device: str | torch.device = "cuda"):
    """:func:`measured_nf_conductances` with the convergence watchdog.
    Returns (BatchedSolveResult, SolverReport): failed tiles rerun up
    the escalation ladder and patched in; the report says which tiles
    can be trusted.  ``escalate=False`` checks without retrying."""
    precision = resolve_precision(precision)
    dev = resolve_device(device)
    g = as_tensor(g, dev)
    g_ref = g if g_ref is None else _ref_layout(as_tensor(g_ref, dev),
                                                g.shape)
    v = _drive(v_in, g.shape[-2], spec, dev)
    flat_v = v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v
    spec_arr = _spec_arr(spec)
    res = solve_conductances_batched(g, g_ref, flat_v, spec_arr, maxiter,
                                     tol, precision, chain_impl, device=dev)
    g_flat = g.reshape((-1,) + g.shape[-2:])

    def rerun(idx, prec_e, chain_e, mi_e):
        v_e = flat_v[idx] if flat_v.dim() > 1 else flat_v
        return _solve_core_g(g_flat[idx], _ref_subset(g_ref, idx),
                             v_e, spec_arr, mi_e, tol, prec_e, chain_e)

    if escalate:
        res, report = _escalate_failed(res, rerun, precision, chain_impl,
                                       maxiter, tol)
    else:
        conv = tile_converged(res, tol)
        report = SolverReport(conv, res.iterations, 0, int((~conv).sum()))
    record_solver_report(report)
    lead = g.shape[:-2]
    return (_unflatten(res, lead),
            report._replace(converged=report.converged.reshape(lead)))


def measured_nf_batched_checked(active, spec: CrossbarSpec, v_in=None,
                                maxiter: int = 4000, precision=None,
                                chain_impl: str = "lax", tol: float = 1e-12,
                                escalate: bool = True, *,
                                device: str | torch.device = "cuda"):
    """:func:`measured_nf_batched` with the convergence watchdog: the
    masks' f64 conductances through
    :func:`measured_nf_conductances_checked` (a (J, K) tile comes back
    unbatched, with a scalar ``converged``)."""
    dev = resolve_device(device)
    g = mask_conductances(as_tensor(active, dev), spec.r_on, spec.r_off)
    return measured_nf_conductances_checked(
        g, spec, g, v_in, maxiter, precision, chain_impl, tol, escalate,
        device=dev)
