"""Device-sharded crossbar solver: the layer-scale NF sweep engine.

Port of ``repro.distributed.solver_shard``.  The batched PCG of
:mod:`repro_torch.crossbar.batched` is embarrassingly parallel over the
tile axis, so it scales out by splitting the tile batch over a mesh:

* the tile batch is laid out over a 1-D ``"tiles"`` mesh
  (:func:`tile_mesh`: every visible card by default) or any
  :class:`ShardingCtx` mesh whose rules resolve the logical ``"tiles"``
  dim; shard s takes the contiguous slice s of the padded tile axis;
* each shard runs the whole PCG (``batched._solve_core`` /
  ``_solve_core_g``) on its slice with its own early exit: nothing in
  the loop talks to another shard.  Shards on distinct devices run
  concurrently (a host thread a device: the loop reads its convergence
  on the host every iteration); shards sharing a device run in turn;
* the only communication is the **global check after the loop**: the
  sum over shards of unconverged tiles (NaN-aware, ``tile_converged``)
  and the largest shard's iteration count; under ``torch.distributed``
  one ``all_reduce`` each (SUM, MAX), and every rank gets the whole
  population's fields back, as the reference's global arrays;
* tile counts that do not divide the shard count are padded with
  zero-drive tiles (b = 0: converged at iteration 0) and unpadded;
  where the rules replicate "tiles" the whole batch is one shard, on
  the mesh's first device;
* a shard is given only its slice of a broadcast clean reference, never
  the whole ensemble's.

The checked front door records its verdict in the solver counters
(``crossbar.batched.record_solver_report``), as the reference's does.

Entry points run on the card unless the caller asks for the CPU:
``device`` picks the default mesh; tensor inputs lie on the mesh's
first device of this process, where the results come back.
"""
from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.tiling import CrossbarSpec
from repro_torch.crossbar.batched import (
    BatchedSolveResult,
    SolverPrecision,
    SolverReport,
    _escalate_failed,
    _solve_core,
    _solve_core_g,
    record_solver_report,
    resolve_precision,
    tile_converged,
)
from repro_torch.crossbar.solver import F64, _drive, _spec_arr, as_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, ShardingCtx, logical_spec

TILE_AXIS = "tiles"


class ShardedSolveResult(NamedTuple):
    """Per-tile results plus the post-loop global convergence check.

    The first five fields mirror :class:`BatchedSolveResult`'s;
    ``iterations`` is the worst shard's count and ``unconverged`` the
    number of tiles over all shards that missed ``tol`` or produced a
    non-finite result: 0 means the whole population converged."""

    currents: torch.Tensor
    ideal: torch.Tensor
    nf_cols: torch.Tensor
    nf_total: torch.Tensor
    residual: torch.Tensor
    iterations: int
    unconverged: int


def tile_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over the canonical tile axis.

    ``device="cuda"``: the first ``n_devices`` visible cards (all by
    default); a device with an index (``"cuda:0"``) or the CPU:
    ``n_devices`` shards on that one device (1 by default).  Under
    ``torch.distributed`` the axis spans every rank's devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count() if n_devices is None else n_devices
        local = tuple(torch.device("cuda", i) for i in range(n))
    else:
        local = (dev,) * (1 if n_devices is None else n_devices)
    if not local:
        raise ValueError("a tile mesh needs at least one device")
    rank, procs = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, procs = dist.get_rank(), dist.get_world_size()
    return Mesh((TILE_AXIS,), (procs * len(local),), local, rank, procs)


def tile_sharding_ctx(n_devices: int | None = None,
                      device: str | torch.device = "cuda") -> ShardingCtx:
    """ShardingCtx whose mesh shards the logical "tiles" dim."""
    return ShardingCtx(mesh=tile_mesh(n_devices, device))


def _tile_axes(mesh: Mesh, rules) -> tuple[str, ...]:
    """Mesh axes the logical "tiles" dim shards over (rule-resolved; ()
    where the rules replicate it: one shard).  The size passed to
    :func:`logical_spec` is the mesh's device count, which every
    candidate divides: padding handles real tile counts."""
    spec = logical_spec((math.prod(mesh.axis_sizes),), (TILE_AXIS,), mesh,
                        rules)
    if not spec:
        return ()
    axes = spec[0]
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _shard_owners(mesh: Mesh, axes: tuple[str, ...]) -> list:
    """(process, device or None) of each shard: shard s sits at its
    row-major coordinates over ``axes`` and 0 on the other axes."""
    sizes = [mesh.shape[a] for a in axes]
    owners = []
    for s in range(math.prod(sizes)):
        coords = dict.fromkeys(mesh.axis_names, 0)
        for a, n in zip(reversed(axes), reversed(sizes)):
            coords[a], s = s % n, s // n
        flat = 0
        for a, n in zip(mesh.axis_names, mesh.axis_sizes):
            flat = flat * n + coords[a]
        owners.append(mesh.owner(flat))
    return owners


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _rows(x: torch.Tensor, lo: int, real: int, pad: int,
          dev: torch.device) -> torch.Tensor:
    """Rows [lo, lo + real) of ``x`` then ``pad`` zero rows, on ``dev``."""
    part = x[lo:lo + real].to(dev)
    if not pad:
        return part
    return torch.cat([part, part.new_zeros((pad,) + x.shape[1:])])


def _drive_rows(v: torch.Tensor, lo: int, real: int, pad: int,
                dev: torch.device) -> torch.Tensor:
    """A shard's drive: the shared (J,) drive where it has no padding,
    else per tile with zero rows for the padding."""
    if v.dim() == 1:
        if not pad:
            return v.to(dev)
        v = v.expand(lo + real, -1)
    return _rows(v, lo, real, pad, dev)


def _ref_tiles(g_ref: torch.Tensor | None, g: torch.Tensor):
    """The clean reference as (its own tiles (n, J, K), its leading dims
    left-padded with 1s to g's): flat tile t of g reads the tile that
    broadcasting the reference to g's shape would put there
    (:func:`_ref_index`), and no copy at g's size is made."""
    g_lead = tuple(g.shape[:-2])
    if g_ref is None:
        return g.reshape((-1,) + g.shape[-2:]), g_lead
    lead = tuple(g_ref.shape[:-2])
    lead = (1,) * (len(g_lead) - len(lead)) + lead
    if g_ref.shape[-2:] != g.shape[-2:] or len(lead) != len(g_lead) or \
            any(r not in (1, n) for r, n in zip(lead, g_lead)):
        raise ValueError(f"g_ref {tuple(g_ref.shape)} does not broadcast "
                         f"to g {tuple(g.shape)}")
    return g_ref.reshape((-1,) + g_ref.shape[-2:]), lead


def _ref_index(lead, g_lead, idx: torch.Tensor) -> torch.Tensor:
    """Rows of the reference's tiles that flat tiles ``idx`` of g read,
    the reference's leading dims ``lead`` broadcast to g's."""
    out, stride, rest = torch.zeros_like(idx), 1, idx
    for r, n in zip(reversed(lead), reversed(g_lead)):
        if r != 1:
            out = out + rest % n * stride
            stride *= r
        rest = rest // n
    return out


def _ref_rows(ref: torch.Tensor, lead, g_lead, lo: int, real: int,
              pad: int, dev: torch.device) -> torch.Tensor:
    """A shard's slice of the clean reference (:func:`_ref_tiles`), zero
    tiles for the padding.  Where the reference repeats along the tile
    axis (its shape ends g's: tile t reads t mod n): the reference itself
    where the slice covers whole repeats, a view where it lies in one;
    else the slice gathered."""
    n = ref.shape[0]
    k = next((i for i, r in enumerate(lead) if r != 1), len(lead))
    if lead[k:] == g_lead[k:]:
        if not pad and lo % n == 0 and real % n == 0:
            return ref.to(dev)
        if real and lo // n == (lo + real - 1) // n:
            return _rows(ref, lo % n, real, pad, dev)
    idx = _ref_index(lead, g_lead,
                     torch.arange(lo, lo + real, device=ref.device))
    return _rows(ref[idx], 0, real, pad, dev)


def _run_shards(mesh: Mesh, axes: tuple[str, ...], T: int, K: int,
                solve_slice, tol: float) -> ShardedSolveResult:
    """Pad T tiles to the shard count, run ``solve_slice(lo, real, pad,
    dev)`` (a :class:`BatchedSolveResult` of padded tiles [lo, lo + real
    + pad)) for every shard this process owns, then the global check;
    fields unpadded, on this process's first mesh device."""
    owners = _shard_owners(mesh, axes)
    per = -(-T // len(owners))
    by_dev: dict = {}
    for s, (_, dev) in enumerate(owners):
        if dev is not None:
            by_dev.setdefault(dev, []).append(s)

    def run(dev, shards):
        out = []
        with _on(dev):
            for s in shards:
                lo = s * per
                real = max(0, min(per, T - lo))
                res = solve_slice(lo, real, per - real, dev)
                out.append((s, res, int((~tile_converged(res, tol)).sum())))
        return out

    if len(by_dev) <= 1:
        done = [r for d, s in by_dev.items() for r in run(d, s)]
    else:
        with ThreadPoolExecutor(len(by_dev)) as pool:
            futures = [pool.submit(run, d, s) for d, s in by_dev.items()]
            done = [r for f in futures for r in f.result()]
    done.sort(key=lambda r: r[0])
    lead = mesh.devices[0]
    iters = max((r[1].iterations for r in done), default=0)
    unconverged = sum(r[2] for r in done)
    if mesh.process_count == 1:
        fields = [torch.cat([r[1][i].to(lead) for r in done])[:T]
                  for i in range(5)]
        return ShardedSolveResult(*fields, iters, unconverged)
    # Every rank gets every shard's fields: each shard is owned by one
    # rank, the others add zeros.
    n = len(owners) * per
    fields = [torch.zeros((n, K) if i < 3 else (n,), dtype=F64, device=lead)
              for i in range(5)]
    for s, res, _ in done:
        for f, part in zip(fields, res[:5]):
            f[s * per:(s + 1) * per] = part.to(lead)
    for f in fields:
        dist.all_reduce(f, dist.ReduceOp.SUM)
    check = torch.tensor([unconverged, iters], dtype=torch.int64,
                         device=lead)
    dist.all_reduce(check[:1], dist.ReduceOp.SUM)
    dist.all_reduce(check[1:], dist.ReduceOp.MAX)
    return ShardedSolveResult(*(f[:T] for f in fields), int(check[1]),
                              int(check[0]))


def _unflatten(res: ShardedSolveResult, lead_dims) -> ShardedSolveResult:
    return ShardedSolveResult(
        *(f.reshape(tuple(lead_dims) + f.shape[1:]) for f in res[:5]),
        res.iterations, res.unconverged)


def _mesh_axes(ctx: ShardingCtx | None, device):
    """(mesh, tile axes) of ``ctx``; a missing or meshless ctx takes the
    default tile mesh on ``device``, as the reference's."""
    if ctx is None or ctx.mesh is None:
        ctx = tile_sharding_ctx(device=device)
    return ctx.mesh, _tile_axes(ctx.mesh, ctx.rules)


def solve_crossbar_sharded(active, v_in, spec_arr, mesh: Mesh,
                           axes: tuple[str, ...], maxiter: int = 4000,
                           tol: float = 1e-12,
                           precision: SolverPrecision | None = None,
                           chain_impl: str = "lax") -> ShardedSolveResult:
    """Shard a (T, J, K) batch of activity masks over ``axes`` of
    ``mesh`` and solve; ``v_in`` is (J,) or (T, J), ``spec_arr`` =
    (r, r_on, r_off).  T need not divide the shard count: the padding
    is added here.  Inputs lie on the mesh's first device."""
    precision = resolve_precision(precision)
    lead = mesh.devices[0]
    active = as_tensor(active, lead)
    v = as_tensor(v_in, lead, F64)
    T, J, K = active.shape

    def solve_slice(lo, real, pad, dev):
        return _solve_core(_rows(active, lo, real, pad, dev),
                           _drive_rows(v, lo, real, pad, dev), spec_arr,
                           maxiter, tol, precision, chain_impl)

    return _run_shards(mesh, tuple(axes), T, K, solve_slice, tol)


def measured_nf_sharded(active, spec: CrossbarSpec, v_in=None,
                        maxiter: int = 4000,
                        precision: SolverPrecision | str | None = None,
                        ctx: ShardingCtx | None = None,
                        tol: float = 1e-12, chain_impl: str = "lax", *,
                        device: str | torch.device = "cuda"
                        ) -> ShardedSolveResult:
    """Circuit-measured NF of a layer-scale tile population, sharded.

    Drop-in scale-out of :func:`measured_nf_batched`: ``active`` is
    (..., J, K), the result carries the same leading dims plus the
    global check.  ``ctx`` supplies the mesh (default: :func:`tile_mesh`
    on ``device``); where its rules replicate "tiles" the batch is one
    shard on the mesh's first device."""
    precision = resolve_precision(precision)
    mesh, axes = _mesh_axes(ctx, device)
    lead = mesh.devices[0]
    active = as_tensor(active, lead)
    v = _drive(v_in, active.shape[-2], spec, lead)
    flat = active.reshape((-1,) + active.shape[-2:])
    res = solve_crossbar_sharded(
        flat, v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v,
        _spec_arr(spec), mesh, axes, maxiter, tol, precision, chain_impl)
    return _unflatten(res, active.shape[:-2])


def measured_nf_conductances_sharded(
        g, spec: CrossbarSpec, g_ref=None, v_in=None, maxiter: int = 4000,
        precision: SolverPrecision | str | None = None,
        ctx: ShardingCtx | None = None, tol: float = 1e-12,
        chain_impl: str = "lax", *,
        device: str | torch.device = "cuda") -> ShardedSolveResult:
    """Sharded circuit-measured NF of perturbed conductance fields g
    (..., J, K) against the clean ``g_ref`` (default g; may carry fewer
    leading dims, or size-1 dims, that broadcast to g's: one (T, J, K)
    reference under an (S, T, J, K) ensemble; never broadcast in memory,
    a shard gathers its slice).  Scale-out twin of
    :func:`measured_nf_conductances`."""
    precision = resolve_precision(precision)
    mesh, axes = _mesh_axes(ctx, device)
    lead = mesh.devices[0]
    g = as_tensor(g, lead)
    J, K = g.shape[-2:]
    ref, ref_lead = _ref_tiles(
        None if g_ref is None else as_tensor(g_ref, lead), g)
    g_lead = tuple(g.shape[:-2])
    flat = g.reshape(-1, J, K)
    v = _drive(v_in, J, spec, lead)
    v = v.reshape(-1, J) if v.dim() > 1 else v
    spec_arr = _spec_arr(spec)

    def solve_slice(lo, real, pad, dev):
        return _solve_core_g(_rows(flat, lo, real, pad, dev),
                             _ref_rows(ref, ref_lead, g_lead, lo, real, pad,
                                       dev),
                             _drive_rows(v, lo, real, pad, dev), spec_arr,
                             maxiter, tol, precision, chain_impl)

    res = _run_shards(mesh, axes, flat.shape[0], K, solve_slice, tol)
    return _unflatten(res, g.shape[:-2])


def measured_nf_conductances_sharded_checked(
        g, spec: CrossbarSpec, g_ref=None, v_in=None, maxiter: int = 4000,
        precision: SolverPrecision | str | None = None,
        ctx: ShardingCtx | None = None, tol: float = 1e-12,
        chain_impl: str = "lax", escalate: bool = True, *,
        device: str | torch.device = "cuda"):
    """:func:`measured_nf_conductances_sharded` with the convergence
    watchdog.  The sharded solve runs as is; its failed tiles (a handful
    by construction) then rerun up the escalation ladder through the
    batched engine on the mesh's first device and are patched in, and
    ``unconverged`` is recounted.  Returns (ShardedSolveResult,
    SolverReport); ``escalate=False`` checks without retrying."""
    precision = resolve_precision(precision)
    res = measured_nf_conductances_sharded(
        g, spec, g_ref, v_in, maxiter, precision, ctx, tol, chain_impl,
        device=device)
    lead = res.currents.device
    g = as_tensor(g, lead)
    dims, (J, K) = g.shape[:-2], g.shape[-2:]
    flat = BatchedSolveResult(
        *(f.reshape((-1,) + f.shape[len(dims):]) for f in res[:5]),
        res.iterations)
    if not escalate:
        conv = tile_converged(flat, tol)
        report = SolverReport(conv.reshape(dims), res.iterations, 0,
                              int((~conv).sum()))
        record_solver_report(report)
        return res, report
    ref, ref_lead = _ref_tiles(
        None if g_ref is None else as_tensor(g_ref, lead), g)
    v = _drive(v_in, J, spec, lead)
    flat_v = v.reshape(-1, J) if v.dim() > 1 else v
    g_flat = g.reshape(-1, J, K)
    spec_arr = _spec_arr(spec)

    def rerun(idx, prec_e, chain_e, mi_e):
        v_e = flat_v[idx] if flat_v.dim() > 1 else flat_v
        return _solve_core_g(g_flat[idx],
                             ref[_ref_index(ref_lead, tuple(dims), idx)], v_e,
                             spec_arr, mi_e, tol, prec_e, chain_e)

    bres, report = _escalate_failed(flat, rerun, precision, chain_impl,
                                    maxiter, tol)
    out = ShardedSolveResult(
        *(f.reshape(tuple(dims) + f.shape[1:]) for f in bres[:5]),
        bres.iterations, report.n_failed)
    record_solver_report(report)
    return out, report._replace(converged=report.converged.reshape(dims))
