"""Per-matrix lifetime state for serving-time aging and self-healing.

Port of ``repro.deploy.lifetime``.  A deployment is a snapshot of the
device at programming time; conductances keep moving while the chip
serves (power-law drift and stochastic relaxation,
:class:`repro_torch.nonideal.NonidealModel` ``drift_factor_at`` /
``relax_sigma_at``), so a long-lived engine needs the trajectory.
:class:`MatrixLifetime` keeps what the trajectory is a function of, and
the remediation ladder of :mod:`repro_torch.health` is three transitions
on it: :meth:`~MatrixLifetime.recalibrate` (a per-output-column gain
correction), :meth:`~MatrixLifetime.reprogram` (fresh variation and
relaxation, stuck cells pinned, the drift clock reset) and
:meth:`~MatrixLifetime.demote` (the runtime ``degraded`` sentinel: the
model serves the matrix digitally).

**No cell draws are held.**  The reference keeps each matrix's logical
stuck, gamma and relaxation fields on the host (at phi3-mini's width
gamma and relax alone would be 232 GB).  Here a refresh draws the cells
again on the device from (key, traversal index, reprogram count)
(:func:`repro_torch.nonideal.inject.matrix_cells`,
:func:`~repro_torch.nonideal.inject.reprogram_cells`), one matrix at a
time, gathers them through the plan (read back from the served ``pos``
and ``col_pos``), evaluates :func:`~repro_torch.nonideal.inject.
aged_gain_host` at the matrix's age, multiplies in the recalibration and
folds W' * gain with the fold kernel.  The post-stuck codes are the
served bank's.

**Refreshes land in the bank.**  A matrix served from a stacked bank
(``bank``, at ``rep``: its repeat, or its repeat and expert in an MoE
expert bank) is refreshed by :func:`restack_group`, which builds the
group's next stacked deployment (fresh ``gain``, ``folded`` and
``degraded``; the codes, positions and scale shared with the old one,
which nobody mutates), one fold launch a refreshed member; the engines
swap it in as a fresh dict.  Until then the ladder only marks
the matrix ``stale``.  A matrix with no bank (a hand-built lifetime) is
refreshed at once into its own deployment.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.tiling import CrossbarSpec
from repro_torch.kernels.cim_mvm.ops import CimDeployment, fold, fold_weights
from repro_torch.nonideal.inject import (
    HostCells,
    aged_gain_host,
    gather_physical_host,
    has_faults,
    matrix_cells,
    matrix_stuck,
    reprogram_cells,
)
from repro_torch.nonideal.models import NonidealModel

# Runtime-demotion sentinel for CimDeployment.degraded: negative so it
# never collides with the positive open-bit counts of a deploy-time
# demotion (the model demotes on ``degraded != 0`` either way).
DEMOTED_RUNTIME = -1

# Logical rows a refresh evaluates at once (the deploy's injection step).
_GAIN_ROWS = 256


def _untimed(stage: str):
    """The no-op stage clock (``deploy.engine.StageClock``'s stand-in)."""
    return contextlib.nullcontext()


@dataclasses.dataclass
class MatrixLifetime:
    """Lifetime state of one deployed matrix.

    ``dep`` is the served deployment (``bank.member(rep)`` for a banked
    matrix, ``rep`` its index into the bank: (repeat,) or (repeat,
    expert)); ``noise_tag`` is its traversal index, its read-noise tag and
    the index its cells are drawn by under ``key``; ``w`` is a view of
    the served parameter (the probes' digital reference).  ``cells``:
    the deploy's physical cells where they were given rather than drawn
    (a test seam).  ``draws``: a test hook that replaces the re-draw —
    reprogram count n -> the logical (stuck_log, gamma_log, relax_log)
    fields, (I_pad, N_pad, K) or None.  ``age`` is time since
    (re)programming in units of t0 (1.0 = fresh).
    """

    name: str
    noise_tag: int
    spec: CrossbarSpec
    model: NonidealModel
    eta: float
    key: int
    w: torch.Tensor
    dep: CimDeployment
    bank: CimDeployment | None = None
    rep: tuple[int, ...] = (0,)
    cells: HostCells | None = None
    draws: Callable[[int], tuple] | None = None
    age: float = 1.0
    reprograms: int = 0
    rung: int = 0                      # 0 = fresh, 1 = recalibrated
    recal: torch.Tensor | None = None  # (N_pad,) per-column correction
    demoted: bool = False
    stale: bool = False                # the served gain is out of date

    # -- aging ---------------------------------------------------------

    def advance(self, dt: float) -> None:
        """Advance this matrix's age clock by ``dt`` (t0 units)."""
        self.age += float(dt)
        if self.model.has_aging:
            self._changed()

    def _changed(self) -> None:
        self.stale = True
        if self.bank is None:
            self.refresh()

    @property
    def flat_index(self) -> int:
        """This matrix's member of its bank's flat view
        (``CimDeployment.flat``): r, or r * E + e for an expert."""
        lead = self.bank.scale.shape
        return sum(i * math.prod(lead[k + 1:])
                   for k, i in enumerate(self.rep))

    @property
    def grid(self) -> tuple[int, int]:
        i_pad, n_pad = self.dep.codes.shape
        return i_pad // self.spec.rows, n_pad // self.dep.wpt

    def physical_cells(self) -> HostCells:
        """The physical cells after ``reprograms`` reprograms, drawn on
        the deployment's device (or the deploy's ``cells``)."""
        dev = self.dep.codes.device
        args = (self.key, self.noise_tag)
        if self.reprograms == 0:
            return self.cells if self.cells is not None else matrix_cells(
                *args, self.grid, self.spec, self.model, dev)
        if self.cells is not None:
            stuck = self.cells.stuck
        elif has_faults(self.model):
            stuck = matrix_stuck(*args, self.grid, self.spec, self.model, dev)
        else:
            stuck = None
        return reprogram_cells(*args, self.reprograms, self.grid, self.spec,
                               self.model, stuck, dev)

    def gain_into(self, out: torch.Tensor, clock=_untimed) -> None:
        """The gain at the current age, times the recalibration, into
        ``out`` (I_pad, N_pad) f32: the cells drawn again ("draw"), then
        gathered and aged a few tiles of rows at a time ("gain")."""
        dep, K = self.dep, self.spec.n_bits
        with clock("draw"):
            if self.draws is not None:
                logs = self.draws(self.reprograms)
                log = lambda f, sl: None if f is None else f[sl]
            else:
                logs = self.physical_cells()
                ti, tn = self.grid
                row_position = dep.pos.reshape(ti, self.spec.rows,
                                               tn).transpose(1, 2)
                log = lambda f, sl: None if f is None else \
                    gather_physical_host(f, row_position, dep.reversed_df,
                                         self.spec, dep.col_pos, sl)
        with clock("gain"):
            for r0 in range(0, dep.codes.shape[0], _GAIN_ROWS):
                sl = slice(r0, r0 + _GAIN_ROWS)
                out[sl] = aged_gain_host(
                    dep.codes[sl].to(torch.int32).abs(), log(logs[0], sl),
                    log(logs[1], sl), log(logs[2], sl), K, self.model,
                    self.age)
            if self.recal is not None:
                out.mul_(self.recal)

    def refresh(self, clock=_untimed) -> CimDeployment:
        """Re-derive the served deployment at the current age into a
        deployment of its own (re-folded), unless demoted."""
        if self.demoted:
            return self.dep
        gain = torch.empty(self.dep.codes.shape, dtype=torch.float32,
                           device=self.dep.codes.device)
        self.gain_into(gain, clock)
        with clock("fold"):
            self.dep = fold(dataclasses.replace(self.dep, gain=gain))
        self.bank, self.stale = None, False
        return self.dep

    # -- remediation ladder --------------------------------------------

    def recalibrate(self, recal: np.ndarray) -> CimDeployment:
        """Fold a per-output-column gain correction (out_dim,) into the
        deployment (padding columns get 1); it persists across refreshes
        until the next reprogram."""
        n_pad = self.dep.codes.shape[1]
        full = np.ones(n_pad, np.float32)
        full[:recal.shape[0]] = np.asarray(recal, np.float32)
        self.recal = torch.from_numpy(full).to(self.dep.codes.device)
        self.rung = 1
        self._changed()
        return self.dep

    def reprogram(self) -> CimDeployment:
        """Re-inject with fresh variation and relaxation (stuck cells
        pinned), reset the drift clock and drop the recalibration."""
        self.reprograms += 1
        self.age = 1.0
        self.recal = None
        self.rung = 0
        self._changed()
        return self.dep

    def demote(self) -> CimDeployment:
        """Demote to the digital fallback (runtime ``degraded``
        sentinel)."""
        self.demoted = True
        self.dep = dataclasses.replace(
            self.dep, degraded=torch.tensor(DEMOTED_RUNTIME,
                                            dtype=torch.int32))
        return self.dep


def pad_host_deployment(dep: CimDeployment, i_pad: int, n_pad: int,
                        in_dim: int, out_dim: int, *,
                        rows: int) -> CimDeployment:
    """Zero-drive pad a deployment to a larger tile grid (on its device):
    zero codes, identity positions and column layouts, gain 1 and a zero
    fold on the new tiles, ``in_dim`` / ``out_dim`` rewritten, so that
    ragged members of one group read in one batched launch.  Zero codes
    program no bits, so the padded tiles add nothing to the original
    outputs; with read noise the padded read draws the same noise on the
    original weights (a function of (seed, tag, i, n))."""
    i0, n0 = dep.codes.shape
    tn0 = dep.pos.shape[1]
    if (i_pad - i0) % rows or (n_pad - n0) % dep.wpt:
        raise ValueError("padding must be whole tiles")
    dev = dep.codes.device
    tn = n_pad // dep.wpt
    codes = torch.zeros((i_pad, n_pad), dtype=torch.int16, device=dev)
    codes[:i0, :n0] = dep.codes
    pos = (torch.arange(i_pad, dtype=torch.int32, device=dev) % rows)[
        :, None].repeat(1, tn)
    pos[:i0, :tn0] = dep.pos
    gain = dep.gain
    if gain is not None:
        gain = torch.ones((i_pad, n_pad), dtype=torch.float32, device=dev)
        gain[:i0, :n0] = dep.gain
    col_pos = dep.col_pos
    if col_pos is not None:
        ti0, tn_c0 = col_pos.shape[:2]
        col_pos = torch.arange(dep.cols, dtype=torch.int32, device=dev)[
            None, None].repeat(i_pad // rows, tn, 1)
        col_pos[:ti0, :tn_c0] = dep.col_pos
    out = dataclasses.replace(dep, codes=codes, pos=pos, gain=gain,
                              col_pos=col_pos, in_dim=in_dim,
                              out_dim=out_dim)
    if dep.folded is not None:
        ld = -(-n_pad // 8) * 8
        out.folded = torch.zeros((i_pad, ld), dtype=torch.float32,
                                 device=dev)
        out.folded[:i0, :n0] = dep.folded[:, :n0]
    return out


def group_key(name: str) -> tuple[str, str]:
    """(slot, pname) stacking group of a deployed-matrix name."""
    parts = name.split("/")
    return parts[0], parts[1]


def bank_index(name: str) -> tuple[str, str, tuple[int, ...]]:
    """(slot, param, index into the stacked bank) of a matrix name
    ``slot/param/r``, or ``slot/param/r/e{k}`` for an expert: (r,) or
    (r, k)."""
    slot, pname, r, *sub = name.split("/")
    return slot, pname, (int(r),) + tuple(int(e[1:]) for e in sub)


def stack_deployments(deps: list[CimDeployment]) -> CimDeployment:
    """One stacked deployment (a leading member axis on every tensor,
    ``folded`` included: each member is folded where it is not) from
    deployments of one shape and meta."""
    d0 = deps[0]
    st = lambda f: None if getattr(d0, f) is None else torch.stack(
        [getattr(d, f) for d in deps])
    out = dataclasses.replace(
        d0, **{f: st(f) for f in ("codes", "pos", "scale", "gain",
                                  "col_pos", "degraded", "noise_tag")})
    out.folded = torch.stack([d.folded if d.folded is not None
                              else fold_weights(d) for d in deps])
    return out


def restack_group(lifetimes: dict[str, MatrixLifetime], slot: str,
                  pname: str, clock=_untimed) -> CimDeployment:
    """The next stacked deployment of one (slot, pname) group.

    Every member must be a matrix of one served stacked deployment, at
    the index its name gives: the repeats of a dense bank
    (``slot/pname/r``), or the repeats and experts of an MoE expert bank
    (``slot/pname/r/e{k}``, the reference's nested case).  The result
    shares the old one's codes, positions, scale, column layouts and
    noise tags; its ``degraded`` marks the demoted members; where a
    member is stale its ``gain`` and ``folded`` are fresh tensors with
    that member refreshed (:meth:`MatrixLifetime.gain_into`, then one
    fold launch of its view), else they are the old ones.  The old
    deployment is not mutated, so the caller swaps the result in as a
    fresh dict and a forward holding the old tree keeps a consistent
    bank.  Members are re-pointed at the result's views.  ``clock`` (a
    :class:`repro_torch.deploy.engine.StageClock`) times the stages
    "draw", "gain" and "fold".
    """
    members = [lt for n, lt in lifetimes.items()
               if group_key(n) == (slot, pname)]
    old = members[0].bank if members else None
    if old is None or any(lt.bank is not old
                          or bank_index(lt.name)[2] != lt.rep
                          or len(lt.rep) != old.scale.ndim
                          for lt in members):
        raise ValueError(f"restack_group: {slot}/{pname} is not the "
                         "matrices of one served stacked deployment")
    new = dataclasses.replace(old)
    new.device_tags = old.device_tags
    new.degraded = (old.degraded.clone() if old.degraded is not None
                    else torch.zeros(old.scale.shape, dtype=torch.int32))
    for lt in members:
        if lt.demoted:
            new.degraded[lt.rep] = DEMOTED_RUNTIME
    stale = [lt for lt in members if lt.stale and not lt.demoted]
    new.folded = old.folded
    if stale:
        new.gain, new.folded = old.gain.clone(), old.folded.clone()
        for lt in stale:
            lt.gain_into(new.gain[lt.rep], clock)
            with clock("fold"):
                new.folded[lt.rep] = fold_weights(new.member(lt.rep))
    for lt in members:
        lt.bank, lt.dep, lt.stale = new, new.member(lt.rep), False
    return new
