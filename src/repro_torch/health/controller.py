"""The health controller: probe rounds, the remediation ladder, and the
hot-swap bookkeeping.

Port of ``repro.health.controller``.  One :class:`HealthController`
owns the lifetime state of a deployed checkpoint
(:class:`repro_torch.deploy.lifetime.MatrixLifetime` a matrix) and
drives the degradation -> detection -> recovery loop:

* :meth:`advance` moves every live matrix's age clock (the physics:
  aging happens whether or not anyone watches);
* :meth:`probe` pushes each live matrix's calibration probes through the
  production ``cim_mvm``, feeds the residual to its drift detector and,
  on a trip, climbs the ladder: recalibrate (a per-output-column gain
  fitted to this round's residuals), reprogram (a fresh draw, bounded by
  ``max_reprograms``), demote (served digitally for good).

Both return the ``(slot, pname)`` groups whose served deployments
changed; the engines rebuild exactly those
(:func:`repro_torch.deploy.lifetime.restack_group`) and swap them in as
fresh dicts, so a forward holding the previous tree keeps a consistent
bank.

A probe round reads every group in one launch of ``cim_mvm``'s batched
form (:func:`repro_torch.kernels.cim_mvm.ops.cim_mvm_batched`): a group
that is the matrices of one served stacked deployment reads it in place
(the live members by index; an expert bank's R * E experts through its
flat view, member r * E + e), other groups of one shape are stacked,
ragged groups are zero-drive padded to one shape, and groups whose
static meta conflicts, singletons, and probe batches wider than the
batched form's ``DECODE_MAX_M`` rows read one matrix at a time.  Neither engine
reaches the last three: ``deploy_model_params`` always banks, so every
group an engine probes is the matrices of one served stack.  They read
lifetimes built outside the engines, as the parity tests build them
against the reference's vmapped and sequential reads.

Telemetry (``repro_torch.telemetry``, the reference's names): a probe
round observes ``repro_health_probe_round_seconds`` and opens the span
``health/probe_round``; every probe read counts in
``repro_health_probes_total`` and every event in
``repro_health_events_total{event}``.  The round's reads come back to
the host, so the round's time holds the card's work with telemetry on
or off.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.deploy.lifetime import (
    MatrixLifetime,
    group_key,
    pad_host_deployment,
    stack_deployments,
)
from repro_torch.health.monitor import (
    HealthConfig,
    HealthReport,
    MatrixMonitor,
    estimate_recal,
)
from repro_torch.kernels.cim_mvm.ops import (
    DECODE_MAX_M,
    cim_mvm,
    cim_mvm_batched,
)

# Fields whose shapes (and presence) make deployments stackable.
_TENSORS = ("codes", "pos", "scale", "gain", "col_pos", "degraded",
            "noise_tag", "folded")
_META = ("n_bits", "wpt", "cols", "eta", "reversed_df", "sigma_read")

_H_PROBE_ROUND = tm.histogram(
    "repro_health_probe_round_seconds",
    "Wall time of one full probe round (all live matrices).")
_C_PROBES = tm.counter(
    "repro_health_probes_total", "Per-matrix calibration probe reads.")
_C_EVENTS = tm.counter(
    "repro_health_events_total",
    "Health events by kind (trip/clear/recalibrate/reprogram/demote).",
    labels=("event",))


class HealthController:
    """Drives monitoring + self-healing over a deployed checkpoint."""

    def __init__(self, lifetimes: dict[str, MatrixLifetime],
                 cfg: HealthConfig | None = None):
        self.cfg = cfg or HealthConfig()
        self.lifetimes = lifetimes
        self.monitors = {
            name: MatrixMonitor(self.cfg, lt.noise_tag, lt.w)
            for name, lt in lifetimes.items()}
        self.rounds = 0
        self.events: list[dict] = []
        self.counters = {
            "probes": 0, "trips": 0, "spontaneous_clears": 0,
            "recalibrations": 0, "reprograms": 0, "demotions": 0}

    # -- aging ---------------------------------------------------------

    def advance(self, dt: float) -> set[tuple[str, str]]:
        """Advance every live matrix's age; returns dirty swap groups."""
        dirty: set[tuple[str, str]] = set()
        for name, lt in self.lifetimes.items():
            if lt.demoted:
                continue
            lt.advance(dt)
            if lt.model.has_aging:
                dirty.add(group_key(name))
        return dirty

    # -- probing + remediation -----------------------------------------

    def probe(self, read_seed: int | None = None) -> set[tuple[str, str]]:
        """One probe round over every live matrix.

        ``read_seed`` reads the crossbars with per-read noise (each
        matrix with its own tag), as a forward does.  Returns the dirty
        swap groups of every matrix a remediation changed.
        """
        t0 = tm.monotonic()
        with tm.span("health/probe_round", round=self.rounds + 1):
            self.rounds += 1
            live = [(name, lt) for name, lt in self.lifetimes.items()
                    if not lt.demoted]
            results = self._probe_reads(live, read_seed)
            dirty: set[tuple[str, str]] = set()
            for name, lt in live:
                mon = self.monitors[name]
                y = results[name]
                self.counters["probes"] += 1
                _C_PROBES.inc()
                det = mon.detector
                clears_before = det.n_clears
                tripped = mon.observe(y)
                if det.n_clears > clears_before:
                    self.counters["spontaneous_clears"] += (
                        det.n_clears - clears_before)
                    _C_EVENTS.labels(event="clear").inc(
                        det.n_clears - clears_before)
                    self._log(name, "clear", f"z={det.z:.2f}")
                if tripped:
                    self.counters["trips"] += 1
                    _C_EVENTS.labels(event="trip").inc()
                    self._log(name, "trip",
                              f"err={mon.last_err:.4g} z={det.z:.2f} "
                              f"cusum={det.cusum:.4g}")
                    self._remediate(name, lt, mon, y)
                    dirty.add(group_key(name))
        _H_PROBE_ROUND.observe(tm.monotonic() - t0)
        return dirty

    def _probes(self, members: list) -> torch.Tensor:
        return torch.stack([self.monitors[n].probes_dev for n, _ in members])

    def _probe_reads(self, live: list, read_seed: int | None
                     ) -> dict[str, np.ndarray]:
        """Probe currents for every live matrix, one batched launch a
        swap group where the group allows it (module docstring)."""
        groups: dict[tuple[str, str], list] = {}
        for name, lt in live:
            groups.setdefault(group_key(name), []).append((name, lt))
        results: dict[str, np.ndarray] = {}
        batched = self.cfg.n_probes <= DECODE_MAX_M
        for members in groups.values():
            if batched and len(members) > 1:
                bank = members[0][1].bank
                if bank is not None and all(lt.bank is bank
                                            for _, lt in members):
                    ys = self._read(self._probes(members), bank.flat(),
                                    read_seed,
                                    [lt.flat_index for _, lt in members])
                elif self._stackable(members):
                    ys = self._read(
                        self._probes(members),
                        stack_deployments([lt.dep for _, lt in members]),
                        read_seed)
                else:
                    ys = self._padded_probe_reads(members, read_seed)
                if ys is not None:
                    for (name, lt), y in zip(members, ys):
                        results[name] = y[:, :lt.dep.out_dim]
                    continue
            for name, lt in members:
                probes = self.monitors[name].probes_dev
                results[name] = cim_mvm(probes, lt.dep, read_seed,
                                        device=probes.device).cpu().numpy()
        return results

    @staticmethod
    def _read(probes, stacked, read_seed, members=None) -> np.ndarray:
        return cim_mvm_batched(probes, stacked, read_seed, members,
                               device=probes.device).cpu().numpy()

    def _padded_probe_reads(self, members: list, read_seed: int | None
                            ) -> np.ndarray | None:
        """One batched read over a zero-drive-padded ragged group, each
        member's readback to be sliced at its own ``out_dim``; None when
        the group cannot be padded into one stack (static meta or
        optional-field presence conflicts, unequal crossbar rows or
        probe counts)."""
        deps = [lt.dep for _, lt in members]
        d0 = deps[0]
        meta = lambda d: tuple(getattr(d, f) for f in _META)
        if any(meta(d) != meta(d0) for d in deps):
            return None
        for f in ("gain", "col_pos", "degraded", "noise_tag"):
            if len({getattr(d, f) is None for d in deps}) != 1:
                return None
        if len({lt.spec.rows for _, lt in members}) != 1:
            return None
        if len({self.monitors[n].probes_dev.shape[0]
                for n, _ in members}) != 1:
            return None
        rows = members[0][1].spec.rows
        i_pad = max(d.codes.shape[0] for d in deps)
        n_pad = max(d.codes.shape[1] for d in deps)
        in_dim = max(d.in_dim for d in deps)
        out_dim = max(d.out_dim for d in deps)
        padded = [pad_host_deployment(d, i_pad, n_pad, in_dim, out_dim,
                                      rows=rows) for d in deps]
        probes = torch.stack([
            torch.nn.functional.pad(
                self.monitors[n].probes_dev,
                (0, in_dim - self.monitors[n].probes_dev.shape[1]))
            for n, _ in members])
        return self._read(probes, stack_deployments(padded), read_seed)

    def _stackable(self, members: list) -> bool:
        """All group members share probe shape, meta and field shapes."""
        if len({tuple(self.monitors[n].probes_dev.shape)
                for n, _ in members}) != 1:
            return False
        sig = lambda d: (
            tuple(getattr(d, f) for f in _META + ("in_dim", "out_dim")),
            tuple(None if getattr(d, f) is None
                  else tuple(getattr(d, f).shape) for f in _TENSORS))
        return len({sig(lt.dep) for _, lt in members}) == 1

    def _remediate(self, name: str, lt: MatrixLifetime,
                   mon: MatrixMonitor, y_cim: np.ndarray) -> None:
        if lt.rung == 0:
            recal = estimate_recal(y_cim, mon.y_ref, self.cfg.recal_limit)
            lt.recalibrate(recal)
            self.counters["recalibrations"] += 1
            _C_EVENTS.labels(event="recalibrate").inc()
            self._log(name, "recalibrate",
                      f"median_alpha={float(np.median(recal)):.4f} "
                      f"age={lt.age:.3g}")
        elif lt.reprograms < self.cfg.max_reprograms:
            lt.reprogram()
            self.counters["reprograms"] += 1
            _C_EVENTS.labels(event="reprogram").inc()
            self._log(name, "reprogram",
                      f"epoch={lt.reprograms} clock_reset age=1")
        else:
            lt.demote()
            self.counters["demotions"] += 1
            _C_EVENTS.labels(event="demote").inc()
            self._log(name, "demote",
                      f"endurance_exhausted reprograms={lt.reprograms}"
                      f" -> digital fallback")
        mon.detector.rearm()

    def _log(self, matrix: str, event: str, detail: str) -> None:
        self.events.append({"round": self.rounds, "matrix": matrix,
                            "event": event, "detail": detail})

    # -- reporting -----------------------------------------------------

    def report(self) -> HealthReport:
        matrices = {}
        for name, lt in self.lifetimes.items():
            mon = self.monitors[name]
            matrices[name] = {
                **mon.detector.state(),
                "last_err": mon.last_err,
                "age": lt.age,
                "rung": lt.rung,
                "reprograms": lt.reprograms,
                "demoted": lt.demoted,
            }
        return HealthReport(rounds=self.rounds,
                            counters=dict(self.counters),
                            matrices=matrices,
                            events=list(self.events))
