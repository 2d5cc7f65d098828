"""Per-matrix calibration probes and the structured health report.

Port of ``repro.health.monitor``.  The in-band health signal is a
**calibration probe**: a small fixed batch of known vectors pushed
through the *production* ``cim_mvm`` path of a deployed matrix and
compared against the digital reference ``probes @ W``.  The relative L2
residual over the probe batch is the scalar error stream the drift
detector watches; the residual itself is what the recalibration rung of
the remediation ladder fits its per-output-column gain correction from.

Probe vectors are deterministic per ``(probe_seed, noise_tag)`` — a
numpy ``default_rng`` seeded by the pair, bit-identical to the
reference's.  The residuals and the recalibration fit run in numpy on
the host, as the reference's do.  :class:`MatrixMonitor` computes the
reference product once on the matrix's device, in f32, and keeps no copy
of the weights (at phi3-mini's width the reference's host copies of
every matrix would take 14.5 GB).  What it keeps is 4 * n_probes bytes
an input on the device and an output on the host: with 16 probes,
qwen2-moe-a2.7b's 184 matrices a layer (60 experts x 3, 4 attention
projections) hold 21.7 MB of probes and 19.2 MB of references a
layer, 0.17 and 0.15 GB at 8 layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.health.detector import DetectorConfig, DriftDetector


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Configuration of the serving-health subsystem.

    ``age_per_token`` converts served tokens into drift-clock time
    (t0 units) so ``ServeEngine.generate`` can advance the age from
    simulated reads; 0 leaves the clock under explicit
    ``advance(dt)`` control.
    """

    n_probes: int = 16          # probe vectors per matrix
    probe_seed: int = 0         # probe-constant seed (per-matrix mixed)
    detector: DetectorConfig = dataclasses.field(
        default_factory=DetectorConfig)
    max_reprograms: int = 1     # endurance budget per matrix
    age_per_token: float = 0.0  # simulated-read aging per served token
    recal_limit: float = 20.0   # clamp on the per-column correction

    def __post_init__(self):
        if self.n_probes < 1:
            raise ValueError("n_probes must be >= 1")
        if self.max_reprograms < 0:
            raise ValueError("max_reprograms must be >= 0")


def probe_vectors(cfg: HealthConfig, noise_tag: int,
                  in_dim: int) -> np.ndarray:
    """The fixed (n_probes, in_dim) probe batch of one matrix."""
    rng = np.random.default_rng((cfg.probe_seed, int(noise_tag)))
    return rng.standard_normal((cfg.n_probes, in_dim)).astype(np.float32)


def probe_error(y_cim: np.ndarray, y_ref: np.ndarray) -> float:
    """Relative L2 residual of a probe batch (scalar error signal)."""
    denom = float(np.linalg.norm(y_ref))
    return float(np.linalg.norm(y_cim - y_ref)) / max(denom, 1e-30)


def estimate_recal(y_cim: np.ndarray, y_ref: np.ndarray,
                   limit: float) -> np.ndarray:
    """Per-output-column least-squares gain correction from residuals.

    Fits ``alpha_j`` minimising ``||alpha_j * y_cim[:, j] -
    y_ref[:, j]||``; columns with no probe energy keep 1, and
    corrections are clamped to ``[1/limit, limit]``.
    """
    num = (y_cim * y_ref).sum(axis=0)
    den = (y_cim * y_cim).sum(axis=0)
    alpha = np.where(den > 1e-30, num / np.maximum(den, 1e-30), 1.0)
    return np.clip(alpha, 1.0 / limit, limit).astype(np.float32)


class MatrixMonitor:
    """Probe constants + detector of one matrix.

    ``w`` is the (I, N) weight on its device (any float dtype); the
    reference product ``y_ref = probes @ w`` is taken once there in f32
    and kept on the host, the probes on ``w``'s device (``probes_dev``).
    """

    def __init__(self, cfg: HealthConfig, noise_tag: int,
                 w: torch.Tensor):
        self.probes = probe_vectors(cfg, noise_tag, w.shape[0])
        self.probes_dev = torch.from_numpy(self.probes).to(w.device)
        self.y_ref = (self.probes_dev @ w.to(torch.float32)).cpu().numpy()
        self.detector = DriftDetector(cfg.detector)
        self.last_err: float | None = None

    def observe(self, y_cim: np.ndarray) -> bool:
        """Update the detector with one probe round's residual."""
        self.last_err = probe_error(y_cim, self.y_ref)
        return self.detector.update(self.last_err)


@dataclasses.dataclass
class HealthReport:
    """Structured snapshot of the serving-health subsystem.

    ``counters`` is scrape-friendly (monotonic ints); ``events`` is the
    append-only remediation log, each entry
    ``{"round", "matrix", "event", "detail"}`` with ``event`` one of
    ``trip | recalibrate | reprogram | demote | clear``.  ``flaps``
    counts *spontaneous* detector clear-edges (clears not caused by a
    remediation rearm).
    """

    rounds: int
    counters: dict[str, int]
    matrices: dict[str, dict[str, Any]]
    events: list[dict[str, Any]]

    @property
    def flaps(self) -> int:
        return self.counters.get("spontaneous_clears", 0)

    @property
    def tripped(self) -> list[str]:
        return [n for n, m in self.matrices.items() if m["tripped"]]
