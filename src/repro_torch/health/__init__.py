"""Serving-lifetime health of the port: monitoring, drift detection,
self-healing (port of ``repro.health``).

==================  ===================================================
piece               entry points
==================  ===================================================
drift detection     :mod:`repro_torch.health.detector` —
                    :class:`DriftDetector` (EWMA + CUSUM/z-score with
                    hysteresis), :class:`DetectorConfig`
calibration probes  :mod:`repro_torch.health.monitor` — fixed
                    per-matrix probe batches through the production
                    ``cim_mvm`` against the digital reference;
                    :class:`HealthConfig`, :class:`HealthReport`
remediation ladder  :mod:`repro_torch.health.controller` —
                    :class:`HealthController`: on a trip, recalibrate
                    -> reprogram (endurance-bounded) -> demote, over
                    :mod:`repro_torch.deploy.lifetime`
==================  ===================================================

Both engines serve it: pass ``health=HealthConfig(...)`` (with a
non-ideal ``nonideal`` model) to ``ServeEngine`` or ``ContinuousEngine``,
then drive ``engine.advance(dt)`` / ``engine.check_health()``; refreshed
deployments are swapped in as fresh dicts, one group at a time, never
mutated in place.
"""
from repro_torch.health.controller import HealthController  # noqa: F401
from repro_torch.health.detector import (  # noqa: F401
    DetectorConfig,
    DriftDetector,
)
from repro_torch.health.monitor import (  # noqa: F401
    HealthConfig,
    HealthReport,
    MatrixMonitor,
    estimate_recal,
    probe_error,
    probe_vectors,
)

__all__ = [
    "DetectorConfig", "DriftDetector",
    "HealthConfig", "HealthReport", "MatrixMonitor",
    "HealthController",
    "estimate_recal", "probe_error", "probe_vectors",
]
