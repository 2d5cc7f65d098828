"""EWMA + CUSUM/z-score drift detection with hysteresis.

Port of ``repro.health.detector``, plain Python: the arithmetic is the
reference's, so a detector trips and clears on the same observation.

One :class:`DriftDetector` watches one scalar error stream — the
per-matrix probe error the health monitor produces — and answers a
single question per observation: *has this matrix drifted away from its
healthy baseline?*  Three classical pieces compose:

* an **EWMA tracker** smooths the per-probe error (probe error is noisy
  under per-read conductance noise; a raw threshold on single probes
  would trip on noise spikes);
* a **z-score** of the EWMA against the learned baseline (mean + std
  of the first ``warmup`` probes, refined over a bounded healthy
  window — see below — with a floor on the std so a noiseless baseline
  does not make the detector infinitely sensitive) catches sustained
  level shifts;
* a **one-sided CUSUM** ``S = max(0, S + (err - mu0 - k*sigma0))``
  accumulates small persistent exceedances that never individually
  clear the z threshold — the classical drift (slow ramp) detector.

**Hysteresis contract.**  Trip and clear use *separated* thresholds:
the detector trips when ``z >= z_trip`` or ``S >= h * sigma0`` and,
once tripped, reports tripped until the EWMA z-score falls back below
``z_clear`` (``z_clear < z_trip``, enforced).  An error level that sits
exactly at the trip threshold therefore trips once and stays tripped —
it cannot flap trip/clear/trip — and a remediation that actually fixed
the matrix clears it promptly because the EWMA falls well below
``z_clear``.  After a remediation the controller calls :meth:`rearm`,
which zeroes the CUSUM and the trip latch but keeps the learned
baseline (the reference "healthy" level of this matrix does not change
when the device is refreshed).

**Bounded baseline refinement.**  A baseline frozen at ``warmup``
observations carries the warmup's sampling error forever: a mean
underestimated by half a sigma turns the CUSUM's negative drift into a
near-zero one and the in-control average run length collapses (false
trips on perfectly stationary streams).  The detector therefore keeps
folding *demonstrably healthy* observations (z below ``z_clear``,
CUSUM below half its threshold, not tripped) into the Welford baseline
until ``baseline_window * warmup`` total observations — long enough to
shrink the estimation error, bounded so a slow real drift cannot be
absorbed into the reference indefinitely.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Thresholds of one drift detector (hashable, shareable).

    All thresholds are in units of the baseline std ``sigma0``; the
    baseline itself is learned from the first ``warmup`` observations,
    during which the detector never trips.
    """

    ewma_alpha: float = 0.3    # EWMA smoothing (1 = raw errors)
    warmup: int = 8            # observations to learn (mu0, sigma0)
    z_trip: float = 8.0        # trip when EWMA z-score reaches this
    z_clear: float = 2.0       # clear only when z falls below this
    cusum_k: float = 1.0       # CUSUM slack, in sigma0
    cusum_h: float = 12.0      # CUSUM trip threshold, in sigma0
    min_sigma: float = 1e-4    # absolute floor on sigma0
    min_rel_sigma: float = 0.02  # floor on sigma0 relative to mu0
    baseline_window: int = 4   # refine baseline until this x warmup
                               # observations (1 = freeze at warmup)

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.warmup < 2:
            raise ValueError("warmup must be >= 2")
        if self.baseline_window < 1:
            raise ValueError("baseline_window must be >= 1")
        if not self.z_clear < self.z_trip:
            raise ValueError(
                "hysteresis requires z_clear < z_trip (separated "
                "thresholds are what prevents trip/clear flapping)")


class DriftDetector:
    """Stateful per-matrix drift detector (see module docstring)."""

    def __init__(self, config: DetectorConfig | None = None):
        self.config = config or DetectorConfig()
        self.n = 0            # observations seen
        self.mu0 = 0.0        # baseline mean (Welford, healthy window)
        self._m2 = 0.0
        self._n_base = 0      # observations folded into the baseline
        self.sigma0 = 0.0
        self.ewma = 0.0
        self.cusum = 0.0
        self.tripped = False
        self.n_trips = 0      # trip *edges* (False -> True transitions)
        self.n_clears = 0     # clear edges (True -> False transitions)
        self._reinit_ewma = False

    @property
    def warmed_up(self) -> bool:
        return self.n >= self.config.warmup

    @property
    def z(self) -> float:
        """Current EWMA z-score against the warmup baseline."""
        if not self.warmed_up:
            return 0.0
        return (self.ewma - self.mu0) / self._sigma()

    def _sigma(self) -> float:
        c = self.config
        return max(self.sigma0, c.min_sigma,
                   c.min_rel_sigma * abs(self.mu0))

    def update(self, err: float) -> bool:
        """Observe one probe error; returns the post-update trip state."""
        err = float(err)
        c = self.config
        self.n += 1
        if self.n == 1 or self._reinit_ewma:
            self.ewma = err
            self._reinit_ewma = False
        else:
            self.ewma = (c.ewma_alpha * err
                         + (1.0 - c.ewma_alpha) * self.ewma)
        if self.n <= c.warmup:
            # Baseline learning (Welford); the detector cannot trip yet.
            self._fold_baseline(err)
            if self.n == c.warmup:
                self.sigma0 = (self._m2 / (self._n_base - 1)) ** 0.5
            return False
        sigma = self._sigma()
        z = (self.ewma - self.mu0) / sigma
        # Bounded refinement: demonstrably healthy observations keep
        # shrinking the warmup's estimation error (a frozen mu0 off by
        # half a sigma destroys the CUSUM's in-control run length).
        if (not self.tripped
                and self.n <= c.baseline_window * c.warmup
                and z < c.z_clear
                and self.cusum < 0.5 * c.cusum_h * sigma):
            self._fold_baseline(err)
            self.sigma0 = (self._m2 / (self._n_base - 1)) ** 0.5
            sigma = self._sigma()
            z = (self.ewma - self.mu0) / sigma
        self.cusum = max(
            0.0, self.cusum + (err - self.mu0 - c.cusum_k * sigma))
        if not self.tripped:
            if z >= c.z_trip or self.cusum >= c.cusum_h * sigma:
                self.tripped = True
                self.n_trips += 1
        else:
            if z <= c.z_clear:
                self.tripped = False
                self.n_clears += 1
                self.cusum = 0.0
        return self.tripped

    def _fold_baseline(self, err: float) -> None:
        self._n_base += 1
        d = err - self.mu0
        self.mu0 += d / self._n_base
        self._m2 += d * (err - self.mu0)

    def rearm(self) -> None:
        """Reset the trip latch + CUSUM after a remediation.

        The learned baseline is kept: remediation restores the device
        toward the healthy level the baseline describes, and relearning
        it from post-remediation probes would slowly ratchet the
        reference upward with every partially-successful repair.  The
        EWMA restarts from the next observation — the remediation
        changed the device, so smoothing the new error stream into the
        pre-repair level would hold the z-score high for several rounds
        and falsely re-trip a repair that worked.
        """
        self.tripped = False
        self.cusum = 0.0
        self._reinit_ewma = True
        # Rearming is a controller action, not a spontaneous clear —
        # it does not count toward the clear-edge counter the flapping
        # check audits.

    def state(self) -> dict:
        """Scrape-friendly counters/gauges for the health report."""
        return {
            "n": self.n,
            "ewma": self.ewma,
            "mu0": self.mu0,
            "sigma0": self._sigma() if self.warmed_up else None,
            "z": self.z,
            "cusum": self.cusum,
            "tripped": self.tripped,
            "n_trips": self.n_trips,
            "n_clears": self.n_clears,
        }
