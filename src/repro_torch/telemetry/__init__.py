"""repro_torch.telemetry: the port's observability layer.

Port of ``repro.telemetry``: one lightweight layer carries the three
signals across the port's deploy -> solve -> serve -> heal -> train
pipeline (docs/observability.md's "What is instrumented", by the same
metric and span names):

* **metrics**: a process-global :class:`MetricsRegistry` of counters,
  gauges and histograms with labels and Prometheus-text / JSON
  exposition (:mod:`repro_torch.telemetry.metrics`);
* **traces**: nested :func:`span` context managers written as JSONL in
  the reference's schema, summarised by
  ``python -m repro_torch.telemetry.report``
  (:mod:`repro_torch.telemetry.trace`, :mod:`repro_torch.telemetry.report`);
* **clocks and the card**: :func:`monotonic` (durations),
  :func:`wall_time` (timestamps), the port's only clocks, and
  :func:`sync`, the only way telemetry-only code waits on the card.

Collection is **off by default** and costs nothing while off: set
``REPRO_TELEMETRY=1`` (or call :func:`enable`) to collect, and
``REPRO_TRACE=path.jsonl`` (or :func:`trace_to`) to also record spans.
Instrumented code records at host boundaries only, syncs the card only
while telemetry is on, and never touches a generator, so turning
telemetry on changes no computed value.
"""
from repro_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    histogram,
    monotonic,
    registry,
    sync,
    wall_time,
)
from repro_torch.telemetry.trace import (  # noqa: F401
    span,
    trace_path,
    trace_stop,
    trace_to,
    tracing,
)
