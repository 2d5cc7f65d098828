"""Process-global metrics of the port: counters, gauges, histograms,
exposition, and the port's clocks and device sync.

Port of ``repro.telemetry.metrics``, stdlib only but for the lazy
``torch`` of :func:`sync` (``python -m repro_torch.telemetry.report``
imports this module and stays light).  The registry is the port's own
object: the reference's ``repro.telemetry.registry()`` never holds a
port metric, and the port's metric names are the reference's letter
for letter, so either package's exposition reads the same.  The same
three rules hold:

1. **Disabled is free.**  Telemetry is off unless ``REPRO_TELEMETRY``
   is set truthy or :func:`enable` was called; the unlabeled
   ``inc()``/``observe()``/``set()`` fast path is then a single global
   flag test and an immediate return (no allocation, no lock).
2. **Host boundaries only.**  Instrumented call sites record host
   values.  Telemetry-only code waits on the card through :func:`sync`
   alone, and only under :func:`enabled`, so with telemetry off no path
   gains a sync, a host copy or an allocation.
3. **Deterministic.**  No generator, no wall clock inside metric values
   (durations come from the caller's :func:`monotonic` reads), and both
   exposition formats sort by name and label values.

Metric names follow Prometheus conventions, prefixed ``repro_``:
``repro_<subsystem>_<what>_<unit>`` with ``_total`` for counters and
``_seconds`` for latency histograms (docs/observability.md).
"""
from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time

# The port's two clocks, its only raw ones: monotonic, high-resolution
# and unaffected by wall-clock jumps for durations; ``wall_time`` for
# timestamps, never for durations.
monotonic = time.perf_counter  # reprolint: disable=RPL006 -- the port's one duration clock; its library code times through this alias
wall_time = time.time  # reprolint: disable=RPL006 -- the port's one timestamp clock; its library code stamps through this alias


def sync(device) -> None:
    """Wait for ``device`` (a ``torch.device`` or its name) to drain its
    queue: ``torch.cuda.synchronize`` on a CUDA device, nothing on the
    CPU.  The only way telemetry-only code waits on the card; call it
    only under :func:`enabled`."""
    if getattr(device, "type", str(device).split(":")[0]) == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _env_enabled() -> bool:
    v = os.environ.get("REPRO_TELEMETRY", "")
    return v.strip().lower() not in ("", "0", "false", "off", "no")


class _State:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    """Is telemetry collection on for this process?"""
    return _STATE.enabled


def enable() -> None:
    """Turn collection on (overrides the ``REPRO_TELEMETRY`` env)."""
    _STATE.enabled = True


def disable() -> None:
    """Turn collection off; every record call becomes a no-op."""
    _STATE.enabled = False


_NAME_RE = re.compile(r"[a-z][a-z0-9_]*$")

# Latency buckets (seconds): geometric-ish 100us..60s, suiting both a
# sub-ms decode step and a multi-second cold deploy.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0)


class _NoopChild:
    """Shared do-nothing ``labels()`` result while telemetry is off."""

    __slots__ = ()

    def inc(self, v=1.0):
        pass

    def dec(self, v=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


_NOOP = _NoopChild()


class _Bound:
    """One metric child bound to concrete label values."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, v=1.0):
        if _STATE.enabled:
            self._metric._record(self._key, float(v))

    def dec(self, v=1.0):
        if _STATE.enabled:
            self._metric._record(self._key, -float(v))

    def set(self, v):
        if _STATE.enabled:
            self._metric._set(self._key, float(v))

    def observe(self, v):
        if _STATE.enabled:
            self._metric._record(self._key, float(v))


class _Metric:
    """Common shape: name, help, label schema, per-label-tuple state."""

    kind = ""

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r} (want "
                             f"lowercase [a-z0-9_], e.g. repro_x_total)")
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Bound] = {}
        self._init_state()

    def _init_state(self):
        raise NotImplementedError

    def labels(self, **kv):
        """Child bound to one label-value combination.

        While disabled this returns a shared no-op child without
        touching any state — take labels at *use* time, not at import
        time, so a later :func:`enable` is honoured.
        """
        if not _STATE.enabled:
            return _NOOP
        if set(kv) != set(self.label_names):
            raise ValueError(f"{self.name}: labels {sorted(kv)} != "
                             f"declared {sorted(self.label_names)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key,
                                                  _Bound(self, key))
        return child

    # -- state ops (post-enabled-check; subclasses fill in) ------------

    def _record(self, key, v):
        raise NotImplementedError

    def _set(self, key, v):
        raise NotImplementedError("only gauges support set()")


class Counter(_Metric):
    kind = "counter"

    def _init_state(self):
        self._values: dict[tuple, float] = (
            {(): 0.0} if not self.label_names else {})

    def inc(self, v=1.0):
        if not _STATE.enabled:
            return
        self._record((), float(v))

    def _record(self, key, v):
        if v < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def _reset(self):
        with self._lock:
            self._values = {(): 0.0} if not self.label_names else {}


class Gauge(_Metric):
    kind = "gauge"

    def _init_state(self):
        self._values: dict[tuple, float] = (
            {(): 0.0} if not self.label_names else {})

    def set(self, v):
        if not _STATE.enabled:
            return
        self._set((), float(v))

    def inc(self, v=1.0):
        if not _STATE.enabled:
            return
        self._record((), float(v))

    def dec(self, v=1.0):
        if not _STATE.enabled:
            return
        self._record((), -float(v))

    def _record(self, key, v):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def _set(self, key, v):
        with self._lock:
            self._values[key] = v

    def _reset(self):
        with self._lock:
            self._values = {(): 0.0} if not self.label_names else {}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=None):
        self.buckets = tuple(sorted(float(b) for b in
                                    (DEFAULT_BUCKETS if buckets is None
                                     else buckets)))
        if not self.buckets:
            raise ValueError(f"{name}: need at least one bucket bound")
        super().__init__(name, help, labels)

    def _init_state(self):
        # label key -> [per-bucket counts (+Inf last), sum, count]
        self._data: dict[tuple, list] = {}
        if not self.label_names:
            self._data[()] = self._fresh()

    def _fresh(self):
        return [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, v):
        if not _STATE.enabled:
            return
        self._record((), float(v))

    def _record(self, key, v):
        with self._lock:
            st = self._data.get(key)
            if st is None:
                st = self._data[key] = self._fresh()
            st[0][bisect.bisect_left(self.buckets, v)] += 1
            st[1] += v
            st[2] += 1

    def _reset(self):
        with self._lock:
            self._data = {}
            if not self.label_names:
                self._data[()] = self._fresh()


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _label_str(names, values, extra=()) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{v}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricsRegistry:
    """Named metric set with Prometheus-text and JSON exposition.

    Registration is strict: a name registers exactly once, with the
    kind/labels fixed at declaration.  The process-global default
    registry lives in this module (:func:`registry`); tests construct
    their own instances.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, m: _Metric) -> _Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(
                    f"metric {m.name!r} already registered as "
                    f"{self._metrics[m.name].kind}; metric names "
                    f"register exactly once (AUD007)")
            self._metrics[m.name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter(name, help, tuple(labels)))

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge(name, help, tuple(labels)))

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets=None) -> Histogram:
        return self._register(
            Histogram(name, help, tuple(labels), buckets))

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> frozenset[str]:
        return frozenset(self._metrics)

    def reset(self) -> None:
        """Zero every value; registrations (and children) survive."""
        for m in self._metrics.values():
            m._reset()

    # -- exposition ----------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key in sorted(m._data):
                    counts, total, n = m._data[key]
                    cum = 0
                    for le, c in zip(m.buckets, counts):
                        cum += c
                        out.append(
                            f"{name}_bucket"
                            f"{_label_str(m.label_names, key, [('le', _fmt(le))])}"
                            f" {cum}")
                    out.append(
                        f"{name}_bucket"
                        f"{_label_str(m.label_names, key, [('le', '+Inf')])}"
                        f" {cum + counts[-1]}")
                    ls = _label_str(m.label_names, key)
                    out.append(f"{name}_sum{ls} {_fmt(total)}")
                    out.append(f"{name}_count{ls} {n}")
            else:
                for key in sorted(m._values):
                    out.append(f"{name}"
                               f"{_label_str(m.label_names, key)} "
                               f"{_fmt(m._values[key])}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """Plain-JSON snapshot, sorted by name and label values."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry: dict = {"kind": m.kind, "help": m.help}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["values"] = [
                    {"labels": dict(zip(m.label_names, key)),
                     "counts": list(m._data[key][0]),
                     "sum": m._data[key][1],
                     "count": m._data[key][2]}
                    for key in sorted(m._data)]
            else:
                entry["values"] = [
                    {"labels": dict(zip(m.label_names, key)),
                     "value": m._values[key]}
                    for key in sorted(m._values)]
            out[name] = entry
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _REGISTRY


def counter(name: str, help: str = "",
            labels: tuple[str, ...] = ()) -> Counter:
    """Register a counter on the default registry (module-level use)."""
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: tuple[str, ...] = ()) -> Gauge:
    """Register a gauge on the default registry (module-level use)."""
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: tuple[str, ...] = (), buckets=None) -> Histogram:
    """Register a histogram on the default registry."""
    return _REGISTRY.histogram(name, help, labels, buckets)
