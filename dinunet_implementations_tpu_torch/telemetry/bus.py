"""MetricsBus: the live-metrics registry, the port's own copy of the JAX
package's ``telemetry/bus.py``.

Named counters, gauges and :class:`~.hist.LogHistogram` latency histograms
that the serving microbatcher, the engine, the publish controller, the
autotuner and the fleet publish into as they run, and that the publish
controller's rollback watch and the autotuner read back.

Contract:

- **Publishing is host-side bookkeeping only.** Every value published comes
  from data the caller already holds on the host (a queue length, a
  wall-clock delta): publishing never synchronizes with the device.
- **Snapshot-consistent reads.** :meth:`MetricsBus.snapshot` copies the
  whole registry under ONE lock acquisition.
- **A NULL bus, not None-checks.** :data:`NULL_BUS` is a disabled instance
  whose methods return immediately; call sites thread a bus object
  unconditionally.
- **Series names are literals**; the variable part goes in label kwargs
  (``bus.counter("serving_requests_total", lane="infer")``).

One process-wide default lives behind :func:`global_bus`: a telemetry-on
trainer, the daemon and the serving CLI publish there when given no bus.
:class:`~.exporter.StatusExporter` serves the bus over HTTP (``/metrics``,
``/statusz``).
"""

from __future__ import annotations

import threading

from .hist import DEFAULT_HI, DEFAULT_LO, DEFAULT_PER_DECADE, LogHistogram


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline). Applied when the series key is BUILT, so arbitrary label
    values — a site name with a quote in it — can never corrupt the
    /metrics exposition (or tear the key apart in a snapshot)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def series_key(name: str, labels: dict) -> str:
    """The rendered series identity: ``name`` or ``name{k="v",...}`` with
    labels sorted — the same (name, labels) always lands on the same key."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return f"{name}{{{inner}}}"


class MetricsBus:
    """See module docstring."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, object] = {}
        self._hists: dict[str, LogHistogram] = {}

    # -- publishing -------------------------------------------------------

    def counter(self, name: str, n=1, **labels) -> None:
        """Monotonic counter increment (``*_total`` naming convention)."""
        if not self.enabled:
            return
        key = series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def gauge(self, name: str, value, **labels) -> None:
        """Point-in-time value (queue depth, current epoch, occupancy)."""
        if not self.enabled:
            return
        key = series_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def clear_gauge(self, name: str, **labels) -> None:
        """Drop a gauge series (a member left; its liveness gauge must not
        linger at its last value)."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges.pop(series_key(name, labels), None)

    def observe(self, name: str, value, *, lo: float = DEFAULT_LO,
                hi: float = DEFAULT_HI,
                per_decade: int = DEFAULT_PER_DECADE, **labels) -> None:
        """One sample into the named log-histogram (created on first use
        with the given shape; conventional unit: milliseconds)."""
        if not self.enabled:
            return
        key = series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LogHistogram(lo, hi, per_decade)
            h.record(value)

    # -- reading ----------------------------------------------------------

    def histogram(self, name: str, **labels) -> LogHistogram | None:
        """A COPY of the named histogram (merge-safe to aggregate further),
        or ``None`` when nothing has been observed into it."""
        with self._lock:
            h = self._hists.get(series_key(name, labels))
            return h.copy() if h is not None else None

    def merged_histogram(self, name: str) -> LogHistogram | None:
        """All label variants of ``name`` merged into one histogram — the
        cross-lane/cross-process rollup the SLO burn reads (merge order is
        irrelevant by the hist's associativity guarantee)."""
        with self._lock:
            parts = [
                h for key, h in self._hists.items()
                if key == name or key.startswith(name + "{")
            ]
            if not parts:
                return None
            out = LogHistogram(
                parts[0].lo, parts[0].hi, parts[0].per_decade
            )
            for h in parts:
                out.merge(h)
            return out

    def snapshot(self) -> dict:
        """Consistent point-in-time copy of every series, JSON-able:
        ``{"counters": {...}, "gauges": {...}, "histograms": {key:
        hist.to_dict()}}``."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: h.to_dict() for k, h in self._hists.items()
                },
            }

    def reset(self) -> None:
        """Drop every series (tests; a bench excluding warmup)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


class LabeledBusView:
    """A :class:`MetricsBus` facade that stamps fixed labels (e.g.
    ``tenant="studyA"``) onto every published series: many publishers share
    one registry, and each series carries its publisher's identity. The
    fixed labels WIN over caller kwargs on collision. Reads delegate
    unfiltered to the underlying bus (label-scoped reads use the label
    kwargs as usual).
    """

    def __init__(self, bus: MetricsBus, **labels):
        self._bus = bus
        self._labels = dict(labels)

    @property
    def enabled(self) -> bool:
        return self._bus.enabled

    @property
    def labels(self) -> dict:
        return dict(self._labels)

    # -- publishing (label-stamped) ---------------------------------------
    # relays: each caller passes a literal name, which the AST lint's R007
    # checks at the call

    def counter(self, name: str, n=1, **labels) -> None:
        self._bus.counter(name, n, **{**labels, **self._labels})  # jaxlint: disable=R007

    def gauge(self, name: str, value, **labels) -> None:
        self._bus.gauge(name, value, **{**labels, **self._labels})  # jaxlint: disable=R007

    def clear_gauge(self, name: str, **labels) -> None:
        self._bus.clear_gauge(name, **{**labels, **self._labels})

    def observe(self, name: str, value, *, lo: float = DEFAULT_LO,
                hi: float = DEFAULT_HI,
                per_decade: int = DEFAULT_PER_DECADE, **labels) -> None:
        self._bus.observe(
            name, value, lo=lo, hi=hi,  # jaxlint: disable=R007
            per_decade=per_decade, **{**labels, **self._labels},
        )

    # -- reading (delegated; label kwargs stamp like publishes) ------------

    def histogram(self, name: str, **labels):
        return self._bus.histogram(name, **{**labels, **self._labels})

    def merged_histogram(self, name: str):
        return self._bus.merged_histogram(name)

    def snapshot(self) -> dict:
        return self._bus.snapshot()

    def reset(self) -> None:
        self._bus.reset()


#: shared disabled instance — thread it where live metrics are off
NULL_BUS = MetricsBus(enabled=False)


#: the process-wide bus a telemetry-on trainer publishes to by default
_GLOBAL_BUS = MetricsBus()


def global_bus() -> MetricsBus:
    return _GLOBAL_BUS
