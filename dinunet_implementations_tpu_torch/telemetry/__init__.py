"""Telemetry of the port, the counterpart of the JAX package's
``telemetry/``:

- :mod:`.tracer`: the thread-safe host span tracer (JSONL and Perfetto
  traces) and the ``duration`` helper;
- :mod:`.metrics`: the per-site round metrics a telemetry-on epoch keeps
  (trainer/steps.py) and the engines' modeled wire bytes;
- :mod:`.sink`: the per-fit ``manifest.json``, ``metrics.jsonl`` and trace
  files, with the schema validators;
- :mod:`.report`: ``python -m dinunet_implementations_tpu_torch.telemetry.report``
  renders those artifacts, or checks them with ``--validate``;
- :mod:`.xprof`: ``torch.profiler`` captures over an epoch window and the
  device-kernel summary of a written trace;
- :mod:`.hist`, :mod:`.bus`: mergeable latency histograms and the
  process's metrics bus;
- :mod:`.exporter`: the live endpoints ``/metrics`` (Prometheus text),
  ``/healthz``, ``/statusz`` (with the SLO error-budget burn) and
  ``/tracez``, behind ``--statusz-port`` on the daemon and serving CLIs;
- :mod:`.flight`: the flight recorder, a bounded ring of recent spans and
  events that dumps ``flight_<pid>.json`` (with a final bus snapshot) on
  an unhandled exception or a signal.

The pod plane merges the processes of a supervised run
(runner/supervisor.py) or a fleet scheduler's root:

- :mod:`.collector`: the ``PodCollector`` finds workers by the ``/statusz``
  port their heartbeats advertise, scrapes and merges their bus snapshots
  (counters summed, gauges and histograms stamped ``{process,slice}``) and
  has the bus read API, so one ``StatusExporter`` serves the pod;
- :mod:`.assemble`: ``python -m …telemetry.assemble <pod-dir>`` merges the
  per-process ``trace.jsonl`` files into one clock-aligned Perfetto
  timeline;
- :mod:`.postmortem`: ``python -m …telemetry.postmortem <pod-dir>`` orders
  the flight dumps, heartbeats, liveness spool, consensus decisions and the
  scheduler's ``grants.jsonl`` into one incident timeline; ``--validate``
  checks that the story is complete.
"""

from .bus import NULL_BUS, LabeledBusView, MetricsBus, global_bus, series_key
from .exporter import SLO_BUDGET, StatusExporter, render_prometheus, slo_burn
from .flight import FlightRecorder, flight_files
from .hist import HistogramShapeError, LogHistogram, bucket_bounds
from .tracer import NULL_TRACER, SpanTracer, duration, new_trace_id

__all__ = [
    "NULL_BUS",
    "NULL_TRACER",
    "SLO_BUDGET",
    "FlightRecorder",
    "HistogramShapeError",
    "LabeledBusView",
    "LabelCollisionError",
    "LogHistogram",
    "MetricsBus",
    "PodCollector",
    "SpanTracer",
    "StatusExporter",
    "bucket_bounds",
    "duration",
    "flight_files",
    "global_bus",
    "merge_snapshots",
    "new_trace_id",
    "render_prometheus",
    "series_key",
    "slo_burn",
    "stamp_snapshot",
]


def __getattr__(name):
    # the pod plane loads when first asked for, as the JAX package's does
    if name in ("PodCollector", "LabelCollisionError", "merge_snapshots", "stamp_snapshot"):
        from . import collector

        return getattr(collector, name)
    raise AttributeError(name)
