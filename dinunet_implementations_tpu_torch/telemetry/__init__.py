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

The pod plane (the pod collector, the trace assembler and the post-mortem)
is ROADMAP A19 (b): it reads the supervisor's and the scheduler's files.
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
    "LogHistogram",
    "MetricsBus",
    "SpanTracer",
    "StatusExporter",
    "bucket_bounds",
    "duration",
    "flight_files",
    "global_bus",
    "new_trace_id",
    "render_prometheus",
    "series_key",
    "slo_burn",
]
