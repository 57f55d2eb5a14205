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
- :mod:`.hist`, :mod:`.bus`, :mod:`.exporter`: mergeable latency
  histograms, the metrics bus and the SLO burn of the serving plane.

The live and pod planes (the flight recorder, the HTTP exporter's
``/statusz``, ``/healthz``, ``/tracez`` and ``/metrics``, the pod collector,
the trace assembler and the post-mortem) are ROADMAP A12 (b).
"""

from .bus import NULL_BUS, LabeledBusView, MetricsBus, global_bus, series_key
from .exporter import SLO_BUDGET, slo_burn
from .hist import HistogramShapeError, LogHistogram, bucket_bounds
from .tracer import NULL_TRACER, SpanTracer, duration, new_trace_id

__all__ = [
    "NULL_BUS",
    "NULL_TRACER",
    "SLO_BUDGET",
    "HistogramShapeError",
    "LabeledBusView",
    "LogHistogram",
    "MetricsBus",
    "SpanTracer",
    "bucket_bounds",
    "duration",
    "global_bus",
    "new_trace_id",
    "series_key",
    "slo_burn",
]
