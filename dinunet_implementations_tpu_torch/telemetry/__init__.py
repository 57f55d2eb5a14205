"""Live metrics of the serving plane: mergeable latency histograms, the
metrics bus and the SLO burn. The tracer, the sinks and the HTTP exporter
are ROADMAP A12."""

from .bus import NULL_BUS, LabeledBusView, MetricsBus, series_key
from .exporter import SLO_BUDGET, slo_burn
from .hist import HistogramShapeError, LogHistogram, bucket_bounds

__all__ = [
    "NULL_BUS",
    "SLO_BUDGET",
    "HistogramShapeError",
    "LabeledBusView",
    "LogHistogram",
    "MetricsBus",
    "bucket_bounds",
    "series_key",
    "slo_burn",
]
