"""The SLO error budget of the JAX package's ``telemetry/exporter.py``:
:data:`SLO_BUDGET` and :func:`slo_burn`, the burn the publish controller's
rollback watch (serving/publish.py) and the autotuner's budget
(serving/admission.py) read.

Only these two are ported. The rest of that module, the HTTP exporter that
serves ``/metrics`` (Prometheus text), ``/healthz``, ``/statusz`` and
``/tracez``, is ROADMAP A12 (b).
"""

from __future__ import annotations

from .hist import LogHistogram

#: default SLO: fraction of requests allowed over the p99 target
SLO_BUDGET = 0.01


def slo_burn(hist: LogHistogram | None, p99_target: float,
             budget: float = SLO_BUDGET) -> dict:
    """Error-budget burn of a latency histogram against a p99 target.

    The SLO is "``(1 - budget)`` of samples at or under ``p99_target``"
    (budget defaults to 1%, i.e. a p99 objective). ``burn`` is the
    violation rate over the allowed rate: 1.0 = burning exactly the budget,
    <1 healthy, >1 violating. Violations come from
    :meth:`~.hist.LogHistogram.over` (buckets certainly above the target),
    so the burn never overstates; ``p99_observed`` is the histogram's
    upper-edge estimate (conservative the other way)."""
    if hist is None or hist.count == 0:
        return {
            "p99_target": p99_target, "budget": budget, "samples": 0,
            "violations": 0, "violation_rate": None, "burn": None,
            "p99_observed": None,
        }
    over = hist.over(p99_target)
    rate = over / hist.count
    return {
        "p99_target": p99_target,
        "budget": budget,
        "samples": hist.count,
        "violations": over,
        "violation_rate": round(rate, 6),
        "burn": round(rate / budget, 4),
        "p99_observed": hist.quantile(0.99),
    }
