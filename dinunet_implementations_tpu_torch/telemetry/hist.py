"""Fixed log-spaced mergeable latency histograms: the port's own copy of
the JAX package's ``telemetry/hist.py``.

Every latency series the :class:`~.bus.MetricsBus` carries (the serving
per-request latency, the swap pause) is a :class:`LogHistogram`, chosen
over a raw sample list for three properties:

- **Bounded state.** A server that runs for weeks records into a fixed
  ``O(decades x per_decade)`` vector of integer bucket counts; every read
  stays O(1) whatever the traffic.
- **Exact merge associativity.** Bucket bounds are FIXED at construction
  (pure functions of ``(lo, hi, per_decade)``), so merging two histograms is
  elementwise integer addition of counts plus min/max: ``(a+b)+c`` and
  ``a+(b+c)`` land on bit-identical quantile-determining state, whatever the
  merge tree (per-lane or per-fleet rollups all agree). The auxiliary
  ``sum`` is a float accumulator and carries ordinary float-summation
  caveats; every quantile and count is exact.
- **Bounded quantile error.** ``quantile(q)`` returns the UPPER edge of the
  bucket holding the q-th sample, so the estimate never understates the true
  empirical quantile and overstates it by at most one bucket ratio
  (``10**(1/per_decade)``, ~26% at the default 10 buckets/decade) for
  in-range samples. The SLO burn (exporter.py) inherits the conservative
  direction: a reported-met p99 target is really met.

Stdlib only and lock-free: the MetricsBus serializes access.
"""

from __future__ import annotations

import math

#: default bucket range: 1µs to 100s when recording milliseconds — covers
#: a microbatch dispatch on one end and a cold compile on the other
DEFAULT_LO = 1e-3
DEFAULT_HI = 1e5
DEFAULT_PER_DECADE = 10

#: shared bound vectors, keyed by (lo, hi, per_decade) — every histogram of
#: one shape aliases ONE tuple, so merge compatibility is an identity check
_BOUNDS_CACHE: dict = {}


def bucket_bounds(lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                  per_decade: int = DEFAULT_PER_DECADE) -> tuple:
    """The finite upper bucket edges for a ``(lo, hi, per_decade)`` shape:
    ``lo * r**i`` for ``i = 0..n`` with ``r = 10**(1/per_decade)``, computed
    from integer exponents (never by repeated multiplication) so every
    histogram of one shape gets bit-identical edges."""
    key = (float(lo), float(hi), int(per_decade))
    cached = _BOUNDS_CACHE.get(key)
    if cached is not None:
        return cached
    lo_f, hi_f, per = key
    if not (0 < lo_f < hi_f):
        raise ValueError(f"need 0 < lo < hi, got lo={lo_f}, hi={hi_f}")
    if per < 1:
        raise ValueError(f"per_decade must be >= 1, got {per}")
    n = math.ceil(round(per * math.log10(hi_f / lo_f), 9))
    bounds = tuple(lo_f * 10.0 ** (i / per) for i in range(n + 1))
    _BOUNDS_CACHE[key] = bounds
    return bounds


class HistogramShapeError(ValueError):
    """Merging histograms with different bucket shapes."""


class LogHistogram:
    """See module docstring. ``record`` values in any unit you like —
    the conventional bus unit is milliseconds (``*_ms`` series names)."""

    __slots__ = ("lo", "hi", "per_decade", "bounds", "counts", "count",
                 "sum", "min", "max")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 per_decade: int = DEFAULT_PER_DECADE):
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        self.bounds = bucket_bounds(lo, hi, per_decade)
        # counts[i] <-> (bounds[i-1], bounds[i]]; counts[0] is the underflow
        # bucket (-inf, lo]; counts[-1] the overflow (bounds[-1], +inf)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording --------------------------------------------------------

    def _bucket_of(self, value: float) -> int:
        if value <= self.bounds[0]:
            return 0
        if value > self.bounds[-1]:
            return len(self.bounds)
        # log-index guess, corrected against the exact edges (float log can
        # land one bucket off right at an edge)
        i = int(self.per_decade * math.log10(value / self.lo)) + 1
        i = min(max(i, 1), len(self.bounds) - 1)
        while value > self.bounds[i]:
            i += 1
        while i > 0 and value <= self.bounds[i - 1]:
            i -= 1
        return i

    def record(self, value) -> None:
        v = float(value)
        if math.isnan(v):
            return  # NaN carries no rank information; keep quantiles exact
        self.counts[self._bucket_of(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # -- merging ----------------------------------------------------------

    def _check_shape(self, other: "LogHistogram") -> None:
        if self.bounds is not other.bounds and self.bounds != other.bounds:
            raise HistogramShapeError(
                f"cannot merge histograms of different shapes: "
                f"(lo={self.lo}, hi={self.hi}, per_decade={self.per_decade})"
                f" vs (lo={other.lo}, hi={other.hi}, "
                f"per_decade={other.per_decade})"
            )

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """In-place elementwise merge; returns self. Exactly associative on
        counts/count/min/max (see module docstring)."""
        self._check_shape(other)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    # -- estimation -------------------------------------------------------

    def quantile(self, q: float):
        """Upper-edge estimate of the q-th quantile (``None`` when empty).
        Guarantee for in-range samples: ``true <= quantile(q) <=
        true * 10**(1/per_decade)``. The underflow bucket reports ``lo``
        (an upper edge too); the overflow bucket reports the exact observed
        ``max`` (the one value the histogram tracks beyond its range)."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i >= len(self.bounds):
                    return self.max
                return self.bounds[i]
        return self.max  # unreachable; counts always sum to count

    def percentiles(self) -> dict:
        """The SLO trio, ready for a summary row."""
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def mean(self):
        return self.sum / self.count if self.count else None

    def over(self, threshold: float) -> int:
        """Samples CERTAIN to exceed ``threshold`` — counts in buckets whose
        LOWER edge is >= threshold (conservative: a bucket straddling the
        threshold doesn't count, so SLO burn never overstates violations)."""
        total = 0
        for i, c in enumerate(self.counts):
            lower = -math.inf if i == 0 else self.bounds[i - 1]
            if lower >= threshold:
                total += c
        return total

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-able snapshot.
        Sparse: only non-zero buckets, keyed by index."""
        return {
            "lo": self.lo, "hi": self.hi, "per_decade": self.per_decade,
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
            **{k: v for k, v in self.percentiles().items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(d["lo"], d["hi"], d["per_decade"])
        for i, c in d.get("buckets", {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = d["min"] if d.get("min") is not None else math.inf
        h.max = d["max"] if d.get("max") is not None else -math.inf
        return h

    def copy(self) -> "LogHistogram":
        out = LogHistogram(self.lo, self.hi, self.per_decade)
        out.merge(self)
        return out

    def delta(self, since: "LogHistogram") -> "LogHistogram":
        """The WINDOW histogram between a cumulative snapshot ``since``
        (taken earlier from the same monotone series) and now — elementwise
        integer subtraction of counts, exact for the same reason merge is.
        This is what the publish controller's post-swap SLO-burn check and
        the max-delay autotuner read: burn over the observation window, not
        the process lifetime. ``min``/``max`` of the window alone are not
        recoverable from two cumulative snapshots, so the window inherits
        the full-series envelope — ``max`` can only OVERSTATE the window's
        true max, which keeps ``quantile()``'s never-understate guarantee
        (only the overflow bucket reports ``max``)."""
        self._check_shape(since)
        out = LogHistogram(self.lo, self.hi, self.per_decade)
        for i, c in enumerate(self.counts):
            d = c - since.counts[i]
            if d < 0:
                raise HistogramShapeError(
                    "delta() needs an EARLIER snapshot of the same series; "
                    f"bucket {i} went backwards ({since.counts[i]} -> {c})"
                )
            out.counts[i] = d
        out.count = self.count - since.count
        out.sum = self.sum - since.sum
        if out.count:
            out.min, out.max = self.min, self.max
        return out
