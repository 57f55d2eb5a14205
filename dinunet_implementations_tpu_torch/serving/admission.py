"""Load-aware admission control: the p99-targeted max-delay autotuner. The
port's own copy of the JAX package's ``serving/admission.py``.

The microbatcher's ``max_delay_ms`` is the one knob trading tail latency for
batch occupancy: a longer delay fills buckets (throughput) and a shorter one
dispatches partial buckets sooner (latency). :class:`DelayAutotuner` closes
the loop against the live per-lane latency histogram
(``serving_request_latency_ms{lane=...}``), targeting a p99 objective with
the SLO error budget of telemetry/exporter.py.

**Why the controller cannot oscillate on bucket error.** The histogram's two
estimators are conservative in OPPOSITE directions (telemetry/hist.py):

- ``over(target)`` counts only samples CERTAIN to exceed the target (buckets
  whose lower edge clears it), so it never overstates violations. The
  controller only SHRINKS the delay when ``over/count`` exceeds the error
  budget, so a shrink is always backed by real violations.
- ``quantile(0.99)`` returns the bucket's UPPER edge, so it never
  understates the true p99. The controller only GROWS the delay when that
  upper bound sits below ``target x headroom`` (headroom < 1), so a grow
  happens only when the true p99 provably has slack.

Between those two certainties lies a dead band (the bucket quantization
plus the headroom margin) where the controller HOLDS: a sample
distribution near the target parks the knob instead of flapping it.

Decisions consume WINDOW histograms (``LogHistogram.delta`` between
successive cumulative snapshots), so each step reacts to traffic since the
last step; windows with fewer than ``min_samples`` observations hold.
"""

from __future__ import annotations

import threading

from ..telemetry.bus import NULL_BUS
from ..telemetry.exporter import SLO_BUDGET
from ..telemetry.hist import LogHistogram


class DelayAutotuner:
    """One per microbatcher lane. Call :meth:`step` with that lane's window
    histogram (or run :class:`AutotunerDaemon` to do it on a clock)."""

    def __init__(self, lane, *, p99_target_ms: float,
                 budget: float = SLO_BUDGET, headroom: float = 0.5,
                 shrink: float = 0.5, grow: float = 1.25,
                 min_delay_ms: float = 0.05, max_delay_ms: float = 50.0,
                 min_samples: int = 20, bus=None):
        if not 0 < headroom < 1:
            raise ValueError(f"headroom must be in (0, 1), got {headroom}")
        if not 0 < shrink < 1 < grow:
            raise ValueError(
                f"need shrink < 1 < grow, got {shrink}/{grow}"
            )
        self.lane = lane
        self.p99_target_ms = float(p99_target_ms)
        self.budget = float(budget)
        self.headroom = float(headroom)
        self.shrink = float(shrink)
        self.grow = float(grow)
        self.min_delay_ms = float(min_delay_ms)
        self.max_delay_ms = float(max_delay_ms)
        self.min_samples = int(min_samples)
        self.bus = bus if bus is not None else NULL_BUS
        self.decisions = {"shrink": 0, "grow": 0, "hold": 0}

    def step(self, window: LogHistogram | None) -> str:
        """One control decision over a window histogram; returns
        ``"shrink" | "grow" | "hold"`` and (except hold) retunes the lane's
        ``max_delay_s`` in place; the microbatcher reads it fresh at every
        collect."""
        decision = "hold"
        if window is not None and window.count >= self.min_samples:
            certain_violations = window.over(self.p99_target_ms)
            p99_upper = window.quantile(0.99)
            if certain_violations / window.count > self.budget:
                decision = "shrink"
            elif p99_upper is not None and (
                    p99_upper <= self.p99_target_ms * self.headroom):
                decision = "grow"
        if decision != "hold":
            cur_ms = self.lane.max_delay_s * 1e3
            factor = self.shrink if decision == "shrink" else self.grow
            new_ms = min(
                max(cur_ms * factor, self.min_delay_ms), self.max_delay_ms
            )
            if new_ms == cur_ms:
                decision = "hold"  # parked at a clamp
            else:
                self.lane.max_delay_s = new_ms / 1e3
        self.decisions[decision] += 1
        self.bus.gauge(
            "serving_max_delay_ms", self.lane.max_delay_s * 1e3,
            lane=self.lane.name, **getattr(self.lane, "labels", {}),
        )
        self.bus.counter(
            "serving_autotune_decisions_total", decision=decision,
            lane=self.lane.name, **getattr(self.lane, "labels", {}),
        )
        return decision


class AutotunerDaemon:
    """Clocked driver: every ``interval_s`` it snapshots each lane's
    cumulative latency histogram from the bus, forms the window delta since
    its previous snapshot, and steps that lane's :class:`DelayAutotuner`.
    Daemon thread; :meth:`stop` to halt."""

    def __init__(self, bus, tuners: list, *, interval_s: float = 1.0,
                 hist_name: str = "serving_request_latency_ms"):
        self.bus = bus
        self.tuners = list(tuners)
        self.interval_s = float(interval_s)
        self.hist_name = hist_name
        self._prev: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="delay-autotuner", daemon=True
        )

    def start(self) -> "AutotunerDaemon":
        self._thread.start()
        return self

    def tick(self) -> None:
        """One pass over every lane (what the thread runs on its clock;
        callable directly for deterministic tests)."""
        for tuner in self.tuners:
            labels = {
                "lane": tuner.lane.name, **getattr(tuner.lane, "labels", {}),
            }
            cum = self.bus.histogram(self.hist_name, **labels)
            if cum is None:
                continue
            key = tuple(sorted(labels.items()))
            prev = self._prev.get(key)
            self._prev[key] = cum  # bus.histogram already returns a copy
            tuner.step(cum.delta(prev) if prev is not None else None)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(5.0)
