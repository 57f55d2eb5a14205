"""Train-to-serve deployment: watch, shadow, swap, roll back. The port's
own copy of the JAX package's ``serving/publish.py``.

A training daemon drops ``publish.json`` beside its rotating serve
checkpoint after every rotation (path, epoch, params digest; the port's
``runner.FedDaemon`` does, as the JAX package's does). This module is the
serving side of that wire:

- :class:`CheckpointWatcher` polls the announcement file by (mtime_ns,
  size) fingerprint, a cheap stat a tick and a JSON read only on change,
  and hands back announcements it has not seen.
- :class:`PublishController` takes a candidate through the publish
  gauntlet against a target (an :class:`~.engine.InferenceEngine` or a
  :class:`~.fleet.ReplicaSet`; both expose the same ``weights /
  shadow_score / swap_params`` plane):

  1. **digest gate**: a re-announcement of the live params (the daemon
     rotates every epoch whether or not the weights moved) is dropped as
     ``rejected-stale`` before any device work;
  2. **shadow lane**: the candidate is scored against a mirror of live
     traffic (the engine's ring of recent batched dispatches) through the
     same forward the live weights run. Non-finite outputs, or a
     divergence above ``max_shadow_delta`` (opt-in), reject it as
     ``rejected-shadow``: the live weights never moved;
  3. **swap**: the hot-swap, with the previous weights RETAINED and the
     live latency histogram snapshotted as the error-budget baseline;
  4. **rollback watch**: :meth:`PublishController.check_rollback` computes
     the SLO error-budget burn over the traffic SINCE the swap
     (``LogHistogram.delta`` of the merged request-latency series). A burn
     over ``rollback_burn`` with enough samples swaps the retained weights
     back. The burn comes from :func:`~..telemetry.exporter.slo_burn`,
     whose violation count is certain-only, so a rollback is always backed
     by real SLO damage, never by bucket quantization.

Every attempt appends one ``publish`` row (and each rollback verdict one
``rollback`` row) to :attr:`PublishController.history`, and to the
telemetry sink when one is given. :class:`PublishDaemon` wires the watcher and the
controller to a clock; the controller's methods stay directly callable.
"""

from __future__ import annotations

import json
import os
import threading

from ..telemetry.exporter import SLO_BUDGET, slo_burn
from ..trainer.checkpoint import load_inference_state
from .engine import ServingError


class CheckpointWatcher:
    """Poll the daemon's ``publish.json`` announcement for new candidates.

    ``poll()`` → the parsed announcement dict when the file changed since
    the last poll (fingerprinted by mtime_ns + size) AND carries a digest
    not seen before; else None. Torn reads can't happen — the daemon
    publishes with an atomic rename — but a half-written file from a
    foreign writer just returns None and retries next tick."""

    def __init__(self, publish_path: str):
        self.publish_path = publish_path
        self._fingerprint = None
        self._last_digest = None

    def poll(self) -> dict | None:
        try:
            st = os.stat(self.publish_path)
        except OSError:
            return None
        fp = (st.st_mtime_ns, st.st_size)
        if fp == self._fingerprint:
            return None
        self._fingerprint = fp
        try:
            with open(self.publish_path) as f:
                ann = json.load(f)
        except (OSError, ValueError):
            return None
        digest = ann.get("digest")
        if digest is None or digest == self._last_digest:
            return None
        self._last_digest = digest
        return ann


class PublishController:
    """See module docstring. ``target`` is an engine or fleet; ``bus`` must
    be the SAME bus its request path publishes latencies to (the rollback
    window reads it). ``sink`` (a ``telemetry.sink.FitTelemetry``) takes
    each ``publish`` and ``rollback`` row."""

    def __init__(self, target, *, bus, sink=None,
                 p99_target_ms: float = 50.0, budget: float = SLO_BUDGET,
                 rollback_burn: float = 1.0, min_window_samples: int = 20,
                 max_shadow_delta: float | None = None,
                 hist_name: str = "serving_request_latency_ms"):
        if rollback_burn <= 0:
            raise ServingError(
                f"rollback_burn must be positive, got {rollback_burn}"
            )
        self.target = target
        self.bus = bus
        self.sink = sink
        self.p99_target_ms = float(p99_target_ms)
        self.budget = float(budget)
        self.rollback_burn = float(rollback_burn)
        self.min_window_samples = int(min_window_samples)
        self.max_shadow_delta = max_shadow_delta
        self.hist_name = hist_name
        self.live_digest: str | None = None
        self.history: list = []  # publish/rollback rows, newest last
        # armed after a swap: (prev_params, prev_stats, digest, baseline
        # histogram snapshot) — disarmed by rollback or the next publish
        self._retained = None
        self._lock = threading.Lock()

    # -- the publish gauntlet --------------------------------------------

    def publish(self, params, batch_stats=None,
                digest: str | None = None) -> dict:
        """Run one candidate through digest gate → shadow lane → swap.
        Returns (and records) the ``publish`` row; the target's live
        params move ONLY on ``outcome == "swapped"``."""
        with self._lock:
            if digest is not None and digest == self.live_digest:
                return self._record({
                    "kind": "publish", "digest": digest,
                    "outcome": "rejected-stale", "pause_ms": None,
                    "shadow": None,
                })
            shadow = self.target.shadow_score(params, batch_stats)
            if not shadow["finite"] or (
                    self.max_shadow_delta is not None
                    and shadow["max_abs_delta"] > self.max_shadow_delta):
                return self._record({
                    "kind": "publish", "digest": digest,
                    "outcome": "rejected-shadow", "pause_ms": None,
                    "shadow": shadow,
                })
            prev = self.target.weights()
            baseline = self.bus.merged_histogram(self.hist_name)
            swapped = self.target.swap_params(params, batch_stats)
            self._retained = (prev[0], prev[1], self.live_digest, baseline)
            self.live_digest = digest
            return self._record({
                "kind": "publish", "digest": digest, "outcome": "swapped",
                "pause_ms": swapped["pause_ms"], "shadow": shadow,
            })

    # -- the rollback watch ----------------------------------------------

    def check_rollback(self) -> dict | None:
        """One SLO-burn check over the window since the last swap. Returns
        the ``rollback`` row (rolled_back True/False), or None when nothing
        is armed / the window is still too thin to judge.

        The first full window is the publish's whole probation: burn over
        the threshold swaps back, burn at or under it RELEASES the
        retained weights — either way exactly one ``rollback`` row per
        swapped publish, never a row per tick."""
        with self._lock:
            if self._retained is None:
                return None
            prev_params, prev_stats, prev_digest, baseline = self._retained
            cum = self.bus.merged_histogram(self.hist_name)
            window = (
                cum.delta(baseline)
                if cum is not None and baseline is not None else cum
            )
            if window is None or window.count < self.min_window_samples:
                return None
            verdict = slo_burn(window, self.p99_target_ms, self.budget)
            rolled = (
                verdict["burn"] is not None
                and verdict["burn"] > self.rollback_burn
            )
            row = {
                "kind": "rollback", "digest": self.live_digest,
                "burn": verdict["burn"], "rolled_back": rolled,
                "window_samples": window.count,
            }
            self._retained = None  # probation over, whichever way it went
            if rolled:
                self.target.swap_params(prev_params, prev_stats)
                self.live_digest = prev_digest
                self.bus.counter("serving_rollbacks_total")
            return self._record(row)

    def _record(self, row: dict) -> dict:
        self.history.append(row)
        if self.sink is not None:
            self.sink.append(row)
        self.bus.counter(
            "serving_publish_total",
            outcome=row.get("outcome", row["kind"]),
        )
        return row


class PublishDaemon:
    """Clocked watcher→controller driver: every tick, poll for an
    announcement (loading the checkpoint it names), publish it, and run one
    rollback check. Daemon thread; deterministic :meth:`tick` for tests."""

    def __init__(self, watcher: CheckpointWatcher,
                 controller: PublishController, *,
                 interval_s: float = 1.0):
        self.watcher = watcher
        self.controller = controller
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="publish-daemon", daemon=True
        )

    def start(self) -> "PublishDaemon":
        self._thread.start()
        return self

    def tick(self) -> dict | None:
        """One poll→publish→rollback-check pass; returns the publish row
        when an announcement landed this tick."""
        row = None
        ann = self.watcher.poll()
        if ann is not None:
            try:
                params, stats, _ = load_inference_state(ann["path"])
            except (OSError, ValueError, KeyError, RuntimeError):
                pass  # rotation race: the next announcement supersedes
            else:
                row = self.controller.publish(
                    params, stats, digest=ann.get("digest")
                )
        self.controller.check_rollback()
        return row

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # a failed publish attempt must not kill the CD loop; the
                # next rotation retries
                self.controller.bus.counter("serving_publish_errors_total")

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(5.0)
