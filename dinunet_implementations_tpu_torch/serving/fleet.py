"""ReplicaSet: the serving fleet, N InferenceEngines with sharded sessions.
The port's own copy of the JAX package's ``serving/fleet.py``.

A :class:`ReplicaSet` runs N :class:`~.engine.InferenceEngine` replicas,
round-robin over the CUDA devices (``torch.cuda.device_count()``; on one
card every replica shares it, and several cards are ROADMAP A11), behind
one routing front door:

- **Replica membership is a MembershipTable** (robustness/membership.py):
  replica slots are the fixed axis, and each (re)start of a replica joins
  at a bumped GENERATION, the record that incarnation N+1 started with
  fresh state (a new engine: a new session table, zeroed carry rows, the
  current live weights).
- **Sessions SHARD by id hash, never broadcast.** A streaming session's
  home replica is ``crc32(session_id) % capacity``; its chunks all route
  there, so its O(1) carry lives in exactly one replica. When the home
  replica is down, routing probes forward to the next live slot; when a
  session MOVES (a re-home on a crash, or its home coming back), the
  router closes it on the replica it left, so a session that bounced
  A→B→A and loses A again cannot resume on B's stale carry. Every re-home
  re-enters through the fresh gate: a re-homed stream replays bit for bit
  as a fresh session.
- **Supervision**: a supervisor thread probes each replica's lane threads
  on an interval; a dead replica leaves the table, its engine is torn down,
  and a fresh engine rejoins at the next generation with the CURRENT live
  weights, so a replica restarted after a hot-swap serves the published
  weights, not the boot checkpoint.

Batched requests route to the least-loaded live replica (queue depth, ties
to the lowest slot). Hot-swaps fan out to every live replica
(serving/publish.py drives them).
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..robustness.membership import MembershipTable
from ..telemetry.bus import NULL_BUS
from ..trainer.checkpoint import load_inference_state
from .engine import InferenceEngine, ServingError


def home_slot(session_id: str, capacity: int) -> int:
    """The session's home replica slot: a stable hash of the id over the
    fixed replica axis (crc32: deterministic across processes, no
    ``PYTHONHASHSEED`` dependence)."""
    return zlib.crc32(str(session_id).encode()) % capacity


def _to_host(tree):
    """A weight tree (nested dicts of arrays, or the port's tensors by
    name) with every leaf copied to the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    return np.array(tree)


class ReplicaSet:
    """See module docstring. Construct, :meth:`warmup`, :meth:`submit` /
    :meth:`stream`, :meth:`close` (or use as a context manager).

    ``devices``: the devices the replicas round-robin over (default every
    CUDA device; the tests pass ``["cpu"]``). ``engine_kwargs`` go to each
    :class:`~.engine.InferenceEngine`. ``tracer`` and ``sink`` exist for
    the JAX signature and must be None (ROADMAP A12 (b))."""

    def __init__(self, cfg: TrainConfig, *, replicas: int = 2, checkpoint: str | None = None,
                 params=None, batch_stats=None, supervise_interval_s: float = 0.2,
                 bus=None, devices=None, tracer=None, sink=None, **engine_kwargs):
        if tracer is not None or sink is not None:
            raise NotImplementedError("ReplicaSet tracer and sink are not ported: ROADMAP "
                                      "A12 (b) (the serving plane's tracer and sinks)")
        if replicas < 1:
            raise ServingError(f"need >= 1 replica, got {replicas}")
        self.cfg = cfg
        self.bus = bus if bus is not None else NULL_BUS
        self.meta: dict = {}
        if checkpoint is not None:
            params, batch_stats, self.meta = load_inference_state(checkpoint)
        if params is None:
            raise ServingError("need a checkpoint path or explicit params")
        if devices is None:
            resolve_device(None)  # raises without a card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self._devices = [resolve_device(d) for d in devices]
        # ONE host copy of the live weights; each replica copies it to its
        # device. Updated on every swap, so a restarted replica serves the
        # published weights, not the boot checkpoint.
        self._host_weights = (_to_host(params), _to_host(batch_stats or {}))
        self._engine_kwargs = dict(engine_kwargs)
        self.capacity = int(replicas)
        self.table = MembershipTable(capacity=self.capacity)
        self._engines: list = [None] * self.capacity
        # session id -> the replica slot now hosting it (what lets a MOVE
        # close the session at its old host)
        self._routes: dict = {}
        # one lock for the table, engines, routes and weights: membership
        # changes, routing and swaps are rare next to dispatches, which run
        # inside each engine and do not take it
        self._lock = threading.RLock()
        self._warm = False
        self.restarts = 0
        self.supervise_interval_s = float(supervise_interval_s)
        self._supervisor_stop = threading.Event()
        self._supervisor = threading.Thread(target=self._supervise, name="fleet-supervisor",
                                            daemon=True)
        self._t0 = time.monotonic()

    # -- replica lifecycle -----------------------------------------------

    def _replica_id(self, slot: int) -> str:
        return f"replica-{slot}"

    def _start_replica(self, slot: int) -> dict:
        """Build and warm one replica on the current weights, THEN join it
        at a bumped generation (a failed build leaves the slot down, and the
        supervisor retries). Returns the warmup times. Caller holds the
        lock."""
        params, stats = self._host_weights
        eng = InferenceEngine(self.cfg, params=params, batch_stats=stats,
                              device=self._devices[slot % len(self._devices)],
                              bus=self.bus, bus_labels={"replica": str(slot)},
                              **self._engine_kwargs)
        times = eng.warmup()
        self.table, _, _ = self.table.join(self._replica_id(slot))
        self._engines[slot] = eng
        self.bus.gauge("serving_replicas_live", self.table.occupied)
        self.bus.counter("serving_replica_starts_total", replica=str(slot))
        return times

    def warmup(self) -> dict:
        """Warm every replica and start the supervisor. Returns
        ``{"replica-<i>/<lane>/<bucket>": seconds}``."""
        times = {}
        with self._lock:
            for slot in range(self.capacity):
                for k, v in self._start_replica(slot).items():
                    times[f"{self._replica_id(slot)}/{k}"] = v
            self._warm = True
        self._supervisor.start()
        return times

    def _replica_alive(self, slot: int) -> bool:
        eng = self._engines[slot]
        if eng is None or not eng._warm:
            return False
        return all(probe() for probe in eng.health_probes().values())

    def kill_replica(self, slot: int) -> None:
        """Simulate a replica crash (tests, fault drills): close its lanes
        WITHOUT the orderly engine close. The supervisor's next probe sees
        the dead lanes and restarts the slot."""
        with self._lock:
            eng = self._engines[slot]
            if eng is None:
                return
            for lane in eng._lanes():
                lane.close(timeout=2.0)

    def restart_replica(self, slot: int) -> None:
        """Leave and rejoin the slot at a bumped generation with a FRESH
        engine on the current live weights. Every session routed there
        loses its route: its next chunk resolves through the new, empty
        session table (the fresh gate)."""
        with self._lock:
            old = self._engines[slot]
            self._engines[slot] = None
            rid = self._replica_id(slot)
            if self.table.slot_of(rid) is not None:
                self.table, _ = self.table.leave(rid)
            self._routes = {sid: s for sid, s in self._routes.items() if s != slot}
            if old is not None:
                for lane in old._lanes():
                    lane.close(timeout=2.0)
            self.restarts += 1
            self.bus.counter("serving_replica_restarts_total", replica=str(slot))
            self._start_replica(slot)

    def _supervise(self) -> None:
        """Probe every slot's lane threads; restart dead replicas at the
        next generation."""
        while not self._supervisor_stop.wait(self.supervise_interval_s):
            with self._lock:
                if not self._warm:
                    continue
                dead = [slot for slot in range(self.capacity) if not self._replica_alive(slot)]
            for slot in dead:
                if self._supervisor_stop.is_set():
                    return
                try:
                    self.restart_replica(slot)
                except Exception:  # noqa: BLE001 - the supervisor must keep running
                    # the build or warmup failed: the slot stays down and the
                    # next probe retries
                    self.bus.counter("serving_replica_restart_failures_total",
                                     replica=str(slot))

    # -- routing ---------------------------------------------------------

    def _live_slots(self) -> list:
        return [s for s in range(self.capacity) if self._replica_alive(s)]

    def _route_session(self, session_id: str) -> int:
        """The session's CURRENT replica: its home slot when live, else the
        next live slot. A move closes the session at the replica it left."""
        with self._lock:
            home = home_slot(session_id, self.capacity)
            slot = next((cand for cand in ((home + k) % self.capacity
                                           for k in range(self.capacity))
                         if self._replica_alive(cand)), None)
            if slot is None:
                raise ServingError("no live replica to route to")
            prev = self._routes.get(session_id)
            if prev is not None and prev != slot:
                prev_eng = self._engines[prev]
                if prev_eng is not None and self._replica_alive(prev):
                    with prev_eng._session_lock:
                        if prev_eng.sessions.slot_of(session_id) is not None:
                            prev_eng.sessions.close(session_id)
                self.bus.counter("serving_session_rehomes_total", replica=str(slot))
            self._routes[session_id] = slot
            return slot

    def _least_loaded(self) -> int:
        """Batched requests have no affinity: the lowest queue depth wins,
        ties to the lowest slot."""
        with self._lock:
            live = self._live_slots()
            if not live:
                raise ServingError("no live replica to route to")
            return min(live, key=lambda s: (self._engines[s]._infer_lane.depth(), s))

    # -- request front door ----------------------------------------------

    def submit(self, rows, weights=None, trace_id=None, priority: int = 0, deadline_ms=None):
        self._ensure_warm()
        slot = self._least_loaded()
        return self._engines[slot].submit(rows, weights=weights, trace_id=trace_id,
                                          priority=priority, deadline_ms=deadline_ms)

    def stream(self, session_id: str, windows, trace_id=None, priority: int = 0):
        self._ensure_warm()
        slot = self._route_session(session_id)
        return self._engines[slot].stream(session_id, windows, trace_id=trace_id,
                                          priority=priority)

    def close_session(self, session_id: str) -> None:
        with self._lock:
            slot = self._routes.pop(session_id, None)
            if slot is not None and self._engines[slot] is not None:
                self._engines[slot].close_session(session_id)

    def replica_of(self, session_id: str):
        """Where the router last placed a session (None: never routed)."""
        with self._lock:
            return self._routes.get(session_id)

    def _ensure_warm(self) -> None:
        if not self._warm:
            raise ServingError("call warmup() before submitting requests")

    @property
    def streaming(self) -> bool:
        """Whether the replicas run a streaming lane."""
        return any(e.streaming for e in self._engines if e is not None)

    @property
    def warmup_seconds(self) -> float:
        return sum(e.warmup_seconds for e in self._engines if e is not None)

    def drain(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                engines = [e for e in self._engines if e is not None]
            if all(L.depth() == 0 for e in engines for L in e._lanes()):
                return
            time.sleep(0.002)

    # -- publish plane (serving/publish.py drives these) ------------------

    def weights(self) -> tuple:
        """The host copy of the live ``(params, batch_stats)``: the rollback
        target (a later swap back copies it to each replica's device)."""
        with self._lock:
            return self._host_weights

    def shadow_score(self, params, batch_stats=None) -> dict:
        """Score a candidate on ONE live replica's mirrored traffic (every
        replica runs the same forward: one shadow pass proves the candidate
        for the fleet)."""
        with self._lock:
            live = self._live_slots()
            if not live:
                raise ServingError("no live replica to shadow-score on")
            eng = self._engines[live[0]]
        return eng.shadow_score(params, batch_stats)

    def swap_params(self, params, batch_stats=None) -> dict:
        """Swap every live replica to the candidate, from one host copy of
        it; the host copy becomes the live weights later restarts serve.
        Returns the largest pause (the fleet's) and each replica's."""
        params, batch_stats = _to_host(params), _to_host(batch_stats or {})
        with self._lock:
            self._ensure_warm()
            pauses = {}
            for slot in self._live_slots():
                got = self._engines[slot].swap_params(params, batch_stats)
                pauses[self._replica_id(slot)] = got["pause_ms"]
            self._host_weights = (params, batch_stats)
        return {"pause_ms": max(pauses.values()) if pauses else 0.0, "per_replica": pauses}

    # -- proofs and rollups ------------------------------------------------

    def assert_no_compiles(self) -> None:
        """Every replica's check that no kernel library was built or loaded
        after its warmup."""
        with self._lock:
            engines = [e for e in self._engines if e is not None]
        for eng in engines:
            eng.assert_no_compiles()

    def compiles_after_warmup(self) -> dict:
        with self._lock:
            engines = list(enumerate(self._engines))
        return {f"replica-{i}/{k}": v for i, e in engines if e is not None
                for k, v in e.compiles_after_warmup().items()}

    def health_probes(self) -> dict:
        probes = {"warm": lambda: self._warm}
        for slot in range(self.capacity):
            probes[f"replica_{slot}"] = lambda s=slot: self._replica_alive(s)
        return probes

    def status(self) -> dict:
        with self._lock:
            return {
                "task_id": self.cfg.task_id,
                "warm": self._warm,
                "replicas": self.capacity,
                "devices": [str(d) for d in self._devices],
                "replicas_live": self.table.occupied,
                "membership": self.table.to_json(),
                "routed_sessions": len(self._routes),
                "restarts": self.restarts,
                "per_replica": {self._replica_id(i): e.status()
                                for i, e in enumerate(self._engines) if e is not None},
            }

    def summary(self) -> dict:
        """The fleet rollup: per-replica summaries merged (requests and
        samples summed, latency percentiles over the union through the
        merged bus histogram when there is one)."""
        with self._lock:
            parts = [e.summary() for e in self._engines if e is not None]
        agg = {
            "kind": "serve_summary",
            "task_id": self.cfg.task_id,
            "replica": "fleet",
            "replicas": self.capacity,
            "restarts": self.restarts,
            **{k: sum(p[k] for p in parts)
               for k in ("swaps", "requests", "samples", "stream_chunks", "dispatches",
                         "deferrals", "shed", "warmup_seconds", "compiles_after_warmup")},
            "max_queue_depth": max((p["max_queue_depth"] for p in parts), default=0),
        }
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        agg["requests_per_s"] = agg["requests"] / elapsed
        agg["samples_per_s"] = agg["samples"] / elapsed
        # pad waste and bucket hit rate: dispatch-weighted means
        disp = max(agg["dispatches"], 1)
        agg["bucket_hit_rate"] = sum(p["bucket_hit_rate"] * p["dispatches"] for p in parts) / disp
        agg["pad_waste_pct"] = sum(p["pad_waste_pct"] * p["dispatches"] for p in parts) / disp
        hist = self.bus.merged_histogram("serving_request_latency_ms")
        if hist is not None and hist.count:
            pct = hist.percentiles()
            agg.update(latency_ms_p50=pct["p50"], latency_ms_p95=pct["p95"],
                       latency_ms_p99=pct["p99"])
        else:
            lat = sorted(v for p in parts for v in (p["latency_ms_p50"], p["latency_ms_p95"],
                                                    p["latency_ms_p99"]) if v is not None)
            agg.update(latency_ms_p50=lat[0] if lat else None,
                       latency_ms_p95=lat[len(lat) // 2] if lat else None,
                       latency_ms_p99=lat[-1] if lat else None)
        agg["per_replica"] = parts
        return agg

    def close(self) -> dict:
        """Stop the supervisor, close every replica, and check that none
        built or loaded a kernel library after its warmup; returns
        :meth:`summary`."""
        self._supervisor_stop.set()
        if self._supervisor.is_alive():
            self._supervisor.join(5.0)
        with self._lock:
            engines = [e for e in self._engines if e is not None]
        for eng in engines:
            eng.close()
        summary = self.summary()
        self.assert_no_compiles()
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
