"""Slice supervision: the port's counterpart of the JAX package's
``runner/supervisor.py``, with the same constants and file formats.

A preempted slice or a crashed or wedged worker process is the normal
failure mode of a long multi-process run. This module is the host side that
turns "one dead worker kills the run" into "the run completes":

- :class:`Heartbeat`: each worker writes an atomic JSON pulse (pid, slice,
  epoch and round progress, and the discovery and clock fields the pod
  plane reads) every ``interval_s`` from a daemon thread;
  :func:`heartbeat_age_s` is the supervisor's staleness probe.
- The liveness spool (:func:`mark_slice_dead`, :func:`mark_slice_alive`,
  :func:`read_slice_liveness`): an append-only directory of every slice
  death (reason, last heartbeat age, generation) and revival, which
  outlives the supervisor itself.
- Checkpoint consensus (:func:`consensus_round`): every supervised worker
  rotates a per-slice checkpoint whose meta carries ``round`` and
  ``params_sha256``. After a death the supervisor picks the newest round at
  which every slice's candidates (the latest and ``.prev``, each on its
  own) agree by digest, and installs it as the fleet's resume point.
- :class:`SliceSupervisor`: launch the workers, watch their exits and
  heartbeats (the staleness verdict runs under
  :func:`~..robustness.retry.with_retry` deadline semantics, so one slow
  stat never declares a slice dead), on a death drain the survivors
  (SIGTERM, then SIGKILL after a grace window), reach consensus and
  relaunch, until the run completes or ``max_restarts`` is spent.

The restart unit is the fleet, not one process: the run falls back to
checkpoint granularity on a fault, never to zero. Stdlib only apart from
the checkpoint reader, which is imported where consensus needs it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time

from ..robustness.retry import with_retry

#: supervisor exit code: a slice kept dying past max_restarts
SUPERVISOR_GAVE_UP_RC = 69

HEARTBEAT_DIR = "heartbeats"
LIVENESS_DIR = "slice_liveness"
SLICE_CKPT_DIR = "slices"


def _atomic_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


# -- heartbeats ---------------------------------------------------------------


def heartbeat_path(out_dir: str, slice_id: int) -> str:
    return os.path.join(out_dir, HEARTBEAT_DIR, f"slice_{slice_id}.json")


class Heartbeat:
    """A worker's liveness pulse: an atomically replaced JSON file with the
    pid, the slice, the wall clock and whatever progress the worker last
    noted. The pulse rides a daemon timer thread, so a stale file means the
    process is frozen or its writes block, not merely slow.

    Each pulse also carries ``started_unix`` (construction time: a recycled
    pid cannot pass for the worker that wrote the file), ``perf`` and
    ``time_unix`` sampled back to back (this process's monotonic-to-wall
    offset, which the trace assembler aligns clocks with) and, once the
    worker advertises it with ``beat(statusz_port=...)``, its live
    ``/statusz`` port, which the pod collector scrapes."""

    def __init__(self, path: str, slice_id: int, interval_s: float = 2.0):
        self.path = path
        self.slice_id = slice_id
        self.interval_s = interval_s
        self.started_unix = time.time()
        self._extra: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, **extra) -> None:
        """Write one pulse now; ``extra`` persists into later pulses."""
        if extra:
            self._extra.update(extra)
        try:
            _atomic_json(self.path, {
                "pid": os.getpid(),
                "slice": self.slice_id,
                "started_unix": self.started_unix,
                # sampled adjacently: their difference is the offset
                "perf": time.perf_counter(),
                "time_unix": time.time(),
                **self._extra,
            })
        except OSError:
            pass  # a full disk must not kill the worker it monitors

    def start(self) -> "Heartbeat":
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-slice{self.slice_id}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None


def read_heartbeat(path: str) -> dict | None:
    """The last pulse, or None (``os.replace`` makes a pulse atomic, so an
    unreadable file is an absent one)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def heartbeat_age_s(path: str, now: float | None = None) -> float | None:
    """Seconds since the last pulse, or None when there is none yet."""
    hb = read_heartbeat(path)
    if hb is None or "time_unix" not in hb:
        return None
    return max((now if now is not None else time.time()) - hb["time_unix"], 0.0)


# -- the liveness spool -------------------------------------------------------


def _spool_event(liveness_dir: str, event: dict) -> str:
    os.makedirs(liveness_dir, exist_ok=True)
    event = {"time_unix": time.time(), **event}
    # sequence names keep sorted order equal to event order
    seq = len([n for n in os.listdir(liveness_dir) if n.endswith(".json")])
    path = os.path.join(liveness_dir, f"ev{seq:06d}_slice{event.get('slice', 'x')}.json")
    _atomic_json(path, event)
    return path


def mark_slice_dead(liveness_dir: str, slice_id: int, reason: str,
                    heartbeat_age: float | None = None, generation: int = 0) -> str:
    """Record a slice death in the spool; returns the event's path."""
    return _spool_event(liveness_dir, {
        "event": "dead", "slice": int(slice_id), "reason": reason,
        "heartbeat_age_s": heartbeat_age, "generation": int(generation),
    })


def mark_slice_alive(liveness_dir: str, slice_id: int, generation: int) -> str:
    """Record a slice revival (a supervised restart, generation bumped)."""
    return _spool_event(liveness_dir, {
        "event": "alive", "slice": int(slice_id), "generation": int(generation),
    })


def read_slice_liveness(liveness_dir: str) -> list:
    """Every liveness event, oldest first."""
    try:
        names = sorted(n for n in os.listdir(liveness_dir) if n.endswith(".json"))
    except OSError:
        return []
    out = []
    for n in names:
        try:
            with open(os.path.join(liveness_dir, n)) as fh:
                out.append(json.load(fh))
        except (OSError, json.JSONDecodeError):
            continue
    return out


# -- checkpoint consensus -----------------------------------------------------


def slice_ckpt_dir(out_dir: str, slice_id: int) -> str:
    return os.path.join(out_dir, SLICE_CKPT_DIR, f"slice_{slice_id}")


def slice_ckpt_candidates(ckpt_dir: str) -> dict:
    """``{round: (sha, path)}`` from one slice's rotating checkpoint pair:
    the latest and ``.prev`` are separate candidates, so a torn latest
    cannot shadow the intact generation before it."""
    from ..trainer.checkpoint import CorruptCheckpointError, load_meta

    path = os.path.join(ckpt_dir, "checkpoint_latest.msgpack")
    out: dict = {}
    for cand in (path + ".prev", path):  # the latest last: it wins ties
        if not os.path.exists(cand):
            continue
        try:
            meta = load_meta(cand, fallback=False)
        except (OSError, CorruptCheckpointError):
            continue  # a torn or corrupt generation is no candidate
        rnd, sha = meta.get("round"), meta.get("params_sha256")
        if rnd is None or not sha:
            continue
        out[int(rnd)] = (sha, cand)
    return out


def consensus_round(slice_dirs: dict) -> tuple | None:
    """The newest round at which every slice in ``slice_dirs`` (slice id to
    its checkpoint directory) holds a candidate with the same params digest:
    ``(round, sha, path)``, ``path`` one of the agreed files (equal by
    digest, so any serves), or None when no round is agreed."""
    per_slice = {sl: slice_ckpt_candidates(d) for sl, d in slice_dirs.items()}
    if not per_slice or any(not c for c in per_slice.values()):
        return None
    common = set.intersection(*(set(c) for c in per_slice.values()))
    for rnd in sorted(common, reverse=True):
        shas = {cands[rnd][0] for cands in per_slice.values()}
        if len(shas) == 1:
            return rnd, shas.pop(), next(iter(per_slice.values()))[rnd][1]
    return None


# -- the supervisor -----------------------------------------------------------


class SliceSupervisor:
    """Launch, watch and restart a fleet of per-slice worker processes.

    ``spawn(process_id, generation)`` returns a started ``subprocess.Popen``
    for one worker; the supervisor knows nothing of its command line.
    ``on_consensus(generation, dead_slice)`` (optional) runs between the
    drain and the relaunch, where the caller installs the agreed checkpoint
    as the fleet's resume point. An exit code in ``passthrough_rcs`` (a
    capability skip, say) is returned at once rather than counted as a
    death."""

    def __init__(self, spawn, num_processes: int, out_dir: str, slice_of_process=None,
                 heartbeat_timeout_s: float = 30.0, max_restarts: int = 2, poll_s: float = 0.5,
                 grace_s: float = 20.0, flight=None, bus=None, on_consensus=None,
                 passthrough_rcs: tuple = ()):
        self.spawn = spawn
        self.num_processes = num_processes
        self.out_dir = out_dir
        self.slice_of_process = slice_of_process or (lambda pid_: pid_)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.grace_s = grace_s
        self.flight = flight
        self.bus = bus
        self.on_consensus = on_consensus
        self.passthrough_rcs = tuple(passthrough_rcs)
        self.generation = 0
        self.restarts = 0
        self.liveness_dir = os.path.join(out_dir, LIVENESS_DIR)

    def _note(self, name: str, **attrs) -> None:
        if self.flight is not None:
            self.flight.note(name, **attrs)

    def _count(self, name: str, **labels) -> None:
        if self.bus is not None:
            # a relay: NAME is a literal at every call site
            self.bus.counter(name, **labels)  # jaxlint: disable=R007

    def _stale_verdict(self, slice_id: int) -> float | None:
        """The heartbeat staleness verdict for one slice under ``with_retry``
        deadline semantics: a missing or old pulse is probed again with
        backoff until the staleness budget is spent. The final age when the
        slice is stale past the deadline, None when a fresh pulse came."""
        path = heartbeat_path(self.out_dir, slice_id)

        class _Stale(OSError):
            pass

        def probe():
            age = heartbeat_age_s(path)
            if age is None or age > self.heartbeat_timeout_s:
                raise _Stale(f"heartbeat age {age}")
            return age

        try:
            with_retry(probe, attempts=8, base_delay=0.25, retry_on=(_Stale,),
                       deadline_s=self.heartbeat_timeout_s,
                       describe=f"slice {slice_id} heartbeat")()
            return None
        except _Stale:
            return heartbeat_age_s(path)

    def _launch(self) -> list:
        self.generation += 1
        # a stale pulse of the dead generation would get the fresh fleet
        # judged wedged while it starts (no pulse is not stale)
        hb_dir = os.path.join(self.out_dir, HEARTBEAT_DIR)
        try:
            for name in os.listdir(hb_dir):
                os.remove(os.path.join(hb_dir, name))
        except OSError:
            pass
        procs = [self.spawn(r, self.generation) for r in range(self.num_processes)]
        self._note("fleet-launch", generation=self.generation, processes=self.num_processes)
        return procs

    def _drain(self, procs: list, skip: int | None = None) -> None:
        """SIGTERM the survivors (they checkpoint and exit), then SIGKILL
        those still alive after the grace window: a worker wedged in a
        collective whose peer died never reaches its signal poll."""
        for i, p in enumerate(procs):
            if i == skip or p.poll() is not None:
                continue
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_s
        for i, p in enumerate(procs):
            if i == skip:
                continue
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self._note("worker-wedged", process=i, generation=self.generation)
                p.kill()
                p.wait()

    def _slice_death(self, procs: list, process_id: int, reason: str,
                     hb_age: float | None) -> None:
        slice_id = self.slice_of_process(process_id)
        self._note("slice-death", slice=slice_id, process=process_id, reason=reason,
                   heartbeat_age_s=hb_age, generation=self.generation)
        self._count("supervisor_slice_deaths_total", slice=str(slice_id))
        if "heartbeat" in reason:
            self._count("dcn_heartbeat_timeouts_total", slice=str(slice_id))
        mark_slice_dead(self.liveness_dir, slice_id, reason, heartbeat_age=hb_age,
                        generation=self.generation)
        if self.flight is not None:
            # the dump's reason names the slice and its last heartbeat age
            age = "none" if hb_age is None else f"{hb_age:.1f}s"
            self.flight.dump(f"slice-death:slice={slice_id}:hb_age={age}:{reason}")
        self._drain(procs, skip=process_id)

    def _find_death(self, procs: list, states: list) -> tuple | None:
        """``(process_id, reason, heartbeat_age)`` of the first worker that
        died (a failing exit, or a heartbeat confirmed stale), else None."""
        for r, rc in enumerate(states):
            if rc is None or rc == 0:
                continue
            sig = f" (signal {-rc})" if rc < 0 else ""
            return r, f"exit rc={rc}{sig}", heartbeat_age_s(
                heartbeat_path(self.out_dir, self.slice_of_process(r)))
        for r, rc in enumerate(states):
            if rc is not None:
                continue
            age = heartbeat_age_s(heartbeat_path(self.out_dir, self.slice_of_process(r)))
            if age is not None and age > self.heartbeat_timeout_s:
                # suspicious: confirm under the retry deadline first
                stale = self._stale_verdict(self.slice_of_process(r))
                if stale is not None and procs[r].poll() is None:
                    procs[r].kill()
                    procs[r].wait()
                    return r, "heartbeat stale", stale
        return None

    def run(self) -> int:
        """Supervise until done: 0 on a completed run, a passthrough rc as it
        is, the dead worker's rc when restarts are spent (a signal death as
        the shell's ``128+signum``), or :data:`SUPERVISOR_GAVE_UP_RC`."""
        while True:
            procs = self._launch()
            while True:
                states = [p.poll() for p in procs]
                if all(rc == 0 for rc in states):
                    self._note("fleet-complete", generation=self.generation)
                    return 0
                failed = next((r for r, rc in enumerate(states) if rc not in (None, 0)), None)
                if failed is not None and states[failed] in self.passthrough_rcs:
                    # a capability skip is no fault: drain and hand it on
                    self._drain(procs, skip=failed)
                    return states[failed]
                death = self._find_death(procs, states)
                if death is not None:
                    break
                time.sleep(self.poll_s)
            process_id, reason, hb_age = death
            dead_slice = self.slice_of_process(process_id)
            self._slice_death(procs, process_id, reason, hb_age)
            self.restarts += 1
            if self.restarts > self.max_restarts:
                self._note("supervisor-give-up", restarts=self.restarts)
                rc = procs[process_id].poll()
                if rc is None or rc == 0:
                    return SUPERVISOR_GAVE_UP_RC
                # Popen gives a signal death as -signum, which sys.exit
                # would wrap mod 256: map it to 128+signum
                return 128 - rc if rc < 0 else rc
            if self.on_consensus is not None:
                self.on_consensus(self.generation, dead_slice)
            mark_slice_alive(self.liveness_dir, dead_slice, self.generation + 1)
            self._count("supervisor_restarts_total")
            self._note("fleet-restart", generation=self.generation + 1, after_slice=dead_slice)
