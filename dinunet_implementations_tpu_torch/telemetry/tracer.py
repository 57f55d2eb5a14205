"""Thread-safe host-side span tracer: the port's own copy of the JAX
package's ``telemetry/tracer.py`` (stdlib only).

One tracer instance serves a whole fit: the training loop opens phase spans
(``fit`` / ``epoch`` / ``eval`` / ``checkpoint`` / ``plan-build`` / ...), any
other thread may open its own concurrently, all into one event buffer.
Spans nest per thread (each thread keeps its own stack), and timestamps
come from ONE monotonic clock (``time.perf_counter`` relative to the
tracer's birth), so cross-thread ordering in the emitted trace is real.

Output formats:

- ``write_jsonl(path)``: one JSON object per event, after a ``clock_sync``
  row (the report CLI's input);
- ``write_chrome_trace(path)``: Chrome trace-event JSON (``traceEvents``
  with complete ``"X"`` spans and thread-name metadata), loadable in
  Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

Span and event names are string literals or module-level constants at the
call site, so traces stay greppable and stable across runs.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager


def duration(cache: dict, start: float, key: str):
    """Append elapsed seconds since ``start`` to ``cache[key]`` (reference
    ``coinstac_dinunet.utils.duration``, used at ``local.py:51-52``).
    ``start`` must come from ``time.perf_counter()``, the tracer's one
    monotonic clock: a wall-clock step mid-fit then cannot corrupt the
    checkpointed duration lists."""
    cache.setdefault(key, []).append(time.perf_counter() - start)
    return cache[key][-1]


def new_trace_id() -> str:
    """A fresh 16-hex-char trace or request id for cross-process
    propagation."""
    return os.urandom(8).hex()


class SpanTracer:
    """Collect nested spans + instant events + counters across threads.

    ``enabled=False`` builds a no-op tracer (every call returns immediately)
    so call sites can thread one tracer object unconditionally —
    :data:`NULL_TRACER` is the shared disabled instance.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._listeners: list = []
        self._local = threading.local()
        # perf and unix birth times sampled back-to-back: every event ts is
        # relative to _t0 (monotonic), and the clock_sync row write_jsonl
        # emits maps it onto the wall clock shared across processes
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()

    def clock_sync(self) -> dict:
        """The per-process clock anchor: this tracer's birth on both the
        monotonic (``t0_perf``) and wall (``t0_unix``) clocks, plus the
        pid. An event's wall time is ``t0_unix + ts/1e6`` — or, preferring
        the heartbeat-exchanged offset, ``offset + t0_perf + ts/1e6``."""
        return {
            "ph": "M", "name": "clock_sync", "pid": os.getpid(),
            "t0_perf": self._t0, "t0_unix": self._t0_unix,
        }

    # -- recording --------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            listeners = tuple(self._listeners)
        for fn in listeners:
            fn(ev)

    def add_listener(self, fn) -> None:
        """Mirror every recorded event into ``fn(event_dict)``. Listeners
        run outside the tracer lock and must not raise; on a disabled tracer
        nothing is ever recorded, so nothing is ever delivered."""
        with self._lock:
            self._listeners.append(fn)

    @contextmanager
    def span(self, name: str, **attrs):
        """Context manager for one named span. Nests per thread; closes (and
        records) on ANY exit — normal return, early ``break``, or an
        exception unwinding through (``Preempted`` included), with
        ``ok: false`` marking the exceptional exits."""
        if not self.enabled:
            yield self
            return
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        start = time.perf_counter()
        try:
            yield self
        finally:
            stack.pop()
            end = time.perf_counter()
            self._record({
                "ph": "X",
                "name": name,
                "ts": (start - self._t0) * 1e6,  # trace-event µs
                "dur": (end - start) * 1e6,
                "tid": threading.get_ident(),
                "thread": threading.current_thread().name,
                "depth": depth,
                # sys.exc_info survives into finally only while an exception
                # is actually unwinding through the with-body
                "ok": sys.exc_info()[0] is None,
                **attrs,
            })

    def event(self, name: str, **attrs) -> None:
        """Instant event (checkpoint written, site quarantined, retry...)."""
        if not self.enabled:
            return
        self._record({
            "ph": "i",
            "name": name,
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            **attrs,
        })

    def counter(self, name: str, value) -> None:
        """Named counter sample (compile count, queue depth, bytes...)."""
        if not self.enabled:
            return
        self._record({
            "ph": "C",
            "name": name,
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "tid": threading.get_ident(),
            "value": value,
        })

    # -- aggregation (report helpers) ---------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def total_seconds(self, name: str) -> float:
        """Summed duration of every closed span named ``name``."""
        return sum(
            e["dur"] for e in self.events()
            if e["ph"] == "X" and e["name"] == name
        ) / 1e6

    def count(self, name: str) -> int:
        return sum(
            1 for e in self.events()
            if e["ph"] in ("X", "i") and e["name"] == name
        )

    def reset(self) -> None:
        """Drop recorded events (the clock keeps running)."""
        with self._lock:
            self._events.clear()

    # -- emission ---------------------------------------------------------

    def write_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            # first row: the clock anchor, so a bare trace.jsonl is
            # assemblable into a cross-process timeline even without the
            # heartbeat offsets (consumers filter on ph, so the metadata
            # row is invisible to the phase tables)
            fh.write(json.dumps(self.clock_sync()) + "\n")
            for ev in self.events():
                fh.write(json.dumps(ev) + "\n")
        return path

    def write_chrome_trace(self, path: str) -> str:
        """Perfetto/chrome://tracing-loadable trace-event JSON."""
        pid = os.getpid()
        events = self.events()
        out: list[dict] = []
        seen_threads: dict[int, str] = {}
        for ev in events:
            tid = ev.get("tid", 0)
            if tid not in seen_threads:
                seen_threads[tid] = str(ev.get("thread", tid))
        for tid, tname in seen_threads.items():
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        for ev in events:
            rec = {
                "ph": ev["ph"],
                "name": ev["name"],
                "ts": round(ev["ts"], 3),
                "pid": pid,
                "tid": ev.get("tid", 0),
            }
            if ev["ph"] == "X":
                rec["dur"] = round(ev["dur"], 3)
            if ev["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            args = {
                k: v for k, v in ev.items()
                if k not in ("ph", "name", "ts", "dur", "tid", "thread")
            }
            if args:
                rec["args"] = args
            out.append(rec)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, fh)
        return path


#: shared no-op tracer — thread it where telemetry is off instead of None
NULL_TRACER = SpanTracer(enabled=False)
