"""The flight recorder: a crash-safe ring of the process's final seconds.
The port's own copy of the JAX package's ``telemetry/flight.py`` (stdlib
only).

A daemon that dies (an unhandled exception, SIGTERM from a preempting
scheduler) leaves little but the ``metrics.jsonl`` rows already flushed.
The :class:`FlightRecorder` keeps a BOUNDED in-memory ring of the newest
spans and events (fed live by the span tracer through its listener hook)
plus its own notes (epoch ticks, holds, membership changes), and on the way
down writes one ``flight_<pid>.json`` holding:

- the ring (the last N spans and events, in order),
- a final ``MetricsBus`` snapshot (counters, gauges, histograms),
- the reason, pid, argv, uptime and wall-clock time.

Dump triggers:

- **cooperative**: the daemon's serve loop calls :meth:`~FlightRecorder.dump`
  when its ``PreemptionGuard`` latches SIGTERM or SIGINT (the guard owns
  the signal handlers there, and the recorder must not fight it);
- **installed**: :meth:`~FlightRecorder.install` chains ``sys.excepthook``
  (and, where no guard owns them, the signals it is given), so a crash
  anywhere still dumps. The previous hook or handler runs after the dump.

Dumps are atomic (a temporary file, then a rename), take a sequence suffix
rather than overwrite (a crash DURING shutdown keeps both), are strict JSON
(a non-finite float is ``null``) and never raise: a broken disk at crash
time must not mask the original exception.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque

FLIGHT_PREFIX = "flight_"


def flight_files(dirpath: str) -> list[str]:
    """The dumps under ``dirpath``, oldest first."""
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith(FLIGHT_PREFIX) and n.endswith(".json"))
    except OSError:
        return []
    return [os.path.join(dirpath, n) for n in names]


class FlightRecorder:
    """See the module docstring. ``out_dir`` takes the dumps, ``capacity``
    bounds the ring, ``bus`` is snapshotted into each dump and ``tracer``
    (when enabled) feeds the ring."""

    def __init__(self, out_dir: str = ".", *, capacity: int = 512, bus=None, tracer=None):
        self.out_dir = out_dir
        self.bus = bus
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._seq = 0
        self._installed = False
        self._prev_excepthook = None
        self._prev_handlers: dict = {}
        self.dumps: list[str] = []  # the paths this process wrote
        if tracer is not None:
            self.listen(tracer)

    # -- feeding the ring ----------------------------------------------------

    def record(self, event: dict) -> None:
        """One event into the ring (the tracer listener's target)."""
        with self._lock:
            self._ring.append(event)

    def listen(self, tracer) -> None:
        """Mirror every span, event and counter the tracer records into the
        ring (the tracer's own buffer is the whole record, the ring its
        tail). A disabled tracer never records, so attaching to it would
        only pin this recorder on its listener list: skipped."""
        if tracer.enabled:
            tracer.add_listener(self.record)

    def note(self, name: str, **attrs) -> None:
        """A recorder-local instant event: the daemon notes epochs, holds
        and membership changes here, so the ring has content with the
        tracer off too."""
        self.record({"ph": "i", "name": name,
                     "ts": round((time.monotonic() - self._t0) * 1e6, 1),
                     "src": "flight", **attrs})

    def recent(self, limit: int = 256) -> list[dict]:
        """The newest ``limit`` events of the ring, oldest first (the
        ``/tracez`` payload)."""
        with self._lock:
            events = list(self._ring)
        return events[-limit:]

    # -- dumping ---------------------------------------------------------------

    def dump(self, reason: str) -> str | None:
        """Write ``flight_<pid>[_<seq>].json``; returns its path, or None
        when even a best-effort write failed. Never raises."""
        try:
            with self._lock:
                events = list(self._ring)
                self._seq += 1
                seq = self._seq
            payload = {
                "reason": reason,
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "time_unix": time.time(),
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "events": events,
                "bus": self.bus.snapshot() if self.bus is not None else None,
            }
            name = (f"{FLIGHT_PREFIX}{os.getpid()}.json" if seq == 1
                    else f"{FLIGHT_PREFIX}{os.getpid()}_{seq}.json")
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, name)
            tmp = path + ".tmp"
            from .sink import _finite  # strict JSON: a non-finite float is null

            with open(tmp, "w") as fh:
                json.dump(_finite(payload), fh, default=str, allow_nan=False)
            os.replace(tmp, path)
            self.dumps.append(path)
            return path
        except Exception:
            # the recorder must never mask the original failure
            return None

    # -- crash hooks -----------------------------------------------------------

    def install(self, signals=(signal.SIGTERM,)) -> None:
        """Chain the dump into ``sys.excepthook`` and the given signals.
        After a signal's dump the PREVIOUS handler runs (or the default
        disposition is restored and the signal sent again, so a plain
        SIGTERM still ends the process). Where a ``PreemptionGuard`` owns
        the handlers, pass ``signals=()`` and dump cooperatively."""
        if self._installed:
            return
        self._installed = True
        self._prev_excepthook = sys.excepthook

        def excepthook(exc_type, exc, tb):
            self.note("unhandled-exception", error=repr(exc))
            self.dump(f"crash:{exc_type.__name__}")
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = excepthook

        def handler(signum, frame):
            self.note("signal", signum=signum)
            self.dump(f"signal:{signum}")
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                # the default disposition, delivered again: the process
                # still dies of the signal it was sent
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        try:
            for s in signals:
                self._prev_handlers[s] = signal.signal(s, handler)
        except ValueError:
            # not the main thread: the excepthook only
            self._prev_handlers = {}

    def uninstall(self) -> None:
        """Put back the hook and the handlers :meth:`install` replaced."""
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        for s, h in self._prev_handlers.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}
