"""Continuous microbatcher: the request-queue half of the serving path.
The port's own copy of the JAX package's ``serving/microbatch.py``.

One :class:`Microbatcher` per lane (batched inference / streaming step): a
thread-safe queue plus a single dispatch thread that coalesces requests under
a **max-batch / max-delay** admission rule: a dispatch fires as soon as the
pending rows fill the largest shape bucket, or when the OLDEST pending
request has waited ``max_delay_ms``, whichever comes first. The dispatch
callback (serving/engine.py) pads the collected requests into the smallest
bucket that fits, so the request path only meets the shapes warmup ran.

Admission details that matter:

- **Priority over arrival order**: collection picks the highest-``priority``
  pending request first, oldest-first within a priority; with every request
  at the default priority 0 this is plain FIFO. Priorities reorder only
  what is CONCURRENTLY pending, and a batch ends at the first request that
  does not fit, which bounds how far a big low-priority request can be
  overtaken.
- **Deadline shedding**: a request carrying ``deadline_ms`` that is staler
  than that at collection time is SHED: its future raises
  :class:`RequestError` at once instead of taking a dispatch slot for an
  answer the client already gave up on. ``max_queue`` sheds at ADMISSION
  (submit raises) once the lane's depth hits the bound.
- **Conflict deferral**: requests dispatch in admission order, except a
  request whose ``conflict_key`` collides with one already collected (two
  chunks of the SAME streaming session: the second must see the first's
  updated carry) stays pending for the next dispatch, preserving order.
- **No oversize silently**: a request bigger than the largest bucket is
  rejected at submit; splitting is the caller's policy (the engine's
  ``stream()`` splits long window runs into chunks before submitting).
- The dispatch thread is a **daemon** and closes via a sentinel, after
  serving what was queued before it.

``max_delay_s`` is a plain mutable attribute on purpose: the p99-targeted
autotuner (serving/admission.py) retunes it live between dispatches.
"""

from __future__ import annotations

import concurrent.futures as _futures
import queue
import threading
import time

from ..telemetry.bus import NULL_BUS

class ServingClosed(RuntimeError):
    """Submit after close()."""


class RequestError(RuntimeError):
    """A request the serving path cannot admit (oversize, bad shape)."""


class RequestFuture(_futures.Future):
    """The stdlib future with a bounded default wait: a serving client that
    forgets a timeout hangs 30 s and gets a clear ``TimeoutError``, not a
    forever-block on a lost dispatch."""

    def result(self, timeout: float | None = 30.0):
        return super().result(timeout)


class ChainedFuture:
    """A future over an in-order CHAIN of requests (a multi-chunk
    ``stream()`` call): ``result()`` waits the chain and raises the FIRST
    link's error — an early chunk's dispatch failure must surface, never be
    masked by a later chunk happening to succeed on a carry that silently
    missed the failed chunk's windows."""

    def __init__(self, links: list):
        self._links = links

    def done(self) -> bool:
        return all(f.done() for f in self._links)

    def result(self, timeout: float | None = 30.0):
        out = None
        for f in self._links:
            out = f.result(timeout)
        return out


class Microbatcher:
    """One serving lane's queue + dispatch thread (see module docstring).

    ``dispatch(requests, bucket)`` receives the collected request objects and
    the chosen bucket (row capacity); it must resolve every request's
    ``future``. ``rows_of(req)`` counts a request's bucket rows (samples for
    the batched lane, 1 session for the streaming lane); ``conflict_key``
    (optional) serializes requests that must not share a dispatch."""

    def __init__(self, dispatch, buckets, *, rows_of=None, conflict_key=None,
                 max_delay_ms: float = 2.0, max_queue: int | None = None,
                 name: str = "lane", on_dispatch=None, bus=None,
                 labels: dict | None = None):
        if not buckets:
            raise ValueError("need at least one shape bucket")
        self.dispatch = dispatch
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.rows_of = rows_of or (lambda req: len(req.rows))
        self.conflict_key = conflict_key
        self.max_delay_s = max_delay_ms / 1e3
        self.max_queue = max_queue
        self.name = name
        self.on_dispatch = on_dispatch
        self.bus = bus if bus is not None else NULL_BUS
        # extra label set on every bus series this lane publishes (a fleet
        # replica's {"replica": "<slot>"})
        self.labels = dict(labels or {})
        self._q: queue.Queue = queue.Queue()
        # admission-ordered requests awaiting collection; owned by the
        # dispatch thread (submit only touches the queue)
        self._pending: list = []
        self._sentinel = False
        self._seq = 0
        self._closed = False
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "dispatches": 0, "rows": 0, "pad_rows": 0,
            "bucket_hits": 0, "rejected": 0, "max_queue_depth": 0,
            "deferrals": 0, "shed": 0,
        }
        self._thread = threading.Thread(
            target=self._run, name=f"microbatch-{name}", daemon=True
        )
        self._thread.start()

    @property
    def max_rows(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        raise RequestError(
            f"{self.name}: request needs {rows} rows but the largest "
            f"compiled bucket is {self.max_rows} — split the request or "
            f"serve with a bigger bucket set"
        )

    def submit(self, req) -> None:
        if self._closed:
            raise ServingClosed(f"{self.name}: microbatcher is closed")
        rows = self.rows_of(req)
        if rows > self.max_rows:
            with self._stats_lock:
                self.stats["rejected"] += 1
            raise RequestError(
                f"{self.name}: request of {rows} rows exceeds the largest "
                f"bucket ({self.max_rows})"
            )
        if self.max_queue is not None and self.depth() >= self.max_queue:
            # load shedding at ADMISSION: past the depth bound the caller
            # hears "no" immediately instead of queueing into a latency
            # cliff (the answer would blow its deadline anyway)
            self._note_shed("queue_full")
            raise RequestError(
                f"{self.name}: queue full ({self.max_queue} pending) — "
                f"request shed at admission"
            )
        req._submit_t = time.monotonic()
        with self._stats_lock:
            self._seq += 1
            req._seq = self._seq
        self._q.put(req)
        # peak depth is sampled at ENQUEUE too: sampling only at dispatch
        # time would miss a burst that arrived and drained between two
        # dispatches
        self._note_depth()

    def depth(self) -> int:
        """Instantaneous queue depth (queued + collection-pending requests):
        the ONE definition status(), drain() and the peak sampler share."""
        return self._q.qsize() + len(self._pending)

    def _note_depth(self) -> int:
        depth = self.depth()
        with self._stats_lock:
            if depth > self.stats["max_queue_depth"]:
                self.stats["max_queue_depth"] = depth
        self.bus.gauge(
            "serving_queue_depth", depth, lane=self.name, **self.labels
        )
        return depth

    # -- dispatch thread -------------------------------------------------

    @staticmethod
    def _order(req) -> tuple:
        """Collection order: highest priority first, then admission order
        (all-default-priority traffic is plain FIFO)."""
        return (-getattr(req, "priority", 0), getattr(req, "_seq", 0))

    def _fill(self, block: bool) -> None:
        """Move queued requests into ``_pending`` (optionally blocking for
        the first); latches ``_sentinel`` when close() is seen."""
        if block and not self._sentinel:
            item = self._q.get()
            if item is None:
                self._sentinel = True
            else:
                self._pending.append(item)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                self._sentinel = True
            else:
                self._pending.append(item)

    def _shed_expired(self) -> None:
        """Deadline admission: fail (don't dispatch) any pending request
        already staler than its own ``deadline_ms``."""
        now = time.monotonic()
        keep = []
        for r in self._pending:
            d = getattr(r, "deadline_ms", None)
            if d is not None and now > r._submit_t + d / 1e3:
                self._note_shed("deadline")
                r.future.set_exception(RequestError(
                    f"{self.name}: request shed — waited "
                    f"{(now - r._submit_t) * 1e3:.1f} ms, past its "
                    f"{d} ms deadline"
                ))
            else:
                keep.append(r)
        self._pending = keep

    def _pick(self, keys: set, space: int, counted: set) -> tuple:
        """``(request, stop)``: pop the best eligible pending request
        (:meth:`_order`, skipping conflicts). ``stop=True`` when the best
        eligible does not fit ``space`` — the batch ends there (order
        fairness: a big request is deferred at most one dispatch, never
        overtaken indefinitely by smaller later arrivals)."""
        best_i = None
        for i, r in enumerate(self._pending):
            if (self.conflict_key is not None and keys
                    and self.conflict_key(r) in keys):
                if r._seq not in counted:
                    counted.add(r._seq)
                    self._note_deferral("conflict")
                continue
            if best_i is None or (
                    self._order(r) < self._order(self._pending[best_i])):
                best_i = i
        if best_i is None:
            return None, False
        r = self._pending[best_i]
        if self.rows_of(r) > space:
            if r._seq not in counted:
                counted.add(r._seq)
                self._note_deferral("overflow")
            return None, True
        return self._pending.pop(best_i), False

    def _collect(self) -> list:
        """Admission: pick the best pending request, then grow the batch
        until the largest bucket is full or that FIRST request's max-delay
        budget runs out (shedding expired requests as they surface)."""
        counted: set = set()
        keys: set = set()
        first, _ = self._pick(keys, self.max_rows, counted)
        if first is None:
            return []
        batch = [first]
        rows = self.rows_of(first)
        if self.conflict_key is not None:
            keys.add(self.conflict_key(first))
        deadline = first._submit_t + self.max_delay_s
        while rows < self.max_rows:
            nxt, stop = self._pick(keys, self.max_rows - rows, counted)
            if stop:
                break
            if nxt is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._sentinel:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._sentinel = True
                    break
                self._pending.append(item)
                self._fill(block=False)
                self._shed_expired()
                continue
            batch.append(nxt)
            rows += self.rows_of(nxt)
            if self.conflict_key is not None:
                keys.add(self.conflict_key(nxt))
        return batch

    def _note_deferral(self, why: str) -> None:
        with self._stats_lock:
            self.stats["deferrals"] += 1
        self.bus.counter(
            "serving_deferrals_total", lane=self.name, why=why,
            **self.labels,
        )

    def _note_shed(self, why: str) -> None:
        with self._stats_lock:
            self.stats["shed"] += 1
        self.bus.counter(
            "serving_shed_total", lane=self.name, why=why, **self.labels
        )

    def _run(self) -> None:
        while True:
            if not self._pending:
                if self._sentinel:
                    return
                self._fill(block=True)
            else:
                self._fill(block=False)
            self._shed_expired()
            if not self._pending:
                continue
            batch = self._collect()
            if not batch:
                continue
            rows = sum(self.rows_of(r) for r in batch)
            try:
                bucket = self.bucket_for(rows)
                depth = self._note_depth()
                self.dispatch(batch, bucket)
                with self._stats_lock:
                    self.stats["requests"] += len(batch)
                    self.stats["dispatches"] += 1
                    self.stats["rows"] += rows
                    self.stats["pad_rows"] += bucket - rows
                    self.stats["bucket_hits"] += int(rows == bucket)
                self.bus.counter(
                    "serving_dispatches_total", lane=self.name, **self.labels
                )
                self.bus.observe(
                    "serving_batch_occupancy_pct", 100.0 * rows / bucket,
                    lane=self.name, **self.labels,
                )
                if self.on_dispatch is not None:
                    self.on_dispatch(self.name, batch, bucket, rows, depth)
            except Exception as e:
                # the dispatch thread must never die silently: every
                # collected request's waiter gets the error, and the loop
                # keeps serving the next batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout)
