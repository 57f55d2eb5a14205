"""Continuous microbatcher: the request-queue half of the serving path.

The port's own copy of the JAX package's ``serving/microbatch.py``
(``Microbatcher``, ``RequestFuture``, ``RequestError``, ``ServingClosed``),
cut to what the batched lane uses.

One :class:`Microbatcher` per lane: a thread-safe FIFO queue plus a single
dispatch thread that coalesces requests under a **max-batch / max-delay**
rule. A dispatch fires as soon as the pending rows fill the largest shape
bucket, or when the OLDEST pending request has waited ``max_delay_ms``,
whichever comes first. The dispatch callback (serving/engine.py) pads the
collected requests into the smallest bucket that fits.

- A batch ends at the first request that does not fit; that request opens
  the next dispatch, so nothing is overtaken.
- A request bigger than the largest bucket is rejected at submit.
- The dispatch thread is a daemon and closes via a sentinel, after serving
  what was queued before it.
"""

from __future__ import annotations

import concurrent.futures as _futures
import queue
import threading
import time


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


class Microbatcher:
    """One serving lane's queue + dispatch thread (see module docstring).

    A request has ``rows`` (its bucket rows are ``len(rows)``) and a
    ``future``; :meth:`submit` stamps ``_submit_t`` on it.
    ``dispatch(requests, bucket)`` receives the collected requests and the
    chosen bucket (row capacity); it must resolve every request's future."""

    def __init__(self, dispatch, buckets, *, max_delay_ms: float = 2.0,
                 name: str = "lane"):
        if not buckets:
            raise ValueError("need at least one shape bucket")
        self.dispatch = dispatch
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_delay_s = max_delay_ms / 1e3
        self.name = name
        self._q: queue.Queue = queue.Queue()
        # a collected request that did not fit its batch; it opens the next
        self._held = None
        self._stopping = False  # the dispatch thread has seen the sentinel
        self._closed = False
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "dispatches": 0, "rows": 0, "pad_rows": 0,
                      "rejected": 0}
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
        rows = len(req.rows)
        if rows > self.max_rows:
            with self._stats_lock:
                self.stats["rejected"] += 1
            raise RequestError(
                f"{self.name}: request of {rows} rows exceeds the largest "
                f"bucket ({self.max_rows})"
            )
        req._submit_t = time.monotonic()
        self._q.put(req)

    # -- dispatch thread -------------------------------------------------

    def _get(self, timeout):
        """The next queued request, waiting up to ``timeout`` seconds
        (``None``: until one comes); ``None`` on timeout, or at the sentinel,
        after which nothing blocks."""
        try:
            if self._stopping or (timeout is not None and timeout <= 0):
                item = self._q.get_nowait()
            else:
                item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is None:
            self._stopping = True
        return item

    def _collect(self) -> list:
        """Take the oldest request, then grow the batch in arrival order
        until the largest bucket is full, the next request does not fit, or
        that first request's max-delay budget runs out."""
        first, self._held = self._held, None
        if first is None:
            first = self._get(None)
            if first is None:
                return []
        batch, rows = [first], len(first.rows)
        deadline = first._submit_t + self.max_delay_s
        while rows < self.max_rows:
            nxt = self._get(deadline - time.monotonic())
            if nxt is None:
                break
            if rows + len(nxt.rows) > self.max_rows:
                self._held = nxt
                break
            batch.append(nxt)
            rows += len(nxt.rows)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                if self._stopping and self._held is None and self._q.empty():
                    return
                continue
            rows = sum(len(r.rows) for r in batch)
            try:
                bucket = self.bucket_for(rows)
                self.dispatch(batch, bucket)
                with self._stats_lock:
                    self.stats["requests"] += len(batch)
                    self.stats["dispatches"] += 1
                    self.stats["rows"] += rows
                    self.stats["pad_rows"] += bucket - rows
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
