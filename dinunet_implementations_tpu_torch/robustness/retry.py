"""Transient-failure retry: jittered exponential backoff with deadlines.
The port's copy of the part of the JAX package's ``robustness/retry.py``
that the native batch reader uses (``data/native_io.py``): an NFS read that
fails once under load is retried, and one that hangs is abandoned.

    @with_retry(attempts=3, base_delay=0.5, retry_on=(RuntimeError, OSError))
    def read(): ...

Backoff for attempt ``i`` is ``min(base_delay * 2**i, max_delay)`` scaled by
a jitter factor in ``[0.5, 1.5)``. Pass ``seed`` for a deterministic jitter
sequence (tests), and ``sleep`` to observe or skip the waits.

- ``deadline_s`` — a wall-clock budget across ALL attempts. Once a failure
  lands past the deadline, the last exception propagates immediately even if
  attempts remain, and every backoff sleep is capped to the remaining
  budget. Measured on ``clock`` (default ``time.monotonic``).
- ``timeout_s`` — a per-attempt cap: the attempt runs on a worker thread and
  a result that doesn't arrive in time raises :class:`RetryTimeout`,
  retryable unless ``retry_on_timeout=False``. The abandoned attempt's
  thread cannot be killed and may linger until its blocking call returns.
"""

from __future__ import annotations

import functools
import logging
import random
import threading
import time

_log = logging.getLogger(__name__)


class RetryTimeout(TimeoutError):
    """One attempt exceeded ``timeout_s``. The worker thread that ran the
    attempt may still be alive (blocking calls cannot be interrupted); the
    caller only gets control back."""


def _call_with_timeout(f, args, kwargs, timeout_s: float):
    """Run one attempt on a DAEMON thread, abandoning it past ``timeout_s``.

    A bare daemon ``threading.Thread``, not a ThreadPoolExecutor: executor
    workers are non-daemon and ``concurrent.futures`` joins them at
    interpreter exit, so one genuinely hung attempt (a dead NFS mount
    blocking in the kernel) would wedge process shutdown forever — exactly
    the failure mode this timeout exists to escape."""
    result: list = []
    error: list = []

    def run():
        try:
            result.append(f(*args, **kwargs))
        # not swallowed: relayed verbatim to the calling thread below (a
        # thread boundary cannot propagate exceptions any other way)
        except Exception as e:  # jaxlint: disable=R002
            error.append(e)

    t = threading.Thread(target=run, daemon=True, name="with_retry-attempt")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RetryTimeout(
            f"attempt did not return within timeout_s={timeout_s}"
        )
    if error:
        raise error[0]
    return result[0]


def with_retry(
    fn=None,
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    retry_on: tuple = (OSError,),
    seed: int | None = None,
    sleep=time.sleep,
    describe: str | None = None,
    deadline_s: float | None = None,
    timeout_s: float | None = None,
    retry_on_timeout: bool = True,
    clock=time.monotonic,
):
    """Wrap ``fn`` (decorator or call form) with jittered exponential backoff.

    Retries only exceptions matching ``retry_on`` (plus :class:`RetryTimeout`
    when ``timeout_s`` is set); anything else propagates immediately. After
    ``attempts`` failures — or, with ``deadline_s``, the first failure past
    the wall-clock budget — the last exception propagates.

    ``retry_on_timeout=False`` makes a per-attempt timeout fatal instead of
    retryable: the abandoned attempt's thread may still be mutating whatever
    the call touches, and for non-reentrant global state a concurrent second
    attempt would race it; there a timeout fails the operation.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if deadline_s is not None and deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    if timeout_s is not None and timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")

    def deco(f):
        catch = tuple(retry_on) + (
            (RetryTimeout,) if timeout_s is not None and retry_on_timeout else ())

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            rng = random.Random(seed)
            name = describe or getattr(f, "__name__", repr(f))
            start = clock()
            for attempt in range(attempts):
                try:
                    if timeout_s is None:
                        return f(*args, **kwargs)
                    return _call_with_timeout(f, args, kwargs, timeout_s)
                except catch as e:
                    if isinstance(e, RetryTimeout) and not retry_on_timeout:
                        # TimeoutError is an OSError, so retry_on=(OSError,)
                        # would otherwise catch the timeout asked to be fatal
                        raise
                    remaining = (
                        None if deadline_s is None
                        else deadline_s - (clock() - start)
                    )
                    if attempt == attempts - 1 or (
                        remaining is not None and remaining <= 0
                    ):
                        if remaining is not None and remaining <= 0:
                            _log.warning(
                                "%s failed (attempt %d/%d) past the %.1fs "
                                "deadline: %s — giving up",
                                name, attempt + 1, attempts, deadline_s, e,
                            )
                        raise
                    delay = min(base_delay * (2 ** attempt), max_delay)
                    delay *= 0.5 + rng.random()  # jitter in [0.5, 1.5)
                    if remaining is not None:
                        # never sleep past the budget; the next failure then
                        # lands at/after the deadline and propagates
                        delay = min(delay, max(remaining, 0.0))
                    _log.warning(
                        "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                        name, attempt + 1, attempts, e, delay,
                    )
                    sleep(delay)

        return wrapped

    return deco if fn is None else deco(fn)
