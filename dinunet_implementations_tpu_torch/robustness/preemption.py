"""Save-and-exit on SIGTERM and SIGINT: the port's own copy of the JAX
package's ``robustness/preemption.py``.

A preemptible worker (a spot instance, a cluster eviction) gets a
termination signal and a grace window. :class:`PreemptionGuard` turns that
signal into a flag that the trainer reads at epoch boundaries, the
checkpoint granularity: the epoch in flight finishes, the rotating
checkpoint lands, and the process exits cleanly instead of dying
mid-write. ``FedRunner.run(resume=True)`` then continues bit for bit from
the saved boundary.

:class:`Preempted` derives from ``BaseException``, as ``KeyboardInterrupt``
does, so that an ``except Exception`` recovery block cannot swallow a
shutdown request; the command line catches it and exits with
:attr:`Preempted.exit_code`.
"""

from __future__ import annotations

import signal


class Preempted(BaseException):
    """Training stopped cooperatively (a signal, or a ``FaultPlan``'s
    ``kill_at_round``) after the state was checkpointed; a resume continues
    bit for bit."""

    def __init__(self, reason: str, signum: int | None = None, epoch: int | None = None):
        super().__init__(reason)
        self.reason = reason
        self.signum = signum
        self.epoch = epoch

    @property
    def exit_code(self) -> int:
        """``128 + signum`` for a signal, the shell's convention for a
        signal death; 75 (``EX_TEMPFAIL``) for the ``FaultPlan`` kill."""
        return 128 + self.signum if self.signum else 75


class PreemptionGuard:
    """A context manager that latches SIGTERM and SIGINT into
    :attr:`requested`.

    The first signal only sets the flag (the trainer saves and raises
    :class:`Preempted` at the next epoch boundary). A second SIGINT raises
    ``KeyboardInterrupt`` at once, so a user pressing ctrl-C again is never
    held behind a slow epoch. Off the main thread, where ``signal.signal``
    raises, the guard does nothing. Guards nest: each restores the handlers
    it found on exit.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._old: dict = {}
        self._requested: int | None = None

    @property
    def requested(self) -> int | None:
        """The latched signal number, or ``None``."""
        return self._requested

    def _handler(self, signum, frame):
        if self._requested is not None and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._requested = signum

    def __enter__(self) -> "PreemptionGuard":
        self._requested = None
        self._old = {}
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread: run unguarded
            for s, h in self._old.items():
                signal.signal(s, h)
            self._old = {}
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}
        return False
