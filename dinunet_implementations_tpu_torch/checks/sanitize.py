"""The runtime sanitizer of a fit: the port of the JAX package's
``checks/sanitize.py``.

- **compile**: the one-build property. JAX checks that a fit's epoch
  program compiles once; the port has no jit cache, and what it builds are
  the kernel libraries (``ops/_build.py``: ``BUILDS`` sources compiled,
  ``LOADS`` libraries loaded). A fit that builds or loads a library after
  its first epoch fails with :class:`SanitizerViolation`, with the round
  and site context of the fit's result.
- **nans**: the fit runs under ``torch.autograd.detect_anomaly``, which
  names the backward operation that produced a non-finite value (JAX's
  ``jax_debug_nans``). Not for fault-plan NaN injection runs, where NaNs
  are the stimulus.
- **leaks**: JAX's ``jax.checking_leaks`` finds tracers escaping a jitted
  closure; PyTorch traces nothing, so the flag is accepted and checks
  nothing (a deliberate difference, ROADMAP C).

Activation: ``DINUNET_SANITIZE=1`` (all checks) or a comma subset
(``compile``, ``leaks``, ``nans``); the CLI's ``--sanitize`` sets the
variable. Off (the default), :func:`sanitized_fit` yields None and adds
nothing.
"""

from __future__ import annotations

import contextlib
import os
from contextlib import contextmanager

ALL_FLAGS = ("compile", "leaks", "nans")
ENV_VAR = "DINUNET_SANITIZE"


class SanitizerViolation(RuntimeError):
    """A runtime invariant the sanitizer guards was violated."""


def sanitize_flags(value: str | None = None) -> frozenset[str]:
    """Parse ``DINUNET_SANITIZE`` (or an explicit ``value``) into the active
    check set, as JAX does: ``""``/``0``/``false``/``off``/``no`` → none;
    ``1``/``true``/``on``/``yes``/``all`` → all; otherwise a comma list of
    flag names (``ValueError`` for an unknown one)."""
    raw = os.environ.get(ENV_VAR, "") if value is None else value
    raw = (raw or "").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return frozenset()
    if raw in ("1", "true", "on", "yes", "all"):
        return frozenset(ALL_FLAGS)
    flags = frozenset(t.strip() for t in raw.split(",") if t.strip())
    unknown = flags - set(ALL_FLAGS)
    if unknown:
        raise ValueError(f"{ENV_VAR}: unknown sanitizer flag(s) {sorted(unknown)}; "
                         f"valid: {ALL_FLAGS} (or 1/0)")
    return flags


def sanitize_enabled() -> bool:
    return bool(sanitize_flags())


class CompileGuard:
    """The compile guard over named watched objects, each with a
    ``compiles_after_first_epoch()`` (``FederatedTrainer``, ``FedDaemon``):
    :meth:`check` raises :class:`SanitizerViolation` when one built or
    loaded more than ``max_compiles`` libraries after its first epoch."""

    def __init__(self, watched: dict, max_compiles: int = 0, label: str = ""):
        self.max_compiles = max_compiles
        self.label = label
        self._watched = {k: v for k, v in watched.items() if v is not None}

    def counts(self) -> dict:
        """Libraries built and loaded after the first epoch, per watched
        object."""
        return {name: sum(w.compiles_after_first_epoch().values())
                for name, w in self._watched.items()}

    def check(self, context: str = "") -> dict:
        counts = self.counts()
        for name, n in counts.items():
            if n > self.max_compiles:
                where = f" [{self.label}]" if self.label else ""
                ctx = f"\n  context: {context}" if context else ""
                raise SanitizerViolation(
                    f"compile guard{where}: '{name}' built or loaded {n} kernel libraries "
                    f"after its first epoch (expected <= {self.max_compiles}). Every kernel "
                    f"of the fit's path builds by the end of its first epoch; a later build "
                    f"means a new kernel or shape route appeared mid-fit.{ctx}")
        return counts


class SanitizeReport:
    """Holder the fit's caller feeds the result into, so that a violation
    message carries the round and site context."""

    def __init__(self, label: str = "fit"):
        self.label = label
        self.result: dict | None = None

    def note_result(self, result) -> None:
        if isinstance(result, dict):
            self.result = result

    def context(self) -> str:
        if not self.result:
            return ""
        parts = []
        rnd = getattr(self.result.get("state"), "round", None)
        if rnd is not None:
            try:
                parts.append(f"round={int(rnd)}")
            except (TypeError, ValueError):
                pass
        health = self.result.get("site_health")
        if health:
            parts.append(f"site_health={health}")
        if self.result.get("best_val_epoch") is not None:
            parts.append(f"best_val_epoch={self.result['best_val_epoch']}")
        return " ".join(parts)


@contextmanager
def sanitized_fit(trainer, label: str = "fit", max_epoch_compiles: int = 1,
                  flags: frozenset[str] | None = None):
    """Wrap one ``FederatedTrainer.fit`` in the active checks. Yields a
    :class:`SanitizeReport` (feed the fit's result to ``note_result``), or
    None when the sanitizer is off. ``max_epoch_compiles`` is JAX's: the
    epoch's one build, so ``max_epoch_compiles - 1`` libraries may build or
    load after the first epoch. The guard is checked after the anomaly mode
    closes."""
    flags = sanitize_flags() if flags is None else frozenset(flags)
    if not flags:
        yield None
        return
    import torch

    report = SanitizeReport(label=label)
    guard = (CompileGuard({"epoch_fn": trainer}, max_compiles=max_epoch_compiles - 1,
                          label=label) if "compile" in flags else None)
    with contextlib.ExitStack() as stack:
        if "nans" in flags:
            stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
        yield report
    if guard is not None:
        guard.check(context=report.context())
