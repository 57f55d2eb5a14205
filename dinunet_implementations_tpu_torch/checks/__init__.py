"""Checks of the port: the AST lint and the runtime sanitizer, the
counterparts of the JAX package's ``checks/``.

The AST lint (``python -m dinunet_implementations_tpu_torch.checks
[paths]``; :mod:`.core`, :mod:`.rules`, :mod:`.__main__`) keeps the JAX
package's finding format, its text, JSON and SARIF outputs, its baseline
(``checks/baseline.json``, shipped empty), its exit codes and its inline
suppression (``# jaxlint: disable=R001``). Its rules, scoped to the port's
tree:

- **R000** a file that does not parse gates the run;
- **R001** no ``print()`` outside the port's CLI surfaces (``runner/cli.py``,
  ``data/demo.py``, ``analysis.py``, ``checks/__main__.py``,
  ``telemetry/report.py``, ``serving/__main__.py``): library output goes
  through the level-gated logger in ``trainer/logs.py``;
- **R002** no bare ``except:`` or ``except BaseException:`` anywhere (the
  ``Preempted`` shutdown contract), and no silently swallowing ``except
  Exception`` in ``robustness/``, ``trainer/``, ``runner/``, ``parallel/``
  and ``native/``;
- **R004** no mutation of ``cfg`` / ``self.cfg`` fields outside
  ``core/config.py``: ``TrainConfig`` is shared across folds;
- **R006** the ``TrainState`` fields of ``trainer/steps.py`` round-trip
  through the payload keys of ``trainer/checkpoint.py``;
- **R007** telemetry span, event and metric names are string literals or
  UPPER_CASE constants.

Not ported, with the reason:

- **R003** checks that the named axes of lax collectives come from the
  mesh's constants. The port has no named axes: every site is a row of one
  device's tensors, and the multi-GPU port (ROADMAP A11) takes process
  groups in their place.
- **R005** checks for tracer-escaping casts under ``jit``. The port runs
  PyTorch eagerly and traces nothing, so a cast cannot escape a trace.
- ``--semantic`` (the jaxpr tier, S001-S005) is refused, exit code 2, for
  the same reason: there is no traced program to check.

The runtime sanitizer is :mod:`.sanitize` (``DINUNET_SANITIZE``).
"""

from .core import (
    DEFAULT_BASELINE,
    PACKAGE_ROOT,
    Finding,
    apply_baseline,
    load_baseline,
    run_checks,
    save_baseline,
)
from .sanitize import (
    ALL_FLAGS,
    ENV_VAR,
    CompileGuard,
    SanitizeReport,
    SanitizerViolation,
    sanitize_enabled,
    sanitize_flags,
    sanitized_fit,
)

__all__ = [
    "ALL_FLAGS",
    "DEFAULT_BASELINE",
    "ENV_VAR",
    "CompileGuard",
    "Finding",
    "PACKAGE_ROOT",
    "SanitizeReport",
    "SanitizerViolation",
    "apply_baseline",
    "load_baseline",
    "run_checks",
    "sanitize_enabled",
    "sanitize_flags",
    "sanitized_fit",
    "save_baseline",
]
