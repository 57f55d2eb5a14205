"""Runtime checks of the port: the sanitizer (:mod:`.sanitize`), the
counterpart of the JAX package's ``checks/sanitize.py``. The JAX package's
static rules over jaxprs are JAX-specific and not ported; its AST lint
is ROADMAP A19 (a)."""

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
    "ENV_VAR",
    "CompileGuard",
    "SanitizeReport",
    "SanitizerViolation",
    "sanitize_enabled",
    "sanitize_flags",
    "sanitized_fit",
]
