"""Runtime checks of the port: the sanitizer (:mod:`.sanitize`), the
counterpart of the JAX package's ``checks/sanitize.py``. The JAX package's
static rules over jaxprs and its AST lint are not ported (ROADMAP A12,
A19)."""

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
