"""The AST lint's engine: the scan, inline suppressions and the baseline,
the port's copy of the JAX package's ``checks/core.py``.

Stdlib only: parsing, rule dispatch, suppression and baseline handling
import neither torch nor the JAX package, so the gate runs in seconds on
a machine with neither.

Suppression: a finding on line L is silenced by

    <offending code>  # jaxlint: disable=R001
    # jaxlint: disable=R001,R002   (comment-only line directly above)

``disable=all`` silences every rule on that line. The comment keeps the
JAX package's spelling, so one comment reads the same in both trees.
Suppressions are for reviewed true negatives, each with a comment that
says why; the shipped baseline is empty, and a finding in the port's own
code is repaired or suppressed, never baselined.

Baseline entries key on ``(rule, path, snippet)`` (the stripped source
line), not the line number, so unrelated edits above a grandfathered
finding do not un-baseline it. Matching is multiset-aware: two identical
grandfathered lines need two baseline entries.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable

#: the package under test (``dinunet_implementations_tpu_torch/``)
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the checked-in grandfather list (empty == the whole package is clean)
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)

_SUPPRESS_RE = re.compile(r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix path relative to the scan root
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line — the baseline key
    fixit: str = ""

    def format(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.fixit:
            out += f"\n    fix: {self.fixit}"
        return out

    def baseline_key(self) -> tuple:
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SourceFile:
    """One parsed module handed to the rules."""

    path: str  # absolute
    relpath: str  # posix, relative to the scan root
    tree: ast.Module
    lines: list[str]  # physical source lines, 0-indexed

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


def iter_python_files(root: str) -> Iterable[str]:
    """All ``.py`` files under ``root`` (or ``root`` itself when it is a
    file), skipping caches and hidden directories. Deterministic order."""
    root = os.path.abspath(root)
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if not d.startswith(".") and d != "__pycache__"
        )
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def parse_source_file(path: str, relpath: str) -> SourceFile | Finding:
    """Parse one file; a syntax error comes back as an ``R000`` finding (an
    unparseable module can hide any other violation, so it must gate)."""
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return Finding(
            rule="R000",
            path=relpath,
            line=e.lineno or 1,
            col=(e.offset or 1) - 1,
            message=f"syntax error: {e.msg}",
            snippet=(e.text or "").strip(),
        )
    return SourceFile(path=path, relpath=relpath, tree=tree, lines=src.splitlines())


def _suppressed_rules(sf: SourceFile, lineno: int) -> set[str]:
    """Rules disabled for ``lineno``: an inline marker on the line itself, or
    on a directly-preceding comment-only line."""
    rules: set[str] = set()
    for ln in (lineno, lineno - 1):
        if not (1 <= ln <= len(sf.lines)):
            continue
        text = sf.lines[ln - 1]
        if ln != lineno and not text.lstrip().startswith("#"):
            continue  # the line above only counts when it is pure comment
        m = _SUPPRESS_RE.search(text)
        if m:
            rules.update(t.strip() for t in m.group(1).split(",") if t.strip())
    return rules


def is_suppressed(finding: Finding, sf: SourceFile) -> bool:
    rules = _suppressed_rules(sf, finding.line)
    return "all" in rules or finding.rule in rules


def run_checks(root: str | None = None) -> list[Finding]:
    """Scan ``root`` (default: the port's package) with every registered
    rule; returns unsuppressed findings sorted by location.

    Path-scoped rules (the print allowlist, the swallow scope) key on
    package-relative paths, so any file that lives under the real package is
    anchored to ``PACKAGE_ROOT`` no matter what subpath was passed —
    ``... checks runner/cli.py`` must see ``runner/cli.py``, not ``cli.py``.
    Files outside the package (fixture trees, scripts) anchor to ``root``.
    """
    from .rules import PROJECT_RULES, RULES  # late import: rules import core.Finding

    root = os.path.abspath(root or PACKAGE_ROOT)
    rel_base = root if os.path.isdir(root) else os.path.dirname(root)
    pkg_prefix = PACKAGE_ROOT + os.sep
    files: dict[str, SourceFile] = {}
    findings: list[Finding] = []
    for path in iter_python_files(root):
        base = PACKAGE_ROOT if path.startswith(pkg_prefix) else rel_base
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        parsed = parse_source_file(path, rel)
        if isinstance(parsed, Finding):
            findings.append(parsed)
            continue
        files[rel] = parsed
    for sf in files.values():
        for rule in RULES.values():
            findings.extend(rule.check(sf))
    for rule in PROJECT_RULES.values():
        findings.extend(rule.check_project(files))
    findings = [
        f for f in findings
        if f.path not in files or not is_suppressed(f, files[f.path])
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str | None = None) -> list[dict]:
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError(f"{path}: baseline must be a JSON list")
    return data


def save_baseline(findings: list[Finding], path: str | None = None) -> str:
    path = path or DEFAULT_BASELINE
    entries = sorted(
        (
            {"rule": f.rule, "path": f.path, "snippet": f.snippet}
            for f in findings
        ),
        key=lambda e: (e["path"], e["rule"], e["snippet"]),
    )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2)
        fh.write("\n")
    return path


def apply_baseline(
    findings: list[Finding], baseline: list[dict]
) -> tuple[list[Finding], int]:
    """Split findings into (new, matched-count). Multiset semantics: each
    baseline entry absorbs ONE matching finding."""
    budget: dict[tuple, int] = {}
    for e in baseline:
        key = (e.get("rule", ""), e.get("path", ""), e.get("snippet", ""))
        budget[key] = budget.get(key, 0) + 1
    new: list[Finding] = []
    matched = 0
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            matched += 1
        else:
            new.append(f)
    return new, matched
