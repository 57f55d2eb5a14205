"""CLI: ``python -m dinunet_implementations_tpu_torch.checks [paths...]``.

The AST lint (rules R001, R002, R004, R006 and R007; R000 for a file that
does not parse) over source files, the default the port's package. Exit
code 0 when every finding is baselined (or there are none), 1 when new
findings exist: the gate. ``--baseline`` regenerates the baseline from the
current findings. ``--format json`` emits one JSON object a finding,
``--format sarif`` one SARIF 2.1.0 document; human text is the default.
These are the JAX package's, with its tool name and its finding text.

``--semantic`` (the JAX package's traced-program tier, rules S001-S005) is
refused with exit code 2: it traces jaxprs, and the port traces nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core import (
    DEFAULT_BASELINE,
    PACKAGE_ROOT,
    apply_baseline,
    load_baseline,
    run_checks,
    save_baseline,
)

#: the tool's name in its output, the JAX package's
TOOL = "jaxlint"
SEMANTIC_REFUSAL = (
    "--semantic is not ported: the JAX package's semantic tier (S001-S005) traces the epoch "
    "programs into jaxprs and checks their collectives, wire bytes, donation, precision flow "
    "and lowering identity; the port runs PyTorch eagerly and traces nothing (the port's "
    "runtime checks are checks/sanitize.py)")


def _sarif(findings: list, tool: str) -> dict:
    """Minimal SARIF 2.1.0 document, enough for code-scanning viewers to
    annotate findings by file and line."""
    rules = sorted({f.rule for f in findings})
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message + (f"\nfix: {f.fixit}" if f.fixit else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(f.line, 1), "startColumn": f.col + 1},
                },
            }],
        })
    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                   "master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool,
                "informationUri": "https://github.com/trendscenter/dinunet_implementations",
                "rules": [{"id": r} for r in rules],
            }},
            "results": results,
        }],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dinunet_implementations_tpu_torch.checks",
        description="The port's AST lint: codebase-specific invariants (rules R001, R002, "
                    "R004, R006, R007; see the checks package docstring).")
    p.add_argument("paths", nargs="*",
                   help="files/directories to scan (default: the "
                        "dinunet_implementations_tpu_torch package)")
    p.add_argument("--semantic", action="store_true",
                   help="the JAX package's traced-program tier; refused (the port traces "
                        "nothing)")
    p.add_argument("--baseline", action="store_true",
                   help="regenerate the baseline file from the current findings and exit 0")
    p.add_argument("--baseline-file", default=None,
                   help=f"baseline path (default: the shipped baseline, {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--format", choices=("human", "json", "sarif"), default=None, dest="fmt",
                   help="output format (default: human; json = one object a finding, "
                        "sarif = one SARIF 2.1.0 document)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="(deprecated) same as --format json")
    args = p.parse_args(argv)
    fmt = args.fmt or ("json" if args.as_json else "human")
    if args.semantic:
        print(SEMANTIC_REFUSAL, file=sys.stderr)
        return 2

    findings = []
    for root in (args.paths or [PACKAGE_ROOT]):
        findings.extend(run_checks(root))
    baseline_file = args.baseline_file or DEFAULT_BASELINE

    if args.baseline:
        path = save_baseline(findings, baseline_file)
        print(f"{TOOL}: wrote {len(findings)} baseline entries to {path}")
        return 0

    baseline = [] if args.no_baseline else load_baseline(baseline_file)
    new, matched = apply_baseline(findings, baseline)
    if fmt == "json":
        for f in new:
            print(json.dumps(f.to_dict()))
    elif fmt == "sarif":
        print(json.dumps(_sarif(new, TOOL), indent=2))
    else:
        for f in new:
            print(f.format())
    tail = f"{TOOL}: {len(new)} finding(s)"
    if matched:
        tail += f" ({matched} baselined)"
    print(tail, file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
