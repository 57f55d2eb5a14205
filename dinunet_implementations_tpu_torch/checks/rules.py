"""The AST lint's rules, the port's copy of the JAX package's
``checks/rules.py``: R001, R002, R004, R006 and R007 (R000, a syntax error,
is the engine's, checks/core.py).

Every rule carries the invariant it protects. Rules are pure AST passes over
:class:`~.core.SourceFile`; scoping is by path relative to the scan root,
so the same rules run unchanged over the port's package and over test
fixture trees. The scoping tables are restated for the port's tree. R003
(the named axes of lax collectives) and R005 (tracer escapes under ``jit``)
are not ported: the port has no named axes and traces nothing (the
package docstring).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterable, Iterator

from .core import Finding, SourceFile

# -- scoping tables ---------------------------------------------------------

#: R001 — the port's modules whose print() IS the product (its CLI surfaces).
PRINT_ALLOWED_FILES = {
    "runner/cli.py",  # the operational CLI: JSON result lines on stdout
    "data/demo.py",  # demo-tree generator CLI
    "analysis.py",  # the notebooks' report surface (summary_markdown)
    "checks/__main__.py",  # this analyzer's own CLI
    "telemetry/report.py",  # telemetry run-summary CLI (tables on stdout)
    "telemetry/assemble.py",  # pod trace assembly CLI (its source summary)
    "telemetry/postmortem.py",  # incident timeline CLI
    "serving/__main__.py",  # serving CLI: summary/latency JSON on stdout
    # the multi-process worker: its refusals and the UNSUPPORTED line next
    # to rc 66 are what its launcher reads
    "runner/dcn_worker.py",
}

#: R002 — packages where a swallowed ``except Exception`` can eat the
#: ``Preempted``/fault-tolerance contract's neighbors (broad handlers around
#: round, checkpoint and runner code hide real faults).
SWALLOW_SCOPED_DIRS = ("robustness/", "trainer/", "runner/", "parallel/", "native/")

#: R004 — the one module allowed to construct/mutate TrainConfig state.
CONFIG_MODULE = "core/config.py"

#: R006 — the two files whose schemas must agree (the port's ``TrainState``
#: dataclass and its checkpoint's payload).
TRAIN_STATE_FILE = "trainer/steps.py"
CHECKPOINT_FILE = "trainer/checkpoint.py"
#: payload keys that are serializer bookkeeping, not TrainState fields
CHECKPOINT_EXTRA_KEYS = {"meta_json"}

#: R007 — telemetry API calls whose NAME argument (positional 0 or ``name=``)
#: must be trace-stable (telemetry/tracer.py span/event/counter and the
#: MetricsBus publishers gauge/observe: bus series names feed /metrics and
#: must be as greppable as span names).
TELEMETRY_NAME_CALLS = {"span", "event", "counter", "gauge", "observe"}


# -- registry ---------------------------------------------------------------


@dataclasses.dataclass
class Rule:
    id: str
    title: str
    fixit: str
    fn: Callable
    project: bool = False

    def _wrap(self, sf_or_path, hits: Iterable) -> Iterator[Finding]:
        for hit in hits:
            if isinstance(hit, Finding):
                yield hit
                continue
            line, col, message = hit
            sf = sf_or_path
            yield Finding(
                rule=self.id, path=sf.relpath, line=line, col=col,
                message=message, snippet=sf.snippet(line), fixit=self.fixit,
            )

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        return self._wrap(sf, self.fn(sf))

    def check_project(self, files: dict[str, SourceFile]) -> Iterator[Finding]:
        return iter(self.fn(files))


RULES: dict[str, Rule] = {}
PROJECT_RULES: dict[str, Rule] = {}


def rule(id: str, title: str, fixit: str, project: bool = False):
    def deco(fn):
        r = Rule(id=id, title=title, fixit=fixit, fn=fn, project=project)
        (PROJECT_RULES if project else RULES)[id] = r
        return fn

    return deco


# -- AST helpers ------------------------------------------------------------


def _callee_name(node: ast.Call) -> str | None:
    """Trailing name of the called thing: ``span`` for ``self.tracer.span``."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _names_exception(node: ast.expr | None, name: str) -> bool:
    """Does an ``except`` type expression mention ``name`` (directly or in a
    tuple)?"""
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id == name
    if isinstance(node, ast.Attribute):
        return node.attr == name
    if isinstance(node, ast.Tuple):
        return any(_names_exception(e, name) for e in node.elts)
    return False


_LOGGING_ATTRS = {
    "warn", "warning", "error", "exception", "critical", "info", "debug", "log",
    # the project's own level-gated logger (trainer/logs.py) — R001 routes
    # library output through these, so they count as surfacing for R002 too
    "log_info", "log_warning",
}


def _handler_surfaces(handler: ast.ExceptHandler) -> bool:
    """True when the handler body re-raises or logs — i.e. the failure is
    surfaced somewhere instead of silently swallowed."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _LOGGING_ATTRS:
                return True
            if isinstance(f, ast.Name) and f.id in {"print"} | _LOGGING_ATTRS:
                return True
    return False


def _is_cfg_expr(node: ast.expr) -> bool:
    """``cfg`` / ``self.cfg`` / ``<anything>.cfg`` — the shared TrainConfig
    object."""
    if isinstance(node, ast.Name):
        return node.id == "cfg"
    if isinstance(node, ast.Attribute):
        return node.attr == "cfg"
    return False


# -- R001 -------------------------------------------------------------------


@rule(
    "R001",
    "no print() in library code",
    "route output through trainer/logs.py (level-gated logger: log_info / "
    "log_warning), or allowlist the module if its stdout IS the product",
)
def r001_no_print(sf: SourceFile):
    """Hot-path ``print()`` bypasses log levels and every downstream
    consumer of the structured logs: a round loop that prints per-epoch
    lines cannot be silenced or captured. Only the CLI, demo and report
    surfaces may print."""
    if sf.relpath in PRINT_ALLOWED_FILES:
        return
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "print"
        ):
            yield (
                node.lineno, node.col_offset,
                "print() outside the CLI/demo allowlist",
            )


# -- R002 -------------------------------------------------------------------


@rule(
    "R002",
    "no bare/blanket exception handlers",
    "name the concrete exception types the code can actually raise (with a "
    "comment naming the failure mode); never catch BaseException — it "
    "swallows Preempted/KeyboardInterrupt (the robustness/preemption.py "
    "shutdown contract)",
)
def r002_exception_hygiene(sf: SourceFile):
    """``Preempted(BaseException)`` exists precisely so recovery code cannot
    eat a shutdown request; a bare ``except:`` or ``except BaseException``
    re-opens that hole anywhere, and inside the fault-tolerance scope even
    an ``except Exception`` that silently swallows hides real faults."""
    scoped = sf.relpath.startswith(SWALLOW_SCOPED_DIRS)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            yield (
                node.lineno, node.col_offset,
                "bare 'except:' catches BaseException (incl. Preempted / "
                "KeyboardInterrupt)",
            )
        elif _names_exception(node.type, "BaseException"):
            yield (
                node.lineno, node.col_offset,
                "'except BaseException' swallows the Preempted shutdown "
                "contract",
            )
        elif (
            scoped
            and _names_exception(node.type, "Exception")
            and not _handler_surfaces(node)
        ):
            yield (
                node.lineno, node.col_offset,
                "'except Exception' here swallows failures without re-raise "
                "or logging (fault-tolerance scope: robustness/, trainer/, "
                "runner/)",
            )


# -- R004 -------------------------------------------------------------------


@rule(
    "R004",
    "TrainConfig is immutable outside core/config.py",
    "build a NEW config with cfg.replace(field=...) and thread it locally; "
    "the config object is shared across folds and callers",
)
def r004_no_cfg_mutation(sf: SourceFile):
    """The fold bug this guards: a batch-size clamp that writes
    ``self.cfg.batch_size``, when FedRunner hands ONE config object to every
    fold's trainer, silently shrinks the batch for all later folds. Mutation
    of ``cfg``/``self.cfg`` fields anywhere outside construction is that
    bug waiting to recur."""
    if sf.relpath == CONFIG_MODULE:
        return
    for node in ast.walk(sf.tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Name)
                and node.func.id == "setattr"
                and node.args
                and _is_cfg_expr(node.args[0])
            ):
                yield (
                    node.lineno, node.col_offset,
                    "setattr on a shared TrainConfig object",
                )
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) and _is_cfg_expr(t.value):
                yield (
                    t.lineno, t.col_offset,
                    f"mutates shared TrainConfig field '.{t.attr}' outside "
                    f"{CONFIG_MODULE}",
                )


# -- R007 -------------------------------------------------------------------


def _is_trace_stable_name(arg: ast.expr) -> bool:
    """A span/metric name the trace consumer can grep for: a string literal,
    or an UPPER_CASE module-level-constant reference (``SPAN_EPOCH``,
    ``tracer_names.FIT``)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return True
    if isinstance(arg, ast.Name):
        return arg.id == arg.id.upper()
    if isinstance(arg, ast.Attribute):
        return arg.attr == arg.attr.upper()
    return False


@rule(
    "R007",
    "telemetry span/metric names are string literals or constants",
    "pass a string literal (or an UPPER_CASE module-level constant) as the "
    "span/event/counter name — f-strings and runtime-built names make traces "
    "ungreppable and unstable across runs; put variable parts in keyword "
    "attributes instead (tracer.span('epoch', epoch=e))",
)
def r007_telemetry_names(sf: SourceFile):
    """The telemetry artifacts are only as useful as their names are stable:
    a span named ``f"epoch-{i}"`` explodes one logical phase into N trace
    rows, breaks the report CLI's phase table, and defeats grepping a trace
    for a known phase. Names must be literals (or constants); the variable
    part belongs in span attributes."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        if _callee_name(node) not in TELEMETRY_NAME_CALLS:
            continue
        args = [a for a in node.args]
        for kw in node.keywords:
            if kw.arg == "name":
                args.insert(0, kw.value)
        if not args:
            continue
        if not _is_trace_stable_name(args[0]):
            yield (
                args[0].lineno, args[0].col_offset,
                "telemetry name is not a string literal or UPPER_CASE "
                "constant (trace-stability contract)",
            )


# -- R006 -------------------------------------------------------------------


def _train_state_fields(sf: SourceFile) -> list[str] | None:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "TrainState":
            return [
                s.target.id
                for s in node.body
                if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
            ]
    return None


def _dict_str_keys(d: ast.Dict) -> list[str]:
    return [
        k.value for k in d.keys
        if isinstance(k, ast.Constant) and isinstance(k.value, str)
    ]


def _assigned_dict_keys(fn: ast.FunctionDef, var: str) -> list[str] | None:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == var for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            return _dict_str_keys(node.value)
    return None


def _popped_keys(fn: ast.FunctionDef) -> set[str]:
    keys: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("pop", "get")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            keys.add(node.args[0].value)
    return keys


@rule(
    "R006",
    "TrainState fields round-trip through the checkpoint serializer",
    "add the field to save_checkpoint's payload dict AND to "
    "load_checkpoint's template/pop set in trainer/checkpoint.py (or remove "
    "the stale payload key)",
    project=True,
)
def r006_checkpoint_schema(files: dict[str, SourceFile]):
    """A ``TrainState`` field the serializer does not carry silently resets
    on every resume; a payload key with no backing field is a stale schema
    that masks the next drift. Verified statically: field set ==
    save-payload key set == load-side (template + tolerant-pop) key set."""
    steps = files.get(TRAIN_STATE_FILE)
    ckpt = files.get(CHECKPOINT_FILE)
    if steps is None or ckpt is None:
        return []  # fixture trees without the pair: nothing to verify
    out: list[Finding] = []

    def finding(sf: SourceFile, line: int, msg: str) -> Finding:
        return Finding(
            rule="R006", path=sf.relpath, line=line, col=0, message=msg,
            snippet=sf.snippet(line), fixit=PROJECT_RULES["R006"].fixit,
        )

    fields = _train_state_fields(steps)
    if fields is None:
        return [finding(steps, 1, "TrainState class not found — cannot "
                                  "verify checkpoint schema")]
    save_fn = next(
        (n for n in ast.walk(ckpt.tree)
         if isinstance(n, ast.FunctionDef) and n.name == "save_checkpoint"),
        None,
    )
    load_fn = next(
        (n for n in ast.walk(ckpt.tree)
         if isinstance(n, ast.FunctionDef) and n.name == "load_checkpoint"),
        None,
    )
    if save_fn is None or load_fn is None:
        return [finding(ckpt, 1, "save_checkpoint/load_checkpoint not found "
                                 "— cannot verify checkpoint schema")]
    payload = _assigned_dict_keys(save_fn, "payload")
    if payload is None:
        return [finding(ckpt, save_fn.lineno,
                        "save_checkpoint has no literal 'payload' dict — "
                        "cannot verify checkpoint schema")]
    template = _assigned_dict_keys(load_fn, "template") or []
    load_keys = set(template) | _popped_keys(load_fn)
    for f in fields:
        if f not in payload:
            out.append(finding(
                ckpt, save_fn.lineno,
                f"TrainState field '{f}' is not serialized by "
                f"save_checkpoint — it silently resets on resume",
            ))
        if f not in load_keys:
            out.append(finding(
                ckpt, load_fn.lineno,
                f"TrainState field '{f}' is not restored by load_checkpoint",
            ))
    for k in payload:
        if k not in fields and k not in CHECKPOINT_EXTRA_KEYS:
            out.append(finding(
                ckpt, save_fn.lineno,
                f"checkpoint payload key '{k}' has no TrainState field "
                f"(stale schema)",
            ))
    return out
