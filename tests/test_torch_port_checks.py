"""The port's AST lint (``dinunet_implementations_tpu_torch/checks``)
against the JAX package's.

Each case writes one fixture tree of sources and scans it with both
packages' ``run_checks``: both must report the same rules at the same
lines, with the same text (R003 and R005 are not ported, so their fixtures
are left out). Then the inline suppressions, the baseline round trip, the
CLI's outputs and exit codes, and the gate: the port's own package scans
clean with the empty baseline.
"""

import json
import os
import textwrap

import pytest

from dinunet_implementations_tpu.checks import core as jcore
from dinunet_implementations_tpu_torch.checks import __main__ as tmain
from dinunet_implementations_tpu_torch.checks import core as tcore

_STEPS = """
    class TrainState:
        params: object
        opt_state: object
        rng: object
"""


def _ckpt(payload_keys, template_keys, pops=()):
    payload = ", ".join(f'"{k}": state.{k}' for k in payload_keys)
    template = ", ".join(f'"{k}": like.{k}' for k in template_keys)
    pop_lines = "\n        ".join(f'raw.pop("{k}", None)' for k in pops) or "pass"
    return f"""
    def save_checkpoint(path, state, meta=None):
        payload = {{{payload}, "meta_json": "{{}}"}}
        return payload

    def load_checkpoint(path, like, raw=None):
        template = {{{template}}}
        {pop_lines}
        return template
    """


_SWALLOW = """
    try:
        work()
    except Exception:
        pass
"""
_SURFACED = """
    import warnings
    try:
        work()
    except Exception as e:
        warnings.warn(f"failed: {e}")
    try:
        work()
    except Exception:
        raise RuntimeError("wrapped")
"""

# case -> (fixture files, the rules both must report)
CASES = {
    "r000_syntax_error_gates": ({"trainer/broken.py": "def f(:\n"}, ["R000"]),
    "r001_print_flagged_and_allowlisted": ({
        "trainer/hot.py": "def f():\n    print('round done')\n",
        "runner/cli.py": "print('json line')\n",
        "data/demo.py": "print('tree ready')\n",
        "analysis.py": "print('report')\n",
    }, ["R001"]),
    "r002_bare_and_base_exception_anywhere": ({"data/anyfile.py": """
        try:
            work()
        except:
            pass
        try:
            work()
        except BaseException:
            cleanup()
        try:
            work()
        except (ValueError, BaseException):
            cleanup()
    """}, ["R002"] * 3),
    "r002_swallowing_broad_handler_scoped": ({
        "trainer/x.py": _SWALLOW, "robustness/y.py": _SWALLOW, "data/z.py": _SWALLOW,
        "runner/ok.py": _SURFACED,
    }, ["R002"] * 2),
    "r004_cfg_mutation": ({
        "trainer/bad.py": """
            class T:
                def fit(self, cfg):
                    self.cfg.batch_size = 4
                    cfg.epochs = 2
                    setattr(self.cfg, "seed", 1)
        """,
        "trainer/good.py": """
            class T:
                def __init__(self, cfg):
                    self.cfg = cfg
                def fit(self):
                    cfg = self.cfg.replace(batch_size=4)
                    return cfg
        """,
        "core/config.py": """
            def _init(cfg):
                cfg.batch_size = 16
        """,
    }, ["R004"] * 3),
    "r007_stable_names_pass": ({"trainer/t.py": (
        'SPAN_EPOCH = "epoch"\n'
        "def f(tracer, names, e):\n"
        '    with tracer.span("epoch", epoch=e):\n'
        "        pass\n"
        "    with tracer.span(SPAN_EPOCH):\n"
        "        pass\n"
        "    tracer.event(names.CHECKPOINT)\n"
        '    tracer.counter("queue-depth", e)\n')}, []),
    "r007_runtime_names_flagged": ({"trainer/t.py": (
        "def f(tracer, e, name):\n"
        "    with tracer.span(f\"epoch-{e}\"):\n"
        "        pass\n"
        "    tracer.event(name)\n"
        '    tracer.counter("x" + str(e), 1)\n'
        "    tracer.event(name=name)\n")}, ["R007"] * 4),
    "r006_schema_consistent": ({
        "trainer/steps.py": _STEPS,
        "trainer/checkpoint.py": _ckpt(["params", "opt_state", "rng"],
                                       ["params", "opt_state", "rng"]),
    }, []),
    "r006_schema_drift": ({
        "trainer/steps.py": _STEPS,
        "trainer/checkpoint.py": _ckpt(["params", "opt_state", "legacy"],
                                       ["params", "opt_state"]),
    }, ["R006"] * 3),
    "r006_popped_keys_restore": ({
        "trainer/steps.py": _STEPS,
        "trainer/checkpoint.py": _ckpt(["params", "opt_state", "rng"], ["params"],
                                       pops=("opt_state", "rng")),
    }, []),
}

# rule -> (file, a trigger, the same suppressed inline)
TRIGGERS = {
    "R001": ("trainer/a.py", "print('x')", "print('x')  # jaxlint: disable=R001"),
    "R002": ("trainer/b.py", "try:\n    f()\nexcept:\n    pass",
             "try:\n    f()\nexcept:  # jaxlint: disable=R002\n    pass"),
    "R004": ("trainer/d.py", "def f(cfg):\n    cfg.epochs = 1",
             "def f(cfg):\n    # jaxlint: disable=R004\n    cfg.epochs = 1"),
    "R007": ("telemetry/f.py", "def f(tr, i):\n    with tr.span(f'epoch-{i}'):\n        pass",
             "def f(tr, i):\n    with tr.span(f'epoch-{i}'):  # jaxlint: disable=R007\n"
             "        pass"),
    "all": ("trainer/a.py", "print('x')", "print('x')  # jaxlint: disable=all"),
}


def _write(root, files: dict) -> str:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def _both(root) -> list:
    """Both packages' findings over one tree, as comparable tuples; asserts
    they are equal and returns the port's."""
    got, want = tcore.run_checks(root), jcore.run_checks(root)
    key = [(f.rule, f.path, f.line, f.col, f.message, f.snippet) for f in got]
    assert key == [(f.rule, f.path, f.line, f.col, f.message, f.snippet) for f in want]
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_rules_match_jax(tmp_path, case):
    files, rules = CASES[case]
    got = _both(_write(tmp_path, files))
    assert sorted(f.rule for f in got) == rules
    if case.startswith("r001"):
        assert got[0].path == "trainer/hot.py" and "logs.py" in got[0].fixit
    if case == "r006_schema_drift":
        msgs = " | ".join(f.message for f in got)
        assert "'rng' is not serialized" in msgs and "'rng' is not restored" in msgs
        assert "'legacy'" in msgs


@pytest.mark.parametrize("rule", sorted(TRIGGERS))
def test_inline_suppression_matches_jax(tmp_path, rule):
    rel, trigger, suppressed = TRIGGERS[rule]
    want = ["R001" if rule == "all" else rule]
    assert [f.rule for f in _both(_write(tmp_path / "t", {rel: trigger}))] == want
    assert _both(_write(tmp_path / "s", {rel: suppressed})) == []


def test_inline_suppression_r006_matches_jax(tmp_path):
    files = {"trainer/steps.py": _STEPS,
             "trainer/checkpoint.py": _ckpt(["params", "opt_state"], ["params", "opt_state"])}
    assert [f.rule for f in _both(_write(tmp_path / "t", files))] == ["R006"] * 2
    files["trainer/checkpoint.py"] = files["trainer/checkpoint.py"].replace(
        "def save_checkpoint", "# jaxlint: disable=R006\n    def save_checkpoint").replace(
        "def load_checkpoint", "# jaxlint: disable=R006\n    def load_checkpoint")
    assert _both(_write(tmp_path / "s", files)) == []


def test_baseline_round_trip_matches_jax(tmp_path):
    """Grandfathered findings stop gating, survive a line shift (keys are
    snippets) and a new finding still gates (multiset semantics); each
    package reads the other's baseline file."""
    found = _both(_write(tmp_path / "pkg", {"trainer/a.py": "print('one')\nprint('two')\n"}))
    t_path = tcore.save_baseline(found, str(tmp_path / "t_baseline.json"))
    j_path = jcore.save_baseline(jcore.run_checks(str(tmp_path / "pkg")),
                                 str(tmp_path / "j_baseline.json"))
    with open(t_path) as a, open(j_path) as b:
        assert a.read() == b.read()
    baseline = tcore.load_baseline(j_path)
    assert len(baseline) == 2
    assert tcore.apply_baseline(found, baseline) == ([], 2)
    shifted = _both(_write(tmp_path / "pkg2", {
        "trainer/a.py": "# a new comment shifts lines\nprint('one')\nprint('two')\n"}))
    assert tcore.apply_baseline(shifted, baseline) == ([], 2)
    grown = _both(_write(tmp_path / "pkg3", {
        "trainer/a.py": "print('one')\nprint('two')\nprint('three')\n"}))
    new, matched = tcore.apply_baseline(grown, baseline)
    assert matched == 2 and [f.snippet for f in new] == ["print('three')"]


def test_cli_outputs_and_exit_codes_match_jax(tmp_path, capsys):
    """The text, JSON and SARIF outputs and the exit codes of both CLIs on
    one tree with findings, and ``--baseline`` then a clean rerun."""
    from dinunet_implementations_tpu.checks import __main__ as jmain

    root = _write(tmp_path / "pkg", {"trainer/a.py": "print('x')\n",
                                     "runner/b.py": "try:\n    f()\nexcept:\n    pass\n"})
    for fmt in ("human", "json", "sarif"):
        outs = []
        for main in (jmain.main, tmain.main):
            rc = main([root, "--format", fmt, "--no-baseline"])
            out, err = capsys.readouterr()
            outs.append((rc, out, err))
        assert outs[0] == outs[1], fmt
        assert outs[1][0] == 1 and outs[1][2] == "jaxlint: 2 finding(s)\n"
    doc = json.loads(outs[1][1])
    assert [r["ruleId"] for r in doc["runs"][0]["results"]] == ["R002", "R001"]
    bl = str(tmp_path / "baseline.json")
    assert tmain.main([root, "--baseline", "--baseline-file", bl]) == 0
    assert tmain.main([root, "--baseline-file", bl]) == 0
    assert capsys.readouterr().err.endswith("jaxlint: 0 finding(s) (2 baselined)\n")


def test_semantic_tier_is_refused_with_its_reason(capsys):
    assert tmain.main(["--semantic"]) == 2
    err = capsys.readouterr().err
    assert "traces nothing" in err and "S001-S005" in err


def test_port_package_scans_clean_with_empty_baseline():
    """The gate: the port's whole package is clean and the shipped baseline
    is empty (findings were repaired or suppressed inline, not
    grandfathered); a subpath scan keeps the package-relative scoping (the
    CLI is allowed its prints)."""
    assert tcore.PACKAGE_ROOT.endswith("dinunet_implementations_tpu_torch")
    assert tcore.load_baseline() == []
    findings = tcore.run_checks()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert tcore.run_checks(os.path.join(tcore.PACKAGE_ROOT, "runner", "cli.py")) == []
    assert tcore.run_checks(os.path.join(tcore.PACKAGE_ROOT, "trainer")) == []
    assert tmain.main([]) == 0
