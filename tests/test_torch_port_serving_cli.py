"""The port's serving CLI (``python -m dinunet_implementations_tpu_torch.serving``)
against the JAX package's, on the CPU: the parser (JAX's flags and
``--device``), the synthetic mix and the default checkpoint path, both CLIs
over one checkpoint that the port's CLI fit wrote (a ``--smoke`` mix, a
``--script`` of one dispatch a request with a swap and a rollback verdict,
and a two-replica script with a replica killed): equal request and
dispatch counts where the script fixes them, the same metrics row kinds,
and ``telemetry.report --validate`` at rc 0 on both outputs (each
package's report on its own); the refusals; the card by default; and a run in a fresh
interpreter that imports nothing of JAX.

The tree is the FS demo tree at 8 features with MSANNet 8 → 8 → 2
(its inputspec's hidden sizes cut to (8,)).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dinunet_implementations_tpu.serving import __main__ as jserve
from dinunet_implementations_tpu.serving import engine as jengine
from dinunet_implementations_tpu.serving import fleet as jfleet
from dinunet_implementations_tpu.serving import microbatch as jmicrobatch
from dinunet_implementations_tpu.telemetry import report as jreport
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.serving import __main__ as tserve
from dinunet_implementations_tpu_torch.telemetry import report as treport
from dinunet_implementations_tpu_torch.telemetry import sink as tsink

REPO = Path(__file__).resolve().parents[1]
TASK = "FS-Classification"
BUCKETS = ["--row-buckets", "1,8"]  # the smoke mix sends up to 8 rows


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A two-site FS tree and the best checkpoint of one epoch of the
    port's CLI fit on it."""
    root = tmp_path_factory.mktemp("serving_cli")
    tree = tdemo.make_fs_demo_tree(str(root / "tree"), n_sites=2, subjects=24, n_features=8,
                                   seed=5)
    spec_path = os.path.join(tree, "inputspec.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    for site in spec:
        site["hidden_sizes"] = {"value": [8]}
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    out = str(root / "fit")
    assert tcli.main(["--data-path", tree, "--device", "cpu", "--epochs", "1", "--folds", "0",
                      "--out-dir", out, "--quiet"]) == 0
    ckpt = tserve.default_checkpoint(out, TASK)
    assert os.path.exists(ckpt)
    return tree, ckpt, root


def _options(parser) -> dict:
    return {o: a for a in parser._actions for o in a.option_strings}


def test_parser_takes_jax_s_flags_and_device():
    ours, theirs = _options(tserve.build_parser()), _options(jserve.build_parser())
    assert set(ours) - set(theirs) == {"--device"} and set(theirs) <= set(ours)
    for opt, a in theirs.items():
        assert (ours[opt].dest, ours[opt].default, ours[opt].type, ours[opt].nargs) == (
            a.dest, a.default, a.type, a.nargs), opt


@pytest.mark.parametrize("n,streaming", [(1, False), (7, True), (60, False), (60, True)])
def test_smoke_script_and_default_checkpoint_are_jax_s(n, streaming):
    assert tserve.smoke_script(n, streaming) == jserve.smoke_script(n, streaming)
    assert tserve.default_checkpoint("o", TASK) == jserve.default_checkpoint("o", TASK)


def _script(path: str, ops: list) -> str:
    with open(path, "w") as fh:
        for op in ops:
            fh.write(json.dumps(op) + "\n")
    return path


def _run(mod, argv: list, capsys) -> tuple:
    """One CLI run; its exit code and its stdout's JSON lines."""
    capsys.readouterr()
    rc = mod.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("{", "null"))]
    return rc, lines


def _kinds(out: str) -> list:
    return [r["kind"] for r in tsink.load_metrics(
        os.path.join(out, "telemetry", "serving", tsink.METRICS_FILE))]


MODES = {
    # the synthetic mix: its dispatches depend on the lanes' timing
    "smoke": lambda d, ckpt: ["--smoke", "20"],
    # a request a dispatch (a drain after each), a swap to the same
    # checkpoint and a rollback verdict over the requests after it
    "script": lambda d, ckpt: ["--rollback-window", "2", "--script", _script(
        os.path.join(d, "script.jsonl"),
        [o for r in (1, 3, 8) for o in ({"op": "infer", "n": 1, "rows": r}, {"op": "drain"})]
        + [{"op": "swap", "checkpoint": ckpt}]
        + [o for r in (2, 5) for o in ({"op": "infer", "n": 1, "rows": r}, {"op": "drain"})]
        + [{"op": "rollback_check"}])],
    # two replicas, one killed and restarted between requests
    "replicas": lambda d, ckpt: ["--replicas", "2", "--script", _script(
        os.path.join(d, "replicas.jsonl"),
        [{"op": "infer", "n": 1, "rows": 2}, {"op": "drain"},
         {"op": "kill_replica", "slot": 0}, {"op": "infer", "n": 1, "rows": 1},
         {"op": "drain"}])],
}


@pytest.fixture
def jax_drain_waits_for_rows(monkeypatch):
    """JAX's ``drain`` returns once its lanes' queues are empty, which can be
    before the last dispatch's latency and row are recorded (a request
    leaves the queue before its answer, and its answer comes before its
    row), so the order of its rows after a drain is a race. The port's
    drain waits for both (``serving/microbatch.py`` ``idle``). For the JAX
    run, its drains wait likewise: each lane counts what it admitted and
    the requests of the dispatches whose row it wrote. This is the one place
    where the port's tests replace methods of the reference's serving, so
    each name it patches or reads is checked to exist, a drain that does not
    settle fails, and the fixture counts the patched drains for the test to
    check that the reference's CLI reached them."""
    patched = ((jmicrobatch.Microbatcher, "__init__"), (jmicrobatch.Microbatcher, "submit"),
               (jengine.InferenceEngine, "drain"), (jfleet.ReplicaSet, "drain"))
    for cls, name in patched:
        assert callable(cls.__dict__.get(name)), f"JAX's {cls.__name__}.{name} is gone"
    init, submit = jmicrobatch.Microbatcher.__init__, jmicrobatch.Microbatcher.submit
    drains = {"engine": 0, "fleet": 0}

    def counted_init(self, *a, **kw):
        init(self, *a, **kw)
        assert hasattr(self, "on_dispatch"), "JAX's Microbatcher has no on_dispatch"
        self.admitted = self.settled = 0
        on_dispatch = self.on_dispatch

        def settle(lane, batch, *rest):
            if on_dispatch is not None:
                on_dispatch(lane, batch, *rest)
            self.settled += len(batch)

        self.on_dispatch = settle

    def counted_submit(self, req):
        submit(self, req)  # a refused request raises before it counts
        self.admitted += 1

    def wait_idle(lanes, timeout):
        deadline = time.monotonic() + timeout
        while any(L.settled < L.admitted for L in lanes):
            assert time.monotonic() < deadline, "JAX's lanes never settled what they admitted"
            time.sleep(0.002)

    def engine_drain(self, timeout=30.0):
        drains["engine"] += 1
        wait_idle([L for L in (self._infer_lane, self._stream_lane) if L], timeout)

    def fleet_drain(self, timeout=30.0):
        drains["fleet"] += 1
        with self._lock:
            engines = [e for e in self._engines if e is not None]
        wait_idle([L for e in engines for L in (e._infer_lane, e._stream_lane) if L], timeout)

    monkeypatch.setattr(jmicrobatch.Microbatcher, "__init__", counted_init)
    monkeypatch.setattr(jmicrobatch.Microbatcher, "submit", counted_submit)
    monkeypatch.setattr(jengine.InferenceEngine, "drain", engine_drain)
    monkeypatch.setattr(jfleet.ReplicaSet, "drain", fleet_drain)
    return drains


@pytest.mark.parametrize("mode", sorted(MODES))
def test_both_clis_serve_one_port_written_checkpoint(fitted, mode, capsys,
                                                     jax_drain_waits_for_rows):
    tree, ckpt, root = fitted
    summaries, kinds, fired = [], [], []
    for name, mod, report, extra in (("ours", tserve, treport, ["--device", "cpu"]),
                                     ("theirs", jserve, jreport, [])):
        out = str(root / f"{mode}_{name}")
        os.makedirs(out, exist_ok=True)
        rc, lines = _run(mod, ["--data-path", tree, "--checkpoint", ckpt, "--out-dir", out,
                               "--max-delay-ms", "1"] + BUCKETS + MODES[mode](out, ckpt)
                         + extra, capsys)
        assert rc == 0
        summaries.append(lines[-1])
        kinds.append(_kinds(out))
        # each package's report on its own artifacts (the manifests' version
        # keys differ: torch and CUDA against jax and jaxlib)
        assert report.main(["--validate", os.path.join(out, "telemetry", "serving")]) == 0
        fired.append(lines[-2]["requests_fired"])
    # the reference's CLI drained through the patched methods
    assert jax_drain_waits_for_rows["fleet" if mode == "replicas" else "engine"] > 0
    ours, theirs = summaries
    assert ours["kind"] == theirs["kind"] == "serve_summary"
    assert ours["requests"] == theirs["requests"] and ours["compiles_after_warmup"] == 0
    assert fired[0] == fired[1]
    if mode != "replicas":  # a restarted replica's counts go with its engine
        assert ours["requests"] == fired[0]
    assert {p["device"] for p in ours.get("per_replica", [ours])} == {"cpu"}
    if mode == "smoke":
        assert ours["requests"] == 20 and ours["samples"] == theirs["samples"]
        assert set(kinds[0]) == set(kinds[1]) == {"dispatch", "serve_summary"}
    else:
        assert ours["dispatches"] == theirs["dispatches"]
        assert kinds[0] == kinds[1]
    if mode == "script":
        assert kinds[0].count("dispatch") == 5 and "publish" in kinds[0]
        assert kinds[0][-2:] == ["rollback", "serve_summary"]
    if mode == "replicas":
        assert ours["restarts"] == theirs["restarts"] == 1
        assert kinds[0].count("event") == 3  # two starts and the restart


def test_serving_cli_refusals(fitted, tmp_path):
    tree, ckpt, _ = fitted
    base = ["--data-path", tree, "--device", "cpu", "--out-dir", str(tmp_path)]
    for extra, match in (([], "exactly one of"),
                         (["--smoke", "1", "--script", "x"], "exactly one of"),
                         (["--smoke", "1"], "no checkpoint"),
                         (["--smoke", "1", "--sanitize", "bogus"], "--sanitize")):
        with pytest.raises(SystemExit, match=match):
            tserve.main(base + extra)
    bad = _script(str(tmp_path / "bad.jsonl"), [{"op": "teleport"}])
    with pytest.raises(SystemExit, match="unknown script op"):
        tserve.main(base + BUCKETS + ["--checkpoint", ckpt, "--script", bad, "--quiet"])
    kill = _script(str(tmp_path / "kill.jsonl"), [{"op": "kill_replica"}])
    with pytest.raises(SystemExit, match="--replicas > 1"):
        tserve.main(base + BUCKETS + ["--checkpoint", ckpt, "--script", kill, "--quiet"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine with no card")
def test_serving_cli_runs_on_the_card_unless_asked_for_the_cpu(fitted, tmp_path):
    tree, ckpt, _ = fitted
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--data-path", tree, "--checkpoint", ckpt, "--smoke", "1",
                     "--out-dir", str(tmp_path)])


def test_serving_cli_in_a_fresh_interpreter_imports_no_jax(fitted, tmp_path):
    """``python -m dinunet_implementations_tpu_torch.serving`` with
    ``--statusz-port 0``, run as the module's ``__main__``: rc 0, the
    endpoints' line, and neither JAX nor the JAX package imported."""
    tree, ckpt, _ = fitted
    args = ["--data-path", tree, "--checkpoint", ckpt, "--out-dir", str(tmp_path), "--smoke",
            "6", "--device", "cpu", "--statusz-port", "0"] + BUCKETS
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['serving'] + {args!r}\n"
        "try:\n"
        "    runpy.run_module('dinunet_implementations_tpu_torch.serving', run_name='__main__',"
        " alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'flax'"
        " or m == 'dinunet_implementations_tpu' or m.startswith('dinunet_implementations_tpu.')]\n"
        "assert rc == 0 and not bad, (rc, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    first = json.loads(proc.stdout.splitlines()[0])
    assert first["statusz"].startswith("http://127.0.0.1:")
    assert json.loads(proc.stdout.splitlines()[-1])["requests"] == 6
