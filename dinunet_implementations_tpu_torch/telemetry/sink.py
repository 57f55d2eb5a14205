"""Per-fit telemetry artifacts: ``manifest.json``, ``metrics.jsonl`` and the
trace files. The port of the JAX package's ``telemetry/sink.py``.

One :class:`FitTelemetry` per fit (fold), rooted at
``<out_dir>/telemetry/fold_<k>/`` (or ``TrainConfig.telemetry_dir``):

- ``manifest.json``, written at open: config hash, torch and CUDA versions,
  backend and card, engine and task, git rev, package version, the active
  fault, attack and privacy plans. What exactly ran.
- ``metrics.jsonl``, appended as the fit runs (one line a record,
  crash-tolerant): per-epoch rows (loss, per-site gradient and residual
  norms, transfer bytes, epoch seconds, ε), instant events (checkpoint,
  preempted, dp-budget) and a final summary row.
- ``trace.jsonl`` / ``trace.chrome.json``: the span tracer's two forms,
  written at close (open the Chrome one in Perfetto).

The manifest keys are JAX's but for two: ``jax_version`` and
``jaxlib_version`` are ``torch_version`` and ``cuda_version`` (None on a
build without CUDA); ``backend`` is ``"cuda"`` or ``"cpu"`` and
``device_name`` names the card. The validators at the bottom are the schema
contract that the report CLI's ``--validate`` gates on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import numbers
import os
import subprocess

from .tracer import SpanTracer

SCHEMA_VERSION = 1

MANIFEST_FILE = "manifest.json"
METRICS_FILE = "metrics.jsonl"
TRACE_JSONL_FILE = "trace.jsonl"
TRACE_CHROME_FILE = "trace.chrome.json"

#: manifest keys every consumer may rely on: JAX's, with its two version
#: keys renamed. fault_plan / attack_plan / privacy / tags are null when
#: their plane is off
MANIFEST_REQUIRED = frozenset({
    "schema_version", "config_hash", "task_id", "agg_engine", "num_sites",
    "pipeline", "fold", "torch_version", "cuda_version", "backend", "mesh",
    "package_version", "git_rev", "fault_plan", "attack_plan", "privacy",
    "tags",
})

#: required metrics.jsonl keys by row kind (JAX's)
ROW_REQUIRED = {
    "epoch": frozenset({
        "kind", "fold", "epoch", "train_loss", "epoch_seconds",
        "transfer_bytes", "site_grad_sq_last", "site_grad_sq_sum",
        "site_residual_sq_sum", "update_sq_last", "payload_bytes",
        "dcn_bytes", "rounds",
        # spent ε so far, null while DP is off or noiseless
        "dp_epsilon",
    }),
    "event": frozenset({"kind", "name"}),
    "summary": frozenset({
        "kind", "fold", "epochs_run", "epoch_compiles", "best_val_epoch",
        # the elastic daemon's membership rollup; null for a batch fit
        "membership",
    }),
    "dispatch": frozenset({
        "kind", "lane", "bucket", "rows", "pad_rows", "queue_depth",
    }),
    "serve_summary": frozenset({
        "kind", "task_id", "requests", "samples", "dispatches",
        "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
        "requests_per_s", "samples_per_s", "pad_waste_pct",
        "bucket_hit_rate", "warmup_seconds", "compiles_after_warmup",
    }),
    "publish": frozenset({
        "kind", "digest", "outcome", "pause_ms", "shadow",
    }),
    "rollback": frozenset({
        "kind", "digest", "burn", "rolled_back", "window_samples",
    }),
}


def _finite(value):
    """Every non-finite real (numpy scalars too), nested in dicts and
    lists, as ``None``: the strict-JSON contract of :meth:`FitTelemetry.append`."""
    if isinstance(value, numbers.Real) and not isinstance(value, numbers.Integral):
        f = float(value)
        return f if math.isfinite(f) else None
    if isinstance(value, dict):
        return {k: _finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_finite(v) for v in value]
    return value


def _git_rev() -> str:
    """``git rev-parse HEAD`` of the code's checkout; "" outside one."""
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
                             text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def config_hash(cfg) -> str:
    """Stable hash of a TrainConfig (or any jsonable mapping or dataclass),
    JAX's: a config with the same fields hashes alike in both packages."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def privacy_manifest(cfg) -> dict | None:
    """The active privacy-plane configuration, verbatim (JAX's): ``None``
    when DP, secure aggregation and personalized heads are all off."""
    dp_clip = float(getattr(cfg, "dp_clip", 0.0) or 0.0)
    dp_noise = float(getattr(cfg, "dp_noise_multiplier", 0.0) or 0.0)
    secure = getattr(cfg, "secure_agg", "off") or "off"
    personalize = tuple(getattr(cfg, "personalize", ()) or ())
    if dp_clip <= 0.0 and dp_noise <= 0.0 and secure == "off" and not personalize:
        return None
    return {
        "dp_clip": dp_clip,
        "dp_noise_multiplier": dp_noise,
        "dp_seed": int(getattr(cfg, "dp_seed", 0) or 0),
        "dp_delta": float(getattr(cfg, "dp_delta", 1e-5)),
        "dp_epsilon_budget": float(getattr(cfg, "dp_epsilon_budget", 0.0) or 0.0),
        "secure_agg": secure,
        "secure_agg_seed": int(getattr(cfg, "secure_agg_seed", 0) or 0),
        "personalize": list(personalize),
    }


def build_manifest(cfg, fold: int = 0, fault_plan=None, attack_plan=None,
                   tags: dict | None = None, device=None) -> dict:
    """The manifest of one fit on ``device`` (a ``torch.device``, the CPU
    when None); ``mesh`` is None: one device, as JAX's vmap-folded fit."""
    import torch

    from .. import __version__

    dev = torch.device(device) if device is not None else torch.device("cpu")
    return {
        "schema_version": SCHEMA_VERSION,
        "config_hash": config_hash(cfg),
        "task_id": cfg.task_id,
        "agg_engine": cfg.agg_engine,
        "num_sites": int(getattr(cfg, "num_sites", 1)),
        "pipeline": cfg.pipeline,
        "fold": int(fold),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "mesh": None,
        "package_version": __version__,
        "git_rev": _git_rev(),
        "fault_plan": fault_plan.to_json() if fault_plan is not None else None,
        "attack_plan": attack_plan.to_json() if attack_plan is not None else None,
        "privacy": privacy_manifest(cfg),
        "tags": dict(tags) if tags else None,
        "config": cfg.to_dict(),
    }


class FitTelemetry:
    """The per-fit artifact sink. Construct through :meth:`open`; feed epoch
    rows and events as the fit runs; :meth:`close` writes the trace files
    (the trainer calls it from its ``finally``, so ``Preempted`` and
    crashes still leave complete artifacts)."""

    def __init__(self, dirpath: str, tracer: SpanTracer):
        self.dir = dirpath
        self.tracer = tracer
        self._closed = False
        os.makedirs(dirpath, exist_ok=True)

    @classmethod
    def open(cls, dirpath: str, cfg, fold: int = 0, tracer: SpanTracer | None = None,
             fault_plan=None, attack_plan=None, tags: dict | None = None,
             device=None) -> "FitTelemetry":
        sink = cls(dirpath, tracer or SpanTracer())
        manifest = build_manifest(cfg, fold=fold, fault_plan=fault_plan,
                                  attack_plan=attack_plan, tags=tags, device=device)
        with open(os.path.join(dirpath, MANIFEST_FILE), "w") as fh:
            json.dump(manifest, fh, indent=2, default=str)
        # a fresh fit of this fold starts its rows afresh; within one fit
        # they append crash-tolerantly
        open(os.path.join(dirpath, METRICS_FILE), "w").close()
        return sink

    def append(self, row: dict) -> None:
        """One metrics.jsonl record (kind: epoch | event | summary), strict
        RFC 8259 JSON: a non-finite float (what ``grad_sq_last`` and an
        all-dead epoch's loss carry by design) is written as ``null``."""
        if self._closed:
            return
        with open(os.path.join(self.dir, METRICS_FILE), "a") as fh:
            fh.write(json.dumps(_finite(row), default=float, allow_nan=False) + "\n")

    def event(self, name: str, **attrs) -> None:
        """An instant event, in both artifacts: the trace (its place on the
        timeline) and metrics.jsonl (next to the epoch rows)."""
        # a relay: each caller passes a literal name (checked there)
        self.tracer.event(name, **attrs)  # jaxlint: disable=R007
        self.append({"kind": "event", "name": name, **attrs})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.tracer.write_jsonl(os.path.join(self.dir, TRACE_JSONL_FILE))
        self.tracer.write_chrome_trace(os.path.join(self.dir, TRACE_CHROME_FILE))


# -- schema validation: the contract the report's --validate gates on --------


def validate_manifest(manifest: dict) -> list[str]:
    """Problems with a manifest dict ([] == valid)."""
    if not isinstance(manifest, dict):
        return [f"manifest is {type(manifest).__name__}, not an object"]
    problems = []
    missing = MANIFEST_REQUIRED - set(manifest)
    if missing:
        problems.append(f"manifest missing keys: {sorted(missing)}")
    if manifest.get("schema_version") not in (SCHEMA_VERSION,):
        problems.append(f"manifest schema_version {manifest.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    return problems


def validate_metrics_rows(rows: list[dict]) -> list[str]:
    """Problems with a metrics.jsonl row list ([] == valid); an unknown kind
    is one."""
    problems = []
    for i, row in enumerate(rows):
        kind = row.get("kind")
        required = ROW_REQUIRED.get(kind)
        if required is None:
            problems.append(f"row {i}: unknown kind {kind!r}")
            continue
        missing = required - set(row)
        if missing:
            problems.append(f"row {i} ({kind}): missing {sorted(missing)}")
    return problems


def load_metrics(path: str) -> list[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
