"""Run-summary CLI over the port's telemetry artifacts: the port of the JAX
package's ``telemetry/report.py``.

    python -m dinunet_implementations_tpu_torch.telemetry.report <dir> [<dir> ...] \\
        [--validate]

Each ``<dir>`` is a per-fit telemetry directory (``.../telemetry/fold_0``)
or a run-level ``telemetry/`` root (every ``fold_*`` child is summarized).
Several dirs render in order, and a per-tenant rollup table closes the
report (tenant from the manifest's ``tags``). Renders, per fit:

- the manifest header (engine, task, versions, backend and card, git rev);
- a phase time table from ``trace.jsonl`` (count / total / mean / max per
  span name);
- a per-site rollup from the last epoch row and the summary row (gradient
  and residual norms, skipped rounds, quarantine);
- counters: epoch compiles (kernel libraries built or loaded during the
  fit), transfer bytes an epoch, modeled payload bytes a round.

``--validate`` checks the artifacts against the schema contract
(telemetry/sink.py) instead of rendering, exiting 1 on any problem.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .sink import (
    MANIFEST_FILE,
    METRICS_FILE,
    TRACE_CHROME_FILE,
    TRACE_JSONL_FILE,
    load_metrics,
    validate_manifest,
    validate_metrics_rows,
)


def fit_dirs(path: str) -> list[str]:
    """Per-fit artifact dirs under ``path``: itself when it holds a
    manifest, else its ``fold_*`` children."""
    if os.path.exists(os.path.join(path, MANIFEST_FILE)):
        return [path]
    subs = sorted(
        os.path.join(path, d) for d in os.listdir(path)
        if (d.startswith("fold_") or d.startswith("serv"))
        and os.path.exists(os.path.join(path, d, MANIFEST_FILE))
    )
    if not subs:
        raise FileNotFoundError(
            f"{path}: no {MANIFEST_FILE} here or in fold_* children"
        )
    return subs


def _load_trace(dirpath: str) -> list[dict]:
    path = os.path.join(dirpath, TRACE_JSONL_FILE)
    if not os.path.exists(path):
        return []
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def phase_table(events: list[dict]) -> list[dict]:
    """Aggregate span durations by name (seconds), longest total first."""
    stats: dict[str, list[float]] = {}
    for e in events:
        if e.get("ph") == "X":
            stats.setdefault(e["name"], []).append(float(e["dur"]) / 1e6)
    return sorted(
        (
            {"phase": name, "count": len(ds), "total_s": sum(ds),
             "mean_ms": 1e3 * sum(ds) / len(ds), "max_ms": 1e3 * max(ds)}
            for name, ds in stats.items()
        ),
        key=lambda r: -r["total_s"],
    )


def _norm(sq) -> float:
    try:
        return math.sqrt(max(float(sq), 0.0))
    except (TypeError, ValueError):
        return float("nan")


def render_fit(dirpath: str) -> None:
    with open(os.path.join(dirpath, MANIFEST_FILE)) as fh:
        manifest = json.load(fh)
    rows = load_metrics(os.path.join(dirpath, METRICS_FILE))
    epochs = [r for r in rows if r.get("kind") == "epoch"]
    events = [r for r in rows if r.get("kind") == "event"]
    summary = next(
        (r for r in rows if r.get("kind") == "summary"), {}
    )
    mesh = manifest.get("mesh")
    print(f"== {dirpath}")
    print(
        f"run: {manifest.get('task_id')} · {manifest.get('agg_engine')} · "
        f"{manifest.get('num_sites')} sites · pipeline="
        f"{manifest.get('pipeline')} · fold {manifest.get('fold')}"
    )
    print(
        f"env: torch {manifest.get('torch_version')} / cuda "
        f"{manifest.get('cuda_version')} · backend "
        f"{manifest.get('backend')} ({manifest.get('device_name')}) · mesh "
        f"{mesh if mesh else 'one device'} · pkg "
        f"{manifest.get('package_version')} · git "
        f"{(manifest.get('git_rev') or 'n/a')[:12]} · cfg "
        f"{manifest.get('config_hash')}"
    )
    table = phase_table(_load_trace(dirpath))
    if table:
        print("-- phase time (from trace.jsonl)")
        print(f"{'phase':<22}{'count':>7}{'total s':>12}{'mean ms':>12}{'max ms':>12}")
        for r in table:
            print(
                f"{r['phase']:<22}{r['count']:>7}{r['total_s']:>12.3f}"
                f"{r['mean_ms']:>12.3f}{r['max_ms']:>12.3f}"
            )
    if epochs:
        last = epochs[-1]
        n_sites = len(last.get("site_grad_sq_last", []))
        skips = summary.get("site_skipped_rounds") or [0] * n_sites
        quar = summary.get("site_quarantined") or [0] * n_sites
        print(f"-- per-site rollup (epoch {last.get('epoch')}, last of "
              f"{len(epochs)} recorded)")
        print(f"{'site':>5}{'grad‖·‖ last':>14}{'grad‖·‖ mean':>14}"
              f"{'resid‖·‖':>11}{'skips':>7}{'quar':>6}")
        rounds = max(float(last.get("rounds", 1)), 1.0)
        for s in range(n_sites):
            print(
                f"{s:>5}"
                f"{_norm(last['site_grad_sq_last'][s]):>14.5f}"
                f"{_norm(last['site_grad_sq_sum'][s] / rounds):>14.5f}"
                f"{_norm(last['site_residual_sq_sum'][s] / rounds):>11.5f}"
                f"{skips[s] if s < len(skips) else 0:>7}"
                f"{quar[s] if s < len(quar) else 0:>6}"
            )
        print(
            f"-- counters: epoch_compiles="
            f"{summary.get('epoch_compiles', 'n/a')} · "
            f"transfer_bytes/epoch={last.get('transfer_bytes', 'n/a')} · "
            f"payload_bytes/round="
            f"{round(float(last.get('payload_bytes', 0)) / rounds)} · "
            f"dcn_bytes/round="
            f"{round(float(last.get('dcn_bytes', 0)) / rounds)} · "
            f"update‖·‖ last={_norm(last.get('update_sq_last', 0)):.5f}"
        )
        # the spent (ε, δ), whenever the manifest says a DP mechanism ran
        priv = manifest.get("privacy")
        if priv and priv.get("dp_noise_multiplier", 0) > 0:
            eps = last.get("dp_epsilon")
            eps_s = "inf" if eps is None else f"{float(eps):.4f}"
            print(
                f"-- privacy: ε={eps_s} at δ={priv.get('dp_delta')} "
                f"(σ={priv.get('dp_noise_multiplier')}, "
                f"C={priv.get('dp_clip')}, "
                f"budget={priv.get('dp_epsilon_budget') or 'none'}, "
                f"secure_agg={priv.get('secure_agg')}, "
                f"personalize={priv.get('personalize') or '[]'})"
            )
    serve = next(
        (r for r in rows if r.get("kind") == "serve_summary"), None
    )
    if serve:
        def ms(key):
            v = serve.get(key)
            return "n/a" if v is None else format(float(v), ".2f")

        print(
            "-- serving: "
            f"{serve.get('requests')} requests / "
            f"{serve.get('samples')} samples in "
            f"{serve.get('dispatches')} dispatches · latency ms "
            f"p50={ms('latency_ms_p50')} p95={ms('latency_ms_p95')} "
            f"p99={ms('latency_ms_p99')} · "
            f"{serve.get('requests_per_s')} req/s · "
            f"pad_waste={serve.get('pad_waste_pct')}% · "
            f"bucket_hit_rate={serve.get('bucket_hit_rate')} · "
            f"warmup={serve.get('warmup_seconds')}s · "
            f"compiles_after_warmup={serve.get('compiles_after_warmup')}"
        )
    membership = summary.get("membership")
    if membership:
        stale = membership.get("mean_staleness")
        print(
            "-- membership: "
            f"{membership.get('slots_occupied')}/"
            f"{membership.get('capacity')} slots occupied · "
            f"membership_epoch={membership.get('membership_epoch')} · "
            f"mean_staleness="
            f"{'n/a' if stale is None else format(stale, '.2f')} · "
            f"held_rounds={membership.get('held_rounds')}"
        )
    if events:
        counts: dict[str, int] = {}
        for e in events:
            counts[str(e.get("name"))] = counts.get(str(e.get("name")), 0) + 1
        print("-- events: " + ", ".join(f"{n}×{c}" for n, c in counts.items()))
    trace = os.path.join(dirpath, TRACE_CHROME_FILE)
    if os.path.exists(trace):
        print(f"-- trace: load {trace} in Perfetto (ui.perfetto.dev)")


def tenant_rollup(dirs: list[str]) -> list[dict]:
    """Per-tenant aggregate over many fit dirs. Tenancy comes from the
    manifest's ``tags.tenant``; untagged fits roll up under ``-``.
    Unreadable artifacts count as zeros rather than aborting the report (a
    fit may be mid-write)."""
    acc: dict[str, dict] = {}
    for d in dirs:
        try:
            with open(os.path.join(d, MANIFEST_FILE)) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError):
            manifest = {}
        try:
            rows = load_metrics(os.path.join(d, METRICS_FILE))
        except (OSError, json.JSONDecodeError):
            rows = []
        tenant = str((manifest.get("tags") or {}).get("tenant") or "-")
        epochs = [r for r in rows if r.get("kind") == "epoch"]
        summary = next(
            (r for r in rows if r.get("kind") == "summary"), {}
        )
        serve = next(
            (r for r in rows if r.get("kind") == "serve_summary"), {}
        )
        r = acc.setdefault(tenant, {
            "tenant": tenant, "fits": 0, "epochs": 0, "compiles": 0,
            "transfer_bytes": 0, "serve_requests": 0, "engines": set(),
        })
        r["fits"] += 1
        r["epochs"] += len(epochs)
        r["compiles"] += int(summary.get("epoch_compiles") or 0)
        r["transfer_bytes"] += sum(
            int(e.get("transfer_bytes") or 0) for e in epochs
        )
        r["serve_requests"] += int(serve.get("requests") or 0)
        if manifest.get("agg_engine"):
            r["engines"].add(str(manifest["agg_engine"]))
    return sorted(acc.values(), key=lambda r: r["tenant"])


def render_rollup(rows: list[dict]) -> None:
    print("== per-tenant rollup")
    print(f"{'tenant':<16}{'fits':>6}{'epochs':>8}{'compiles':>10}"
          f"{'xfer MiB':>10}{'serve req':>11}  engines")
    for r in rows:
        print(
            f"{r['tenant']:<16}{r['fits']:>6}{r['epochs']:>8}"
            f"{r['compiles']:>10}"
            f"{r['transfer_bytes'] / 2**20:>10.2f}"
            f"{r['serve_requests']:>11}  "
            f"{','.join(sorted(r['engines'])) or '-'}"
        )


def validate_fit(dirpath: str) -> list[str]:
    problems = []
    mpath = os.path.join(dirpath, MANIFEST_FILE)
    try:
        with open(mpath) as fh:
            problems += [f"{mpath}: {p}" for p in validate_manifest(json.load(fh))]
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"{mpath}: unreadable ({e})")
    rpath = os.path.join(dirpath, METRICS_FILE)
    try:
        problems += [
            f"{rpath}: {p}" for p in validate_metrics_rows(load_metrics(rpath))
        ]
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"{rpath}: unreadable ({e})")
    tpath = os.path.join(dirpath, TRACE_CHROME_FILE)
    try:
        with open(tpath) as fh:
            trace = json.load(fh)
        if not isinstance(trace.get("traceEvents"), list):
            problems.append(f"{tpath}: no traceEvents array")
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"{tpath}: unreadable ({e})")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dinunet_implementations_tpu_torch.telemetry.report",
        description="Render (or --validate) a run summary from telemetry "
                    "artifacts (manifest.json / metrics.jsonl / trace.*).",
    )
    p.add_argument("paths", nargs="+",
                   help="per-fit telemetry dirs (.../telemetry/fold_0) "
                        "and/or telemetry/ roots with fold_* children; "
                        "several dirs get a per-tenant rollup table")
    p.add_argument("--validate", action="store_true",
                   help="check artifacts against the schema contract "
                        "instead of rendering; exit 1 on any problem")
    args = p.parse_args(argv)
    dirs = [d for path in args.paths for d in fit_dirs(path)]
    if args.validate:
        problems = [p for d in dirs for p in validate_fit(d)]
        for prob in problems:
            print(prob, file=sys.stderr)
        print(f"telemetry: validated {len(dirs)} fit(s), "
              f"{len(problems)} problem(s)")
        return 1 if problems else 0
    for d in dirs:
        render_fit(d)
    if len(args.paths) > 1:
        render_rollup(tenant_rollup(dirs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
