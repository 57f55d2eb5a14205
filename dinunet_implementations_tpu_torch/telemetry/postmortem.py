"""One-command incident reconstruction: the port's counterpart of the JAX
package's ``telemetry/postmortem.py`` (stdlib only).

    python -m dinunet_implementations_tpu_torch.telemetry.postmortem <pod-dir> \\
        [--validate] [--json PATH] [--limit N]

A pod incident leaves its evidence in many files: flight dumps (one a
process, timestamps relative to each recorder's birth), heartbeats, the
slice-liveness spool, the supervisor's consensus decisions and the fleet
scheduler's grant log. This CLI merges them into one timeline ordered by
the wall clock.

Sources (each optional: the timeline is whatever evidence exists):

- ``flight_<pid>*.json``: the dump row itself (at ``time_unix``) and every
  ring event, on the wall clock as ``time_unix - uptime_s + ts/1e6``;
- ``heartbeats/slice_<i>.json``: each slice's last pulse;
- ``slice_liveness/ev*.json``: the death and revival spool;
- ``consensus/decision_gen<g>.json``: the round and digest installed as the
  fleet's resume point after each death;
- ``grants.jsonl``: the fleet scheduler's grant log (runner/scheduler.py).

A timeline row has ``t_unix`` (a finite float), ``source`` and ``event``
(strings) and free attributes. ``--validate`` checks that schema and that
the incident can be told: every slice death names its slice and is
followed by a revival with a restart generation (or a give-up), and a
persisted consensus decision carries the agreed round; it exits 1 when the
story cannot be told.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from .flight import flight_files

LIVENESS_DIR = "slice_liveness"   # runner/supervisor.py's
CONSENSUS_DIR = "consensus"       # the supervisor's on_consensus writes it
GRANTS_FILE = "grants.jsonl"      # written by runner/scheduler.py
HEARTBEAT_DIR = "heartbeats"

#: ring-event attrs promoted into timeline rows (the rest stay behind the
#: flight dump itself — the timeline is a narrative, not a dump mirror)
_FLIGHT_ATTRS = (
    "slice", "process", "reason", "heartbeat_age_s", "generation",
    "round", "epoch", "sha", "replaced", "restarts", "rc", "signum",
    "error", "processes", "after_slice",
)


def _read_json_dir(dirpath: str) -> list[tuple[str, dict]]:
    try:
        names = sorted(n for n in os.listdir(dirpath) if n.endswith(".json"))
    except OSError:
        return []
    out = []
    for n in names:
        try:
            with open(os.path.join(dirpath, n)) as fh:
                out.append((n, json.load(fh)))
        except (OSError, json.JSONDecodeError, ValueError):
            continue
    return out


def _flight_rows(pod_dir: str) -> list[dict]:
    rows = []
    for path in flight_files(pod_dir):
        try:
            with open(path) as fh:
                dump = json.load(fh)
        except (OSError, json.JSONDecodeError, ValueError):
            continue
        pid = dump.get("pid")
        t_dump = dump.get("time_unix")
        if not isinstance(t_dump, (int, float)):
            continue
        source = f"flight:{pid}"
        # the recorder's birth on the wall clock anchors every ring ts
        t0 = t_dump - float(dump.get("uptime_s") or 0.0)
        for ev in dump.get("events") or []:
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            row = {
                "t_unix": t0 + ts / 1e6,
                "source": source,
                "event": str(ev.get("name", "?")),
            }
            row.update({
                k: ev[k] for k in _FLIGHT_ATTRS if k in ev
            })
            rows.append(row)
        rows.append({
            "t_unix": float(t_dump),
            "source": source,
            "event": "flight-dump",
            "reason": dump.get("reason"),
            "file": os.path.basename(path),
        })
    return rows


def _heartbeat_rows(pod_dir: str) -> list[dict]:
    rows = []
    for _n, hb in _read_json_dir(os.path.join(pod_dir, HEARTBEAT_DIR)):
        t = hb.get("time_unix")
        if not isinstance(t, (int, float)):
            continue
        rows.append({
            "t_unix": float(t),
            "source": "heartbeat",
            "event": "last-pulse",
            "slice": hb.get("slice"),
            "pid": hb.get("pid"),
            "epoch": hb.get("epoch"),
            "round": hb.get("round"),
            "statusz_port": hb.get("statusz_port"),
        })
    return rows


def _liveness_rows(pod_dir: str) -> list[dict]:
    rows = []
    for _n, ev in _read_json_dir(os.path.join(pod_dir, LIVENESS_DIR)):
        t = ev.get("time_unix")
        if not isinstance(t, (int, float)):
            continue
        rows.append({
            "t_unix": float(t),
            "source": "liveness",
            "event": str(ev.get("event", "?")),
            "slice": ev.get("slice"),
            "reason": ev.get("reason"),
            "heartbeat_age_s": ev.get("heartbeat_age_s"),
            "generation": ev.get("generation"),
        })
    return rows


def _consensus_rows(pod_dir: str) -> list[dict]:
    rows = []
    for _n, dec in _read_json_dir(os.path.join(pod_dir, CONSENSUS_DIR)):
        t = dec.get("time_unix")
        if not isinstance(t, (int, float)):
            continue
        rows.append({
            "t_unix": float(t),
            "source": "consensus",
            "event": "agreed" if dec.get("round") is not None else "none",
            "generation": dec.get("generation"),
            "dead_slice": dec.get("dead_slice"),
            "round": dec.get("round"),
            "epoch": dec.get("epoch"),
            "sha": dec.get("sha"),
            "replaced": dec.get("replaced"),
        })
    return rows


def _grant_rows(pod_dir: str) -> list[dict]:
    path = os.path.join(pod_dir, GRANTS_FILE)
    rows = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        t = rec.get("time_unix")
        if not isinstance(t, (int, float)):
            continue
        rows.append({
            "t_unix": float(t),
            "source": "scheduler",
            "event": "grants",
            "tick": rec.get("tick"),
            "grants": rec.get("grants"),
            "preempt_pause_ms": rec.get("preempt_pause_ms"),
        })
    return rows


def build_timeline(pod_dir: str) -> list[dict]:
    """Every evidence row under ``pod_dir``, wall-clock ordered (stable
    sort: same-instant rows keep source order)."""
    rows = (
        _flight_rows(pod_dir) + _heartbeat_rows(pod_dir)
        + _liveness_rows(pod_dir) + _consensus_rows(pod_dir)
        + _grant_rows(pod_dir)
    )
    rows.sort(key=lambda r: r["t_unix"])
    return rows


def incident_summary(rows: list[dict]) -> dict:
    """The reconstructed incident: which slice died (first death), which
    consensus round the fleet resumed from, and the restart generation
    that revived it — the three facts an operator asks first."""
    deaths = [r for r in rows if r["source"] == "liveness"
              and r["event"] == "dead"]
    revivals = [r for r in rows if r["source"] == "liveness"
                and r["event"] == "alive"]
    decisions = [r for r in rows if r["source"] == "consensus"]
    agreed = [r for r in decisions if r["event"] == "agreed"]
    return {
        "deaths": len(deaths),
        "killed_slice": deaths[0].get("slice") if deaths else None,
        "death_reason": deaths[0].get("reason") if deaths else None,
        "consensus_round": agreed[-1].get("round") if agreed else None,
        "consensus_sha": agreed[-1].get("sha") if agreed else None,
        "restart_generation": (
            max(
                (r.get("generation") for r in revivals
                 if isinstance(r.get("generation"), int)),
                default=None,
            )
        ),
    }


def validate_timeline(rows: list[dict]) -> list[str]:
    """Schema + story problems (module docstring); empty means valid."""
    problems = []
    if not rows:
        problems.append("timeline is empty: no evidence found under the "
                        "pod dir")
    last_t = None
    for i, r in enumerate(rows):
        t = r.get("t_unix")
        if not isinstance(t, (int, float)) or not math.isfinite(t):
            problems.append(f"row {i}: t_unix {t!r} is not a finite number")
            continue
        if not isinstance(r.get("source"), str) or not r["source"]:
            problems.append(f"row {i}: missing source")
        if not isinstance(r.get("event"), str) or not r["event"]:
            problems.append(f"row {i}: missing event")
        if last_t is not None and t < last_t:
            problems.append(f"row {i}: timeline not ordered "
                            f"({t} after {last_t})")
        last_t = t
    # incident reconstruction: every death must be narratable
    deaths = [r for r in rows if r.get("source") == "liveness"
              and r.get("event") == "dead"]
    revivals = [r for r in rows if r.get("source") == "liveness"
                and r.get("event") == "alive"]
    decisions = [r for r in rows if r.get("source") == "consensus"]
    for d in deaths:
        if d.get("slice") is None:
            problems.append("a death event names no slice")
    if deaths and not revivals and not any(
        r.get("event") == "supervisor-give-up" for r in rows
    ):
        problems.append("slice death(s) recorded but no revival and no "
                        "give-up — the story has no ending")
    if revivals and not any(
        isinstance(r.get("generation"), int) for r in revivals
    ):
        problems.append("revival(s) carry no restart generation")
    if decisions and deaths and not any(
        r.get("event") == "agreed" and r.get("round") is not None
        for r in decisions
    ):
        problems.append("consensus decisions present but none carries an "
                        "agreed round")
    return problems


def _fmt_attrs(row: dict) -> str:
    skip = ("t_unix", "source", "event")
    parts = []
    for k, v in row.items():
        if k in skip or v is None:
            continue
        if isinstance(v, float):
            v = round(v, 3)
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render(rows: list[dict], limit: int | None = None) -> None:
    if not rows:
        print("(empty timeline)")
        return
    t0 = rows[0]["t_unix"]
    start = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(t0))
    print(f"incident timeline: {len(rows)} events from {start} "
          f"(+{rows[-1]['t_unix'] - t0:.1f}s)")
    shown = rows if limit is None else rows[-limit:]
    if len(shown) < len(rows):
        print(f"  ... {len(rows) - len(shown)} earlier events elided "
              f"(--limit)")
    for r in shown:
        print(f"  +{r['t_unix'] - t0:9.3f}s  {r['source']:<12} "
              f"{r['event']:<20} {_fmt_attrs(r)}")
    inc = incident_summary(rows)
    if inc["deaths"]:
        print(
            f"incident: slice {inc['killed_slice']} died "
            f"({inc['death_reason']}); consensus round "
            f"{inc['consensus_round']} installed; revived at generation "
            f"{inc['restart_generation']}"
        )
    else:
        print("incident: none recorded (no slice deaths)")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dinunet_implementations_tpu_torch.telemetry.postmortem",
        description="Reconstruct one ordered incident timeline from a pod "
                    "directory's flight dumps, heartbeats, liveness "
                    "spool, consensus decisions and grant log.",
    )
    p.add_argument("pod_dir", help="a supervised run's --out-dir (or a "
                                   "scheduler root)")
    p.add_argument("--validate", action="store_true",
                   help="check the timeline schema and that every "
                        "recorded incident reconstructs (named slice, "
                        "revival generation, consensus round); exit 1 on "
                        "any problem — the CI chaos-drill gate")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write {rows, incident} as JSON")
    p.add_argument("--limit", type=int, default=None,
                   help="render only the last N rows")
    args = p.parse_args(argv)
    rows = build_timeline(args.pod_dir)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(
                {"rows": rows, "incident": incident_summary(rows)}, fh
            )
    if args.validate:
        problems = validate_timeline(rows)
        for prob in problems:
            print(prob, file=sys.stderr)
        inc = incident_summary(rows)
        print(
            f"postmortem: {len(rows)} rows, {inc['deaths']} death(s), "
            f"killed_slice={inc['killed_slice']}, "
            f"consensus_round={inc['consensus_round']}, "
            f"restart_generation={inc['restart_generation']}, "
            f"{len(problems)} problem(s)"
        )
        return 1 if problems else 0
    render(rows, limit=args.limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
