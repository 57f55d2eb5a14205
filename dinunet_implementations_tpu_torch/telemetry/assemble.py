"""Cross-process trace assembly: the port's counterpart of the JAX
package's ``telemetry/assemble.py`` (stdlib only).

    python -m dinunet_implementations_tpu_torch.telemetry.assemble <pod-dir> \\
        [--out pod_trace/pod.chrome.json] [--require-cross-process]

Every process's ``SpanTracer`` stamps its events relative to its own
monotonic birth (``time.perf_counter``), so per-process ``trace.jsonl``
files cannot be overlaid as they are. This module aligns them onto the wall
clock and writes one Chrome trace-event JSON (loadable in Perfetto) in
which a sample can be followed across processes by its trace id.

Clock alignment, in order of preference:

1. **Heartbeat offsets**: each heartbeat pulse samples ``perf`` and
   ``time_unix`` back to back, so ``time_unix - perf`` is that process's
   monotonic-to-wall offset; an event's wall time is
   ``offset + t0_perf + ts/1e6`` (``t0_perf`` from the trace's
   ``clock_sync`` row). The offset is measured fresh every pulse.
2. **The clock_sync row alone**: ``t0_unix + ts/1e6``, so a trace file
   assembles without the pod's heartbeat directory.

Trace files are found under ``<pod-dir>/pod_trace/*.jsonl`` (the supervised
workers' traces) and as any ``trace.jsonl`` below ``<pod-dir>/telemetry/``
(a fit's sink). Output timestamps are rebased to the earliest aligned event,
one Perfetto process row per source pid.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .collector import read_heartbeats

POD_TRACE_DIR = "pod_trace"
POD_TRACE_FILE = "pod.chrome.json"
CLOCK_SYNC = "clock_sync"


def clock_offsets(pod_dir: str) -> dict[int, float]:
    """Per-pid monotonic→wall offsets from the pod's heartbeat files
    (``time_unix - perf``, both sampled in the same ``beat()``)."""
    out: dict[int, float] = {}
    for hb in read_heartbeats(pod_dir):
        pid, perf, unix = hb.get("pid"), hb.get("perf"), hb.get("time_unix")
        if (isinstance(pid, int) and isinstance(perf, (int, float))
                and isinstance(unix, (int, float))):
            out[pid] = unix - perf
    return out


def find_trace_files(pod_dir: str) -> list[str]:
    """Per-process trace.jsonl files under the pod dir (module
    docstring), sorted for deterministic assembly order."""
    found = []
    pt = os.path.join(pod_dir, POD_TRACE_DIR)
    try:
        found += [
            os.path.join(pt, n) for n in os.listdir(pt)
            if n.endswith(".jsonl")
        ]
    except OSError:
        pass
    tel = os.path.join(pod_dir, "telemetry")
    for root, _dirs, names in os.walk(tel):
        found += [
            os.path.join(root, n) for n in names if n == "trace.jsonl"
        ]
    return sorted(found)


def load_trace(path: str) -> tuple[dict | None, list[dict]]:
    """``(clock_sync_row | None, events)`` from one trace.jsonl."""
    clock = None
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("ph") == "M" and ev.get("name") == CLOCK_SYNC:
                clock = ev
            else:
                events.append(ev)
    return clock, events


def align_unix_us(ts_us: float, clock: dict,
                  offset: float | None = None) -> float:
    """An event's wall-clock time in µs-since-epoch, from its tracer-
    relative ``ts``: via the heartbeat-exchanged ``offset`` when one is
    known for this pid (preferred — measured fresh each pulse), else via
    the clock_sync row's own wall sample."""
    if offset is not None and isinstance(clock.get("t0_perf"),
                                         (int, float)):
        return (offset + clock["t0_perf"]) * 1e6 + ts_us
    return float(clock.get("t0_unix", 0.0)) * 1e6 + ts_us


def assemble(pod_dir: str, out_path: str | None = None) -> dict:
    """Build (and optionally write) the merged Chrome trace payload. Each
    source file becomes one Perfetto process row (pid from its clock_sync
    row, process_name from the file name); events keep their span attrs —
    trace ids included — in ``args``."""
    offsets = clock_offsets(pod_dir)
    out_events: list[dict] = []
    sources = []
    t_min = None
    pod_pids: set[int] = set()
    pod_prefix = os.path.join(pod_dir, POD_TRACE_DIR) + os.sep
    for path in find_trace_files(pod_dir):
        clock, events = load_trace(path)
        if clock is None or not events:
            continue
        pid = int(clock.get("pid", 0))
        # a supervised worker writes the SAME tracer buffer twice: its
        # pod_trace/ file and its per-fit telemetry sink. pod_trace/
        # sorts first; skip the sink copy rather than double every span
        # (same-pid sinks from different folds still all assemble)
        if path.startswith(pod_prefix):
            pod_pids.add(pid)
        elif pid in pod_pids:
            sources.append({
                "path": path, "pid": pid, "events": 0,
                "aligned_by": "skipped:duplicate-of-pod-trace",
            })
            continue
        offset = offsets.get(pid)
        aligned = []
        for ev in events:
            if "ts" not in ev:
                continue
            t = align_unix_us(float(ev["ts"]), clock, offset)
            aligned.append((t, ev))
            t_min = t if t_min is None else min(t_min, t)
        sources.append({
            "path": path, "pid": pid, "events": len(aligned),
            "aligned_by": "heartbeat" if offset is not None else CLOCK_SYNC,
        })
        name = os.path.splitext(os.path.basename(path))[0]
        out_events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        for t, ev in aligned:
            rec = {
                "ph": ev.get("ph", "i"),
                "name": ev.get("name", "?"),
                "ts": t,  # rebased below once t_min is known
                "pid": pid,
                "tid": ev.get("tid", 0),
            }
            if ev.get("ph") == "X":
                rec["dur"] = round(float(ev.get("dur", 0.0)), 3)
            if ev.get("ph") == "i":
                rec["s"] = "t"
            args = {
                k: v for k, v in ev.items()
                if k not in ("ph", "name", "ts", "dur", "tid", "thread",
                             "depth")
            }
            if args:
                rec["args"] = args
            out_events.append(rec)
    base = t_min or 0.0
    for rec in out_events:
        if "ts" in rec:
            rec["ts"] = round(rec["ts"] - base, 3)
    payload = {
        "traceEvents": out_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "pod_dir": pod_dir,
            "t0_unix": base / 1e6,
            "sources": sources,
        },
    }
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, out_path)
    return payload


def processes_by_trace(payload: dict) -> dict[str, set]:
    """``{trace_id: {pids}}`` over the assembled events — the
    cross-process-visibility assertion CI gates on (≥ 2 pids sharing a
    trace id means one sample really is followable across the pod)."""
    out: dict[str, set] = {}
    for ev in payload.get("traceEvents", []):
        trace = (ev.get("args") or {}).get("trace")
        if trace:
            out.setdefault(str(trace), set()).add(ev.get("pid"))
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dinunet_implementations_tpu_torch.telemetry.assemble",
        description="Assemble per-process trace.jsonl files into one "
                    "clock-aligned Perfetto timeline.",
    )
    p.add_argument("pod_dir", help="a supervised run's --out-dir (holds "
                                   "pod_trace/ and/or telemetry/, plus "
                                   "heartbeats/ for clock offsets)")
    p.add_argument("--out", default=None,
                   help=f"output path (default <pod-dir>/{POD_TRACE_DIR}/"
                        f"{POD_TRACE_FILE})")
    p.add_argument("--require-cross-process", action="store_true",
                   help="exit 1 unless at least one trace id spans >= 2 "
                        "processes (the CI gate)")
    args = p.parse_args(argv)
    out = args.out or os.path.join(
        args.pod_dir, POD_TRACE_DIR, POD_TRACE_FILE
    )
    payload = assemble(args.pod_dir, out)
    srcs = payload["metadata"]["sources"]
    shared = {
        t: sorted(str(p_) for p_ in pids)
        for t, pids in processes_by_trace(payload).items()
        if len(pids) >= 2
    }
    print(
        f"pod trace: {len(srcs)} source file(s), "
        f"{sum(s['events'] for s in srcs)} events, "
        f"{len(shared)} trace id(s) spanning >=2 processes -> {out}"
    )
    for s in srcs:
        print(f"  {s['path']}: pid {s['pid']}, {s['events']} events, "
              f"clock via {s['aligned_by']}")
    for t, pids in sorted(shared.items()):
        print(f"  trace {t}: processes {', '.join(pids)}")
    if args.require_cross_process and not shared:
        print("assemble: no trace id spans two processes", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
