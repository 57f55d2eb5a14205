"""Pod-scope metrics federation: the port's counterpart of the JAX
package's ``telemetry/collector.py`` (stdlib only), which discovers the
pod's workers, scrapes them and merges their snapshots exactly.

- **Discovery** (:func:`discover_targets`): scrape targets come from the
  supervisor's heartbeat files (``<out>/heartbeats/slice_<i>.json``). Each
  worker advertises its ``/statusz`` port in its own pulse
  (``Heartbeat.beat(statusz_port=...)``), so federation needs no extra
  configuration. A target counts only while its pid is alive and its
  scraped ``/statusz`` pid (and start time) match the heartbeat's.
- **Label stamping** (:func:`stamp_snapshot`): a scraped snapshot's gauge
  and histogram series take the target's ``{process=,slice=}``; stamping a
  label that a series already carries with a different value raises
  :class:`LabelCollisionError`, so no worker can pass for another.
- **Merging** (:func:`merge_snapshots`): counters sum, gauges union (an
  equal key with unequal values raises, which keeps the merge
  commutative), histograms merge exactly, so the pod's quantiles are the
  same whatever the merge tree.
- :class:`PodCollector` glues them together behind the ``MetricsBus`` read
  API (``snapshot()``, ``merged_histogram()``), so the port's
  :class:`~.exporter.StatusExporter` serves the pod's ``/statusz`` and
  ``/metrics`` unchanged.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

from .bus import series_key
from .hist import LogHistogram


class LabelCollisionError(ValueError):
    """Two series (or a series and a stamp) claim the same identity with
    different values: merging would corrupt attribution."""


# -- series-key parsing (the inverse of bus.series_key) -----------------------


def _unescape_label(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_series(key: str) -> tuple[str, dict]:
    """A rendered series key back into ``(name, labels)``: the exact
    inverse of :func:`~.bus.series_key`."""
    brace = key.find("{")
    if brace < 0:
        return key, {}
    name, blob = key[:brace], key[brace + 1:-1]
    labels: dict = {}
    i = 0
    while i < len(blob):
        eq = blob.find('="', i)
        if eq < 0:
            break
        k = blob[i:eq]
        j = eq + 2
        val = []
        while j < len(blob):
            c = blob[j]
            if c == "\\" and j + 1 < len(blob):
                val.append(blob[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        labels[k] = _unescape_label("".join(val))
        i = j + 2  # past the closing quote and the comma
    return name, labels


def _stamp_key(key: str, labels: dict) -> str:
    name, existing = parse_series(key)
    for k, v in labels.items():
        if k in existing and existing[k] != str(v):
            raise LabelCollisionError(f"series {key!r} already carries {k}={existing[k]!r}; "
                                      f"refusing to restamp as {v!r}")
    return series_key(name, {**existing, **{k: v for k, v in labels.items()
                                            if k not in existing}})


def stamp_snapshot(snap: dict, **labels) -> dict:
    """A bus snapshot with ``labels`` stamped onto every gauge and histogram
    key; counters stay as they are (they sum into pod totals). Raises
    :class:`LabelCollisionError` when a series already carries one of the
    labels with another value."""
    return {
        "counters": dict(snap.get("counters", {})),
        "gauges": {_stamp_key(k, labels): v for k, v in snap.get("gauges", {}).items()},
        "histograms": {_stamp_key(k, labels): dict(v)
                       for k, v in snap.get("histograms", {}).items()},
    }


# -- the exact merge ----------------------------------------------------------


def merge_snapshots(a: dict, b: dict) -> dict:
    """Two bus snapshots merged: counters summed, gauges unioned (an equal
    key with unequal values raises), histograms merged elementwise (a shape
    mismatch raises :class:`~.hist.HistogramShapeError`). Associative and
    commutative on integer counts."""
    counters = dict(a.get("counters", {}))
    for k, v in b.get("counters", {}).items():
        counters[k] = counters.get(k, 0) + v
    gauges = dict(a.get("gauges", {}))
    for k, v in b.get("gauges", {}).items():
        if k in gauges and gauges[k] != v:
            raise LabelCollisionError(
                f"gauge {k!r} published by two processes with different values "
                f"({gauges[k]!r} vs {v!r}) — stamp process labels before merging")
        gauges[k] = v
    hists = {k: dict(v) for k, v in a.get("histograms", {}).items()}
    for k, hd in b.get("histograms", {}).items():
        if k in hists:
            merged = LogHistogram.from_dict(hists[k])
            merged.merge(LogHistogram.from_dict(hd))
            hists[k] = merged.to_dict()
        else:
            hists[k] = dict(hd)
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def merged_histogram_of(snapshot: dict, name: str) -> LogHistogram | None:
    """Every label variant of ``name`` in a snapshot merged into one
    histogram: ``MetricsBus.merged_histogram`` over a plain snapshot."""
    parts = [LogHistogram.from_dict(hd) for key, hd in snapshot.get("histograms", {}).items()
             if key == name or key.startswith(name + "{")]
    if not parts:
        return None
    out = LogHistogram(parts[0].lo, parts[0].hi, parts[0].per_decade)
    for h in parts:
        out.merge(h)
    return out


# -- discovery and scraping ---------------------------------------------------

HEARTBEAT_DIR = "heartbeats"  # runner/supervisor.py's, restated: no runner import

#: a started_unix disagreement past this between heartbeat and /statusz is a
#: recycled pid wearing a dead worker's heartbeat, not clock jitter
START_TIME_SLOP_S = 60.0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists, just not ours to signal
    return True


def read_heartbeats(out_dir: str) -> list[dict]:
    """Every parseable pulse under ``<out_dir>/heartbeats/``."""
    hb_dir = os.path.join(out_dir, HEARTBEAT_DIR)
    try:
        names = sorted(n for n in os.listdir(hb_dir) if n.endswith(".json"))
    except OSError:
        return []
    out = []
    for n in names:
        try:
            with open(os.path.join(hb_dir, n)) as fh:
                out.append(json.load(fh))
        except (OSError, ValueError):
            continue
    return out


def discover_targets(out_dir: str) -> list[dict]:
    """The pulses that advertise a ``statusz_port`` and whose pid is alive;
    the scrape checks the endpoint's own pid and start time."""
    targets = []
    for hb in read_heartbeats(out_dir):
        pid = hb.get("pid")
        if hb.get("statusz_port") and isinstance(pid, int) and _pid_alive(pid):
            targets.append(hb)
    return targets


def scrape_statusz(port: int, timeout_s: float = 2.0, host: str = "127.0.0.1") -> dict:
    """One ``GET /statusz``: the whole JSON payload."""
    with urllib.request.urlopen(f"http://{host}:{port}/statusz", timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


class PodCollector:
    """The pod's per-process buses behind the ``MetricsBus`` read API.

    Each read runs discover, scrape, stamp and merge over the advertised
    targets and the optional ``local_bus`` (stamped with ``local_labels``),
    and caches the result for ``cache_s``: one ``/statusz`` request's SLO
    burn and snapshot see the same scrape, and a storm of scrapes cannot
    multiply against the workers. A target that cannot be reached or does
    not validate is skipped and listed in :meth:`status`, never fatal."""

    def __init__(self, out_dir: str, *, local_bus=None, local_labels: dict | None = None,
                 timeout_s: float = 2.0, cache_s: float = 0.5, status_extra=None):
        self.out_dir = out_dir
        self.local_bus = local_bus
        self.local_labels = dict(local_labels or {})
        self.timeout_s = timeout_s
        self.cache_s = cache_s
        self.status_extra = status_extra
        self._lock = threading.Lock()
        self._cached: dict | None = None
        self._cached_at = 0.0

    @staticmethod
    def _target_labels(hb: dict) -> dict:
        labels = {}
        if hb.get("process") is not None:
            labels["process"] = str(hb["process"])
        elif hb.get("pid") is not None:
            labels["process"] = f"pid{hb['pid']}"
        if hb.get("slice") is not None:
            labels["slice"] = str(hb["slice"])
        return labels

    @staticmethod
    def _validate(hb: dict, payload: dict) -> str | None:
        """None when the scraped endpoint is the heartbeat's writer, else
        why not."""
        if payload.get("pid") != hb.get("pid"):
            return f"pid mismatch: heartbeat {hb.get('pid')} vs statusz {payload.get('pid')}"
        hb_start = hb.get("started_unix")
        st_start = (payload.get("status") or {}).get("started_unix")
        if (isinstance(hb_start, (int, float)) and isinstance(st_start, (int, float))
                and abs(hb_start - st_start) > START_TIME_SLOP_S):
            return (f"start-time mismatch: heartbeat {hb_start:.0f} vs statusz "
                    f"{st_start:.0f} (recycled pid?)")
        return None

    def collect(self) -> dict:
        """Discover, scrape and merge now, uncached: ``{"snapshot",
        "targets", "errors"}``."""
        merged = {"counters": {}, "gauges": {}, "histograms": {}}
        targets, errors = [], []
        for hb in discover_targets(self.out_dir):
            where = f"slice {hb.get('slice')} pid {hb.get('pid')} port {hb.get('statusz_port')}"
            try:
                payload = scrape_statusz(int(hb["statusz_port"]), timeout_s=self.timeout_s)
            except (OSError, ValueError) as e:
                errors.append(f"{where}: scrape failed ({e})")
                continue
            bad = self._validate(hb, payload)
            if bad is not None:
                errors.append(f"{where}: {bad}")
                continue
            try:
                merged = merge_snapshots(merged, stamp_snapshot(
                    payload.get("metrics") or {}, **self._target_labels(hb)))
            except ValueError as e:  # LabelCollisionError, HistogramShapeError
                errors.append(f"{where}: {e}")
                continue
            targets.append({
                "pid": hb.get("pid"), "slice": hb.get("slice"), "process": hb.get("process"),
                "statusz_port": hb.get("statusz_port"), "epoch": hb.get("epoch"),
                "round": hb.get("round"), "heartbeat_unix": hb.get("time_unix"),
                "status": payload.get("status"),
            })
        if self.local_bus is not None:
            merged = merge_snapshots(merged, stamp_snapshot(self.local_bus.snapshot(),
                                                            **self.local_labels))
        # the collector's own vitals ride the snapshot, so /metrics reports
        # its coverage beside the data
        merged["gauges"][series_key("pod_scrape_targets", {})] = len(targets)
        merged["gauges"][series_key("pod_scrape_errors", {})] = len(errors)
        return {"snapshot": merged, "targets": targets, "errors": errors}

    def _collected(self) -> dict:
        with self._lock:
            now = time.monotonic()
            if self._cached is None or now - self._cached_at > self.cache_s:
                self._cached = self.collect()
                self._cached_at = now
            return self._cached

    def snapshot(self) -> dict:
        return self._collected()["snapshot"]

    def merged_histogram(self, name: str) -> LogHistogram | None:
        return merged_histogram_of(self._collected()["snapshot"], name)

    def status(self) -> dict:
        """The pod's ``/statusz`` status: the reachable targets, the scrape
        errors, and whatever ``status_extra`` adds (the scheduler's tenant
        table, say). The collector's own three keys win over the extra's:
        the JAX package lets the scheduler's ``"mode": "scheduler"``
        overwrite ``"pod"``, so its pod ``/statusz`` does not say it is
        one."""
        got = self._collected()
        out = {}
        if self.status_extra is not None:
            try:
                out.update(self.status_extra() or {})
            except Exception as e:  # a broken extra IS the finding
                out["status_extra_error"] = str(e)
        out.update(mode="pod", targets=got["targets"], scrape_errors=got["errors"])
        return out
