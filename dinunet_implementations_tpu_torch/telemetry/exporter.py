"""Live observability endpoints ``/metrics``, ``/healthz``, ``/statusz`` and
``/tracez``: the port's own copy of the JAX package's
``telemetry/exporter.py`` (stdlib only).

A :class:`StatusExporter` wraps a ``ThreadingHTTPServer``, so a RUNNING
daemon or serving engine can be asked what it is doing. It runs behind
``--statusz-port`` on the daemon CLI (``runner.cli --serve``) and the
serving CLI (``python -m dinunet_implementations_tpu_torch.serving``):

- ``GET /metrics``: the Prometheus text exposition (version 0.0.4) of the
  ``MetricsBus``: counters, gauges and log-histograms (cumulative
  ``_bucket`` series with ``_sum`` and ``_count``). Names are sanitized and
  prefixed ``dinunet_``.
- ``GET /healthz``: readiness by subsystem. Each probe is a callable that
  returns truthy (ready) or falsey (not ready), or raises (broken, and its
  error is the finding). 200 when all are ready, 503 otherwise, a JSON body
  either way.
- ``GET /statusz``: one JSON snapshot: uptime, pid, the bus snapshot, the
  caller's status dict, and the SLO error-budget burn of the configured
  latency histogram against its p99 target (:func:`slo_burn`).
- ``GET /tracez``: the newest spans and events (the flight recorder's ring
  when one is attached, else the tracer's tail).

The server runs on daemon threads and binds 127.0.0.1; ``port=0`` picks a
free port (:meth:`StatusExporter.start` returns it). The handlers only READ
(bus snapshots, probe calls): a scrape cannot change the service.

:data:`SLO_BUDGET` and :func:`slo_burn` are also what the publish
controller's rollback watch (serving/publish.py) and the autotuner's budget
(serving/admission.py) read.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .hist import LogHistogram

#: the Prometheus metric-name charset; everything else becomes "_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
#: default SLO: fraction of requests allowed over the p99 target
SLO_BUDGET = 0.01

METRIC_PREFIX = "dinunet_"
ENDPOINTS = ["/metrics", "/healthz", "/statusz", "/tracez"]


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return METRIC_PREFIX + name


def _split_series(key: str) -> tuple[str, str]:
    """A bus series key back into (name, "{labels}" or "")."""
    brace = key.find("{")
    if brace < 0:
        return key, ""
    return key[:brace], key[brace:]


def _prom_value(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not f.is_integer() else str(int(f))


def _merge_labels(labels: str, extra: str) -> str:
    """``extra`` (e.g. ``le="0.5"``) appended into a ``{...}`` label blob."""
    if not labels:
        return "{" + extra + "}"
    return labels[:-1] + "," + extra + "}"


def render_prometheus(snapshot: dict) -> str:
    """The Prometheus text exposition (0.0.4) of a bus snapshot, a pure
    function of the snapshot."""
    lines: list[str] = []
    typed: set[str] = set()

    def type_line(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, val in sorted(snapshot.get("counters", {}).items()):
        name, labels = _split_series(key)
        pname = _prom_name(name)
        type_line(pname, "counter")
        lines.append(f"{pname}{labels} {_prom_value(val)}")
    for key, val in sorted(snapshot.get("gauges", {}).items()):
        name, labels = _split_series(key)
        pname = _prom_name(name)
        type_line(pname, "gauge")
        lines.append(f"{pname}{labels} {_prom_value(val)}")
    for key, hd in sorted(snapshot.get("histograms", {}).items()):
        name, labels = _split_series(key)
        pname = _prom_name(name)
        type_line(pname, "histogram")
        hist = LogHistogram.from_dict(hd)
        for le, cum in hist.cumulative():
            le_s = "+Inf" if math.isinf(le) else _prom_value(le)
            le_label = _merge_labels(labels, 'le="' + le_s + '"')
            lines.append(f"{pname}_bucket{le_label} {cum}")
        lines.append(f"{pname}_sum{labels} {_prom_value(hist.sum)}")
        lines.append(f"{pname}_count{labels} {hist.count}")
    return "\n".join(lines) + "\n"


def slo_burn(hist: LogHistogram | None, p99_target: float,
             budget: float = SLO_BUDGET) -> dict:
    """Error-budget burn of a latency histogram against a p99 target.

    The SLO is "``(1 - budget)`` of samples at or under ``p99_target``"
    (budget defaults to 1%, i.e. a p99 objective). ``burn`` is the
    violation rate over the allowed rate: 1.0 = burning exactly the budget,
    <1 healthy, >1 violating. Violations come from
    :meth:`~.hist.LogHistogram.over` (buckets certainly above the target),
    so the burn never overstates; ``p99_observed`` is the histogram's
    upper-edge estimate (conservative the other way)."""
    if hist is None or hist.count == 0:
        return {
            "p99_target": p99_target, "budget": budget, "samples": 0,
            "violations": 0, "violation_rate": None, "burn": None,
            "p99_observed": None,
        }
    over = hist.over(p99_target)
    rate = over / hist.count
    return {
        "p99_target": p99_target,
        "budget": budget,
        "samples": hist.count,
        "violations": over,
        "violation_rate": round(rate, 6),
        "burn": round(rate / budget, 4),
        "p99_observed": hist.quantile(0.99),
    }


class StatusExporter:
    """See the module docstring.

    ``bus``: a ``MetricsBus`` (or anything with its ``snapshot`` and
    ``merged_histogram``). ``health``: ``{subsystem: callable}`` readiness
    probes. ``statusz``: a callable returning the caller's live status dict
    (the ``status`` key of ``/statusz``). ``slo``: ``{"histogram": bus
    series NAME, "p99_target_ms": float}``, the latency series the burn is
    computed over (every label variant merged). ``tracer`` and ``flight``
    feed ``/tracez``."""

    def __init__(self, bus, *, port: int = 0, host: str = "127.0.0.1", tracer=None,
                 flight=None, health: dict | None = None, statusz=None,
                 slo: dict | None = None, tracez_limit: int = 256):
        self.bus = bus
        self.tracer = tracer
        self.flight = flight
        self.health = dict(health or {})
        self.statusz = statusz
        self.slo = dict(slo or {})
        self.tracez_limit = tracez_limit
        self._host = host
        self._port = port
        self._t0 = time.monotonic()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- the payloads ----------------------------------------------------------

    def metrics_text(self) -> str:
        return render_prometheus(self.bus.snapshot())

    def healthz(self) -> tuple[int, dict]:
        subsystems = {}
        ok = True
        for name, probe in self.health.items():
            try:
                ready = bool(probe())
                subsystems[name] = {"ready": ready}
            except Exception as e:  # a broken probe IS the finding
                ready = False
                subsystems[name] = {"ready": False, "error": str(e)}
            ok &= ready
        return (200 if ok else 503), {"status": "ok" if ok else "unavailable",
                                      "subsystems": subsystems}

    def slo_status(self) -> dict | None:
        if not self.slo:
            return None
        hist = self.bus.merged_histogram(self.slo.get("histogram", ""))
        return {"histogram": self.slo.get("histogram"),
                **slo_burn(hist, float(self.slo.get("p99_target_ms", 0.0)),
                           float(self.slo.get("budget", SLO_BUDGET)))}

    def statusz_payload(self) -> dict:
        payload = {"pid": os.getpid(), "uptime_s": round(time.monotonic() - self._t0, 3),
                   "slo": self.slo_status(), "metrics": self.bus.snapshot()}
        if self.statusz is not None:
            try:
                payload["status"] = self.statusz()
            except Exception as e:
                payload["status"] = {"error": str(e)}
        return payload

    def tracez_payload(self) -> dict:
        if self.flight is not None:
            events = self.flight.recent(self.tracez_limit)
        elif self.tracer is not None:
            events = self.tracer.events()[-self.tracez_limit:]
        else:
            events = []
        return {"recent": events, "count": len(events)}

    # -- HTTP ----------------------------------------------------------------

    def _handler_class(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # a scrape is not a log line
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, payload: dict) -> None:
                from .sink import _finite

                self._send(code, json.dumps(_finite(payload), default=str,
                                            allow_nan=False).encode(), "application/json")

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/statusz"
                try:
                    if path == "/metrics":
                        self._send(200, exporter.metrics_text().encode(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        self._json(*exporter.healthz())
                    elif path == "/statusz":
                        self._json(200, exporter.statusz_payload())
                    elif path == "/tracez":
                        self._json(200, exporter.tracez_payload())
                    else:
                        self._json(404, {"error": f"unknown path {path!r}",
                                         "endpoints": ENDPOINTS})
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the scraper went away mid-response

        return Handler

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        if self._server is not None:
            return self._port
        self._server = ThreadingHTTPServer((self._host, self._port), self._handler_class())
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="statusz-exporter", daemon=True)
        self._thread.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def url(self, path: str = "/statusz") -> str:
        return f"http://{self._host}:{self._port}{path}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StatusExporter":
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
