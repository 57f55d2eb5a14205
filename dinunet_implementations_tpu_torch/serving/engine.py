"""InferenceEngine: continuously batched serving of a trained model of a
ported task (MSANNet, ICA-LSTM, SMRI3DNet, MultimodalNet), with an O(1)
streaming lane and hot-swaps
of its weights.

The counterpart of the JAX package's ``serving/engine.py``. Three lanes of
work share one engine:

- **The batched lane.** Requests of ``[n, *sample_shape]`` rows go through
  the microbatcher, which pads each dispatch to the smallest row bucket
  that fits (weight-0 pad rows) and runs the task's
  :func:`~..trainer.steps.eval_forward`, the trainer's own eval forward,
  once on the device. On the card the ICA-LSTM forward runs the LSTM
  recurrence kernel (K1) once per direction. MSANNet's and SMRI3DNet's
  BatchNorms normalize by the batch moments in eval too: the mask keeps
  the pad rows out of them, so a served answer depends on the real rows
  that share its dispatch, as in JAX.
- **The streaming lane** (the unidirectional ICA-LSTM only). Each session
  keeps its ``(h, c, pooled, count)`` carry in a device-resident
  ``[slots+1, …]`` table (serving/session.py); a dispatch gathers carries
  by slot index on the device, advances only the chunk's NEW windows
  (models/icalstm.py ICALstmStream, plain PyTorch as JAX's ``lax.scan``
  is) and scatters them back in place: the cost of a chunk does not
  depend on how long the session has run.
- **Hot-swaps.** The live weights are ONE ``(params, stats)`` tuple bound
  by a single attribute store; :meth:`InferenceEngine.swap_params`
  rebinds it while the lanes run, so a dispatch never pairs new params
  with old statistics. :meth:`InferenceEngine.shadow_score` replays a
  ring of the last batched dispatches with a candidate and with the live
  weights through the same forward.

:meth:`InferenceEngine.warmup` runs every bucket of every lane once, so
every kernel library the request path needs is built and loaded before
the first request; :meth:`InferenceEngine.compiles_after_warmup` counts
the libraries built or loaded since (``ops/_build.py``), and it must stay
0 across any number of requests, swaps and publishes.
``cfg.compile_cache_dir`` moves the libraries' root
(``ops/_build.enable_compile_cache``): a later process loads what an
earlier one built there. The tracer and the sinks are ROADMAP A12 (b).
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..models.icalstm import ICALstmStream
from ..ops import _build
from ..runner.registry import get_task
from ..telemetry.bus import NULL_BUS
from ..trainer.checkpoint import load_inference_state
from ..trainer.steps import _StateTask, eval_forward
from ..weights import _leaves, _state_dict_from
from .microbatch import ChainedFuture, Microbatcher, RequestFuture
from .session import SessionTable, init_carry_table

#: serving shape buckets: the row capacities a dispatch pads to
DEFAULT_ROW_BUCKETS = (1, 2, 4, 8, 16)
#: session capacities per streaming dispatch
DEFAULT_STREAM_BUCKETS = (1, 4)
#: windows per streaming chunk (longer runs split; shorter pad with
#: step_valid = 0, an exact identity on the carry)
DEFAULT_STREAM_CHUNK = 8
#: batched dispatches kept for shadow scoring
MIRROR_CAP = 4


class ServingError(RuntimeError):
    """The serving engine cannot honour a request or configuration."""


class _Req:
    """One queued request (either lane)."""

    __slots__ = ("rows", "weights", "future", "session", "slot", "generation",
                 "fresh", "trace_id", "_submit_t", "_seq", "priority", "deadline_ms")

    def __init__(self, rows, weights=None, session=None, trace_id=None,
                 priority: int = 0, deadline_ms=None):
        self.rows = rows
        self.weights = weights
        self.session = session
        self.slot = self.generation = 0
        self.fresh = False
        # admission: higher priority collects first; deadline_ms is the
        # submit-relative staleness past which the request is SHED
        self.priority = int(priority)
        self.deadline_ms = deadline_ms
        self._seq = 0
        self.trace_id = trace_id or uuid.uuid4().hex
        self.future = RequestFuture()
        self.future.trace_id = self.trace_id
        self._submit_t = 0.0


def _refuse(cfg: TrainConfig, tracer, sink) -> None:
    """Raise for the engine options the port does not run."""
    for name, on in (("tracer", tracer is not None), ("sink", sink is not None)):
        if on:
            raise NotImplementedError(
                f"InferenceEngine {name} is not ported: ROADMAP A12 (b) (the serving plane's "
                "tracer and sinks)")


class InferenceEngine:
    """Construct, :meth:`warmup`, then :meth:`submit` / :meth:`stream`;
    always :meth:`close` (or use as a context manager), which stops the
    lane threads.

    Weights come from exactly one of: a ``checkpoint`` path (a trainer
    checkpoint in the JAX package's format, through
    :func:`~..trainer.checkpoint.load_inference_state`; its meta is
    ``self.meta``), the JAX package's ``params``/``batch_stats`` trees, or
    the port model's own ``state_dict``. ``device=None`` means the card.

    ``streaming``: None runs the streaming lane where the task and config
    support it (the unidirectional ICA-LSTM), False never, True insists.
    ``bus`` receives the lanes' series, labelled with ``bus_labels``."""

    def __init__(self, cfg: TrainConfig, *, checkpoint: str | None = None, params=None,
                 batch_stats=None, state_dict=None, row_buckets=DEFAULT_ROW_BUCKETS,
                 stream_buckets=DEFAULT_STREAM_BUCKETS,
                 stream_chunk: int = DEFAULT_STREAM_CHUNK, stream_slots: int = 32,
                 max_delay_ms: float = 2.0, max_queue: int | None = None,
                 streaming: bool | None = None, device=None, bus=None,
                 bus_labels: dict | None = None, tracer=None, sink=None):
        _refuse(cfg, tracer, sink)
        if cfg.compile_cache_dir:
            from ..ops._build import enable_compile_cache

            enable_compile_cache(cfg.compile_cache_dir)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = get_task(cfg.task_id)
        if self.spec.serving is None:
            raise ServingError(f"task {cfg.task_id!r} has no serving spec")
        self.bus = bus if bus is not None else NULL_BUS
        self._bus_labels = dict(bus_labels or {})
        self.meta: dict = {}
        if sum(x is not None for x in (checkpoint, params, state_dict)) != 1:
            raise ServingError("pass either params (with batch_stats), state_dict or a "
                               "checkpoint: exactly one of them")
        if checkpoint is not None:
            params, batch_stats, self.meta = load_inference_state(checkpoint)
        self.table = self.spec.leaf_table(cfg)
        if params is not None:
            state_dict = self._state_dict_of(params, batch_stats)
        model = self.spec.build_model(cfg, torch.Generator().manual_seed(cfg.seed))
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        tensors = dict(self.model.state_dict())
        # params + statistics live as ONE tuple bound by a single attribute
        # store (atomic under the GIL): a swap rebinds it while dispatch
        # threads are mid-flight, and a dispatch reads it once
        self._live = ({n: tensors[n] for n, _, _ in self.table.params},
                      {n: tensors[n] for n, _ in self.table.stats})
        self.sample_shape = tuple(self.spec.serving.sample_shape(cfg))
        self.row_buckets = tuple(sorted(set(int(b) for b in row_buckets)))
        self.stream_chunk = int(stream_chunk)
        self.stream_buckets = tuple(sorted(set(int(b) for b in stream_buckets)))
        self.streaming = self.spec.serving.supports_streaming(cfg)
        if streaming is False:
            self.streaming = False
        elif streaming is True and not self.streaming:
            raise ServingError(f"task {cfg.task_id!r} with this config cannot stream "
                               "(needs a causal recurrent head)")
        self._max_delay_ms = max_delay_ms
        self._max_queue = max_queue
        self._warm = False
        self._infer_lane = self._stream_lane = None
        self._builds_at_warmup = None
        self._lock = threading.Lock()  # stats, latencies, the mirror ring
        # the SessionTable is touched by the stream lane's dispatch thread
        # (resolve) and the caller's (close_session, status, summary)
        self._session_lock = threading.Lock()
        self._latencies: list = []  # (lane, seconds) per request
        self._t0 = time.monotonic()
        self.warmup_seconds = 0.0
        self.stats = {"requests": 0, "samples": 0, "stream_chunks": 0, "swaps": 0}
        # the last few batched dispatch payloads (padded host copies), for
        # shadow scoring a publish candidate on real recent traffic
        self._mirror: list = []
        self.sessions = self._table = self._stream_model = None
        if self.streaming:
            if stream_slots < self.stream_buckets[-1]:
                # a dispatch of B sessions needs B distinct slots: with fewer,
                # resolving request k could LRU-evict a session resolved
                # earlier in the same batch, and two live streams would
                # share one carry row
                raise ServingError(
                    f"stream_slots={stream_slots} is below the largest stream bucket "
                    f"({self.stream_buckets[-1]}); a single dispatch could evict its own "
                    "batch's sessions")
            a = cfg.ica_args
            self._stream_model = ICALstmStream(
                input_size=a.input_size, hidden_size=a.hidden_size, num_cls=a.num_class,
                num_comps=a.num_components, window_size=a.window_size,
                compute_dtype=a.compute_dtype or None,
            ).to(self.device).eval()
            self.sessions = SessionTable(stream_slots)
            self._table = init_carry_table(stream_slots, a.hidden_size, self.device)

    @property
    def task(self) -> _StateTask:
        """The task over the live weights, as :func:`eval_forward` takes it."""
        live = self._live
        return _StateTask(self.model, {**live[0], **live[1]})

    def _on_device(self):
        """The engine's device as the current one, in whichever thread runs
        a dispatch (the lanes' threads, a publish controller's)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- the two forwards --------------------------------------------------

    def _probs(self, live, x: np.ndarray, w: np.ndarray) -> np.ndarray:
        """The batched forward of ``live = (params, stats)`` on host rows
        ``x`` with row weights ``w``; the answer is on the host when this
        returns."""
        with self._on_device():
            task = _StateTask(self.model, {**live[0], **live[1]})
            return eval_forward(task, torch.from_numpy(x).to(self.device), None,
                                torch.from_numpy(w).to(self.device)).float().cpu().numpy()

    def _stream_step(self, live, slot_ix, fresh, x, sv, valid) -> np.ndarray:
        """The streaming step: gather carries by slot, zero fresh sessions,
        advance the chunk, scatter back in place, gated by ``valid`` (a pad
        slot points at the trash row and writes back what it gathered).
        Returns the probabilities on the host."""
        dev = self.device
        with self._on_device(), torch.no_grad():
            ix = torch.from_numpy(slot_ix).to(dev)
            gone = torch.from_numpy(fresh).to(dev) > 0
            tbl = self._table
            h, c, pooled = (torch.where(gone[:, None], 0.0, tbl[k].index_select(0, ix))
                            for k in ("h", "c", "pooled"))
            count = torch.where(gone, 0.0, tbl["count"].index_select(0, ix))
            logits, (h2, c2, p2, n2) = torch.func.functional_call(
                self._stream_model, {**live[0], **live[1]},
                (torch.from_numpy(x).to(dev), h, c, pooled, count, torch.from_numpy(sv).to(dev)))
            v = torch.from_numpy(valid).to(dev) > 0
            for k, new, old in (("h", h2, h), ("c", c2, c), ("pooled", p2, pooled)):
                tbl[k].index_copy_(0, ix, torch.where(v[:, None], new, old))
            tbl["count"].index_copy_(0, ix, torch.where(v, n2, count))
            return torch.softmax(logits, -1).float().cpu().numpy()

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> dict:
        """Run every bucket of every lane once on the device (builds and
        loads the kernels) and start the lanes; returns ``{"<lane>/<bucket>":
        seconds}``. From here on :meth:`compiles_after_warmup` counts."""
        t0 = time.monotonic()
        times = {}
        for b in self.row_buckets:
            tb = time.monotonic()
            self._probs(self._live, np.zeros((b,) + self.sample_shape, np.float32),
                        np.ones((b,), np.float32))
            times[f"infer/{b}"] = time.monotonic() - tb
        if self.streaming:
            a, t = self.cfg.ica_args, self.stream_chunk
            for b in self.stream_buckets:
                tb = time.monotonic()
                # every slot a pad slot on the trash row: an identity there
                self._stream_step(
                    self._live, np.full((b,), self.sessions.trash_slot, np.int64),
                    np.zeros((b,), np.float32),
                    np.zeros((b, t, a.num_components, a.window_size), np.float32),
                    np.zeros((b, t), np.float32), np.zeros((b,), np.float32))
                times[f"stream/{b}"] = time.monotonic() - tb
        self.warmup_seconds = time.monotonic() - t0
        self._builds_at_warmup = (_build.BUILDS, _build.LOADS)
        lane_kw = dict(max_delay_ms=self._max_delay_ms, max_queue=self._max_queue,
                       bus=self.bus, labels=self._bus_labels)
        self._infer_lane = Microbatcher(self._dispatch_infer, self.row_buckets, name="infer",
                                        **lane_kw)
        if self.streaming:
            self._stream_lane = Microbatcher(
                self._dispatch_stream, self.stream_buckets, rows_of=lambda req: 1,
                conflict_key=lambda req: req.session, name="stream", **lane_kw)
        self._warm = True
        return times

    # -- request path ------------------------------------------------------

    def _finish(self, reqs, lane: str) -> None:
        now = time.monotonic()
        with self._lock:
            for r in reqs:
                self._latencies.append((lane, now - r._submit_t))
            self.stats["requests"] += len(reqs)
        for r in reqs:
            self.bus.observe("serving_request_latency_ms", (now - r._submit_t) * 1e3,
                             lane=lane, **self._bus_labels)
        self.bus.counter("serving_requests_total", len(reqs), lane=lane, **self._bus_labels)

    def _dispatch_infer(self, reqs, bucket: int) -> None:
        """Pack the collected requests into the bucket's padded batch and run
        the forward once. Pad rows carry weight 0."""
        x = np.zeros((bucket,) + self.sample_shape, np.float32)
        w = np.zeros((bucket,), np.float32)
        at = 0
        spans = []
        for r in reqs:
            n = len(r.rows)
            x[at:at + n] = r.rows
            w[at:at + n] = 1.0 if r.weights is None else r.weights
            spans.append((r, at, n))
            at += n
        probs = self._probs(self._live, x, w)
        with self._lock:
            self._mirror.append((bucket, x, w))
            del self._mirror[:-MIRROR_CAP]
            self.stats["samples"] += at
        for r, lo, n in spans:
            r.future.set_result(probs[lo:lo + n])
        self._finish(reqs, "infer")

    def _dispatch_stream(self, reqs, bucket: int) -> None:
        """One streaming step over up to ``bucket`` sessions: resolve slots
        (assign or evict on the host table), then run the step."""
        a, t = self.cfg.ica_args, self.stream_chunk
        slot_ix = np.full((bucket,), self.sessions.trash_slot, np.int64)
        fresh = np.zeros((bucket,), np.float32)
        x = np.zeros((bucket, t, a.num_components, a.window_size), np.float32)
        sv = np.zeros((bucket, t), np.float32)
        valid = np.zeros((bucket,), np.float32)
        for i, r in enumerate(reqs):
            with self._session_lock:
                r.slot, r.generation, r.fresh = self.sessions.resolve(r.session)
            slot_ix[i] = r.slot
            fresh[i] = float(r.fresh)
            n = len(r.rows)
            x[i, :n] = r.rows
            sv[i, :n] = 1.0
            valid[i] = 1.0
        probs = self._stream_step(self._live, slot_ix, fresh, x, sv, valid)
        for i, r in enumerate(reqs):
            r.future.set_result({"probs": probs[i], "session": r.session,
                                 "generation": r.generation, "restarted": bool(r.fresh),
                                 "trace_id": r.trace_id})
        with self._lock:
            self.stats["samples"] += len(reqs)
            self.stats["stream_chunks"] += len(reqs)
        with self._session_lock:
            occupied, evictions = self.sessions.occupied, self.sessions.evictions
        self.bus.gauge("serving_sessions_occupied", occupied, **self._bus_labels)
        self.bus.gauge("serving_session_evictions", evictions, **self._bus_labels)
        self._finish(reqs, "stream")

    # -- public API --------------------------------------------------------

    def submit(self, rows, weights=None, trace_id=None, priority: int = 0, deadline_ms=None):
        """Batched inference: ``rows [n, *sample_shape]`` → a future of
        ``probs [n, C]``. ``weights`` masks rows (eval semantics);
        ``trace_id`` is the caller's request id (a fresh one when absent,
        on the future's ``.trace_id``); ``priority`` (higher first) and
        ``deadline_ms`` (shed when staler than this at collection: the
        future then raises :class:`~.microbatch.RequestError`) feed the
        microbatcher's admission."""
        self._ensure_warm()
        rows = np.asarray(rows, np.float32)
        if rows.shape[1:] != self.sample_shape:
            raise ServingError(f"request rows shaped {rows.shape[1:]} but task "
                               f"{self.cfg.task_id!r} serves {self.sample_shape}")
        req = _Req(rows, weights=weights, trace_id=trace_id, priority=priority,
                   deadline_ms=deadline_ms)
        self._infer_lane.submit(req)
        return req.future

    def stream(self, session_id: str, windows, trace_id=None, priority: int = 0):
        """Streaming inference: feed ``windows [t, C, W]``, the session's NEW
        timesteps, and get a future of ``{"probs", "session", "generation",
        "restarted", "trace_id"}``, the classification over everything the
        session has seen. A run longer than one chunk is split into in-order
        chunk submissions sharing one ``trace_id``; the returned
        :class:`~.microbatch.ChainedFuture` gives the last chunk's answer
        and raises the first failed chunk's error. Chunks carry no deadline:
        shedding a middle chunk would drop windows from the carry."""
        self._ensure_warm()
        if not self.streaming:
            raise ServingError(
                "this checkpoint has no streaming lane (streaming needs a causal recurrent "
                "head: ICA-Classification with bidirectional=false; the reverse direction "
                "of a biLSTM reads the future, so no O(1) carry can serve it)")
        windows = np.asarray(windows, np.float32)
        a = self.cfg.ica_args
        if windows.ndim != 3 or windows.shape[1:] != (a.num_components, a.window_size):
            raise ServingError(f"stream windows must be [t, {a.num_components}, "
                               f"{a.window_size}], got {windows.shape}")
        if len(windows) == 0:
            raise ServingError("stream() needs at least one window (an empty chunk has "
                               "nothing to advance the session with)")
        trace_id = trace_id or uuid.uuid4().hex
        links = []
        for lo in range(0, len(windows), self.stream_chunk):
            req = _Req(windows[lo:lo + self.stream_chunk], session=session_id,
                       trace_id=trace_id, priority=priority)
            self._stream_lane.submit(req)
            links.append(req.future)
        if len(links) == 1:
            return links[0]
        chain = ChainedFuture(links)
        chain.trace_id = trace_id
        return chain

    def close_session(self, session_id: str) -> None:
        with self._session_lock:
            self.sessions.close(session_id)

    # -- weights: hot-swap and shadow scoring --------------------------------

    def _signature(self, params, stats) -> dict:
        """``{(part, JAX path): (shape, dtype)}`` of a weight pair, in the
        JAX package's tree layout: the JAX trees' leaves as they are, the
        port's tensors (by ``state_dict`` name, as :meth:`weights` gives
        them) through the leaf table (a transposed leaf's shape reversed)."""
        def dt(a):
            return str(a.dtype).removeprefix("torch.") if torch.is_tensor(a) else str(a.dtype)

        names = {n: (j, tr) for n, j, tr in self.table.params}
        names.update({n: (j, False) for n, j in self.table.stats})
        sig = {}
        for part, tree in (("params", params), ("batch_stats", stats)):
            if tree and set(tree) <= set(names):  # the port's names
                for n, a in tree.items():
                    j, tr = names[n]
                    shape = tuple(a.shape)
                    sig[(part, j)] = (shape[::-1] if tr else shape, dt(a))
            else:
                for j, a in _leaves(tree or {}).items():
                    a = a if torch.is_tensor(a) else np.asarray(a)
                    sig[(part, j)] = (tuple(a.shape), dt(a))
        return sig

    def _state_dict_of(self, params, batch_stats) -> dict:
        """A weight pair, the JAX trees or the port's tensors by
        ``state_dict`` name, as one ``state_dict``."""
        if params and set(params) <= {n for n, _, _ in self.table.params}:
            return {**params, **(batch_stats or {})}
        return _state_dict_from(self.table, params, batch_stats or {})

    def _swap_shape_mismatch(self, params, stats) -> list:
        """Readable mismatches between a candidate weight pair and the live
        one: leaves missing or extra, and each leaf's shape and dtype, in
        the JAX layout. Any mismatch means the candidate is not this
        engine's model: the caller refuses."""
        new, cur = self._signature(params, stats), self._signature(*self._live)
        if new.keys() != cur.keys():
            return [f"tree structure differs: {sorted(new.keys() ^ cur.keys())}"]
        return [f"{part}: leaf {j} {new[part, j][0]}/{new[part, j][1]} vs live "
                f"{cur[part, j][0]}/{cur[part, j][1]}"
                for part, j in sorted(cur) if new[part, j] != cur[part, j]]

    def _on_engine(self, params, batch_stats, what: str) -> tuple:
        """A candidate (the JAX trees or the port's tensors) as the port's
        f32 tensors on this engine's device, after the shape check."""
        problems = self._swap_shape_mismatch(params, batch_stats or {})
        if problems:
            raise ServingError(f"{what} refused: candidate weights do not match the live "
                               "model's shapes (publish a same-architecture checkpoint, or "
                               "stand up a new engine): " + "; ".join(problems))
        with self._on_device():
            t = {n: v.detach().to(self.device, torch.float32).contiguous().clone()
                 for n, v in self._state_dict_of(params, batch_stats).items()}
        return ({n: t[n] for n, _, _ in self.table.params},
                {n: t[n] for n, _ in self.table.stats})

    def weights(self) -> tuple:
        """The live ``(params, stats)`` device tensors by ``state_dict``
        name. A publish controller retains this tuple before a swap: it is
        the rollback target (a swap only rebinds, never writes into it)."""
        return self._live

    def swap_params(self, params, batch_stats=None) -> dict:
        """Install new weights, the JAX trees or the port's tensors (as
        :meth:`weights` gives them): copied to this engine's device, checked
        against the live shapes (:class:`ServingError` on any drift), then
        bound in one attribute store once the copy has landed. Returns
        ``{"pause_ms": ...}``, the wall time of the rebind, which is all a
        request can observe."""
        self._ensure_warm()
        new = self._on_engine(params, batch_stats, "hot-swap")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.monotonic()
        self._live = new
        pause_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self.stats["swaps"] += 1
        self.bus.counter("serving_swaps_total", **self._bus_labels)
        self.bus.observe("serving_swap_pause_ms", pause_ms, **self._bus_labels)
        return {"pause_ms": round(pause_ms, 4)}

    def shadow_score(self, params, batch_stats=None) -> dict:
        """Score a candidate on mirrored live traffic: replay the last few
        batched dispatches through the same forward with the candidate's
        weights and with the live ones (the live weights are untouched).
        Returns ``{batches, rows, finite, max_abs_delta}``, the candidate's
        largest probability shift against the live weights over the real
        rows. Shape drift raises as :meth:`swap_params` does."""
        self._ensure_warm()
        cand = self._on_engine(params, batch_stats, "shadow-score")
        with self._lock:
            ring = list(self._mirror)
        if not ring:
            # nothing mirrored yet: a zero payload at the smallest bucket
            # still shows whether the candidate's answers are finite
            b = self.row_buckets[0]
            ring = [(b, np.zeros((b,) + self.sample_shape, np.float32),
                     np.ones((b,), np.float32))]
        live = self._live
        finite, max_delta, rows = True, 0.0, 0
        for _, x, w in ring:
            got, ref = self._probs(cand, x, w), self._probs(live, x, w)
            mask = w > 0
            rows += int(mask.sum())
            if not np.isfinite(got[mask]).all():
                finite = False
            else:
                max_delta = max(max_delta, float(np.abs(got[mask] - ref[mask]).max()))
        return {"batches": len(ring), "rows": rows, "finite": finite,
                "max_abs_delta": round(max_delta, 6)}

    # -- lifecycle, probes and rollups ---------------------------------------

    def _ensure_warm(self) -> None:
        if not self._warm:
            raise ServingError("call warmup() before submitting requests")

    def _lanes(self) -> list:
        return [L for L in (self._infer_lane, self._stream_lane) if L is not None]

    def drain(self, timeout: float = 30.0) -> None:
        """Block until both lanes' queues are empty (best effort)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(L.depth() == 0 for L in self._lanes()):
                return
            time.sleep(0.002)

    def compiles_after_warmup(self) -> dict:
        """Kernel libraries built and loaded since :meth:`warmup`
        (``ops/_build.py``): the port's proof that the request path, swaps
        included, needs nothing new."""
        if self._builds_at_warmup is None:
            return {}
        b0, l0 = self._builds_at_warmup
        return {"kernel_builds": _build.BUILDS - b0, "kernel_loads": _build.LOADS - l0}

    def assert_no_compiles(self) -> None:
        """Raise :class:`ServingError` if a kernel library was built or
        loaded since warmup."""
        grew = {k: v for k, v in self.compiles_after_warmup().items() if v}
        if grew:
            raise ServingError(f"the serving request path built or loaded kernels after "
                               f"warmup: {grew}")

    def health_probes(self) -> dict:
        """Per-lane readiness probes: the lanes' dispatch threads alive."""
        probes = {
            "warm": lambda: self._warm,
            "infer_lane": lambda: self._warm and self._infer_lane._thread.is_alive(),
        }
        if self.streaming:
            probes["stream_lane"] = lambda: self._warm and self._stream_lane._thread.is_alive()
        return probes

    def _occupancy(self) -> tuple:
        with self._session_lock:
            if self.sessions is None:
                return 0, 0
            return self.sessions.occupied, self.sessions.evictions

    def status(self) -> dict:
        """A cheap live snapshot: what the engine serves and how busy it is."""
        lanes = self._lanes()
        return {
            "task_id": self.cfg.task_id,
            "warm": self._warm,
            "streaming": self.streaming,
            "requests": self.stats["requests"],
            "samples": self.stats["samples"],
            "swaps": self.stats["swaps"],
            "stream_sessions": self._occupancy()[0],
            "queue_depth": sum(L.depth() for L in lanes),
            "deferrals": sum(L.stats["deferrals"] for L in lanes),
            "shed": sum(L.stats["shed"] for L in lanes),
            "compiles_after_warmup": sum(self.compiles_after_warmup().values()),
            "checkpoint_epoch": self.meta.get("epoch"),
            "device": str(self.device),
        }

    def summary(self) -> dict:
        """Requests, samples and dispatches served, latency percentiles,
        rates since construction, occupancy of the buckets and sessions."""
        with self._lock:
            lats = sorted(s for _, s in self._latencies)
            stats = dict(self.stats)
        occupied, evictions = self._occupancy()
        lanes = self._lanes()
        rows = sum(L.stats["rows"] for L in lanes)
        pads = sum(L.stats["pad_rows"] for L in lanes)
        disp = sum(L.stats["dispatches"] for L in lanes)
        hits = sum(L.stats["bucket_hits"] for L in lanes)
        elapsed = max(time.monotonic() - self._t0, 1e-9)

        def pct(p):
            return 1e3 * lats[min(int(p * len(lats)), len(lats) - 1)] if lats else None

        return {
            "kind": "serve_summary",
            "task_id": self.cfg.task_id,
            "requests": stats["requests"],
            "samples": stats["samples"],
            "stream_chunks": stats["stream_chunks"],
            "dispatches": disp,
            "pad_rows": pads,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            "requests_per_s": stats["requests"] / elapsed,
            "samples_per_s": stats["samples"] / elapsed,
            "pad_waste_pct": 100.0 * pads / max(rows + pads, 1),
            "bucket_hit_rate": hits / max(disp, 1),
            "max_queue_depth": max((L.stats["max_queue_depth"] for L in lanes), default=0),
            "deferrals": sum(L.stats["deferrals"] for L in lanes),
            "shed": sum(L.stats["shed"] for L in lanes),
            "swaps": stats["swaps"],
            **self._bus_labels,
            "warmup_seconds": self.warmup_seconds,
            "buckets": {
                "infer": list(self.row_buckets),
                "stream": list(self.stream_buckets) if self.streaming else [],
                "stream_chunk": self.stream_chunk if self.streaming else 0,
            },
            "stream_sessions": occupied,
            "stream_evictions": evictions,
            "compiles_after_warmup": sum(self.compiles_after_warmup().values()),
            "device": str(self.device),
        }

    def close(self) -> dict:
        """Stop the lanes and check that nothing was built or loaded after
        warmup; returns :meth:`summary`."""
        for lane in self._lanes():
            lane.close()
        summary = self.summary()
        self.assert_no_compiles()
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
