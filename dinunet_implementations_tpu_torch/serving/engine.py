"""InferenceEngine: continuously batched serving of a trained model of a
ported task (MSANNet, ICA-LSTM), batched lane only.

The counterpart of the JAX package's ``serving/engine.py``. Requests of
``[n, *sample_shape]`` rows go through the microbatcher, which pads each
dispatch to the smallest row bucket that fits (weight-0 pad rows) and runs
the task's :func:`~..trainer.steps.eval_forward` once on the device. On the
card the ICA-LSTM forward runs the LSTM recurrence kernel twice, once per
direction. MSANNet's BatchNorms normalize by the batch moments in eval
too: the mask keeps the pad rows out of them, so a served answer depends on
the real rows that share its dispatch, as in JAX.
:meth:`InferenceEngine.warmup` runs every bucket once, so the kernel is
built and loaded before the first request.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..runner.registry import get_task
from ..trainer.checkpoint import load_inference_state
from ..trainer.steps import FederatedTask, eval_forward
from ..weights import params_from_jax
from .microbatch import Microbatcher, RequestFuture

#: serving shape buckets: the row capacities a dispatch pads to
DEFAULT_ROW_BUCKETS = (1, 2, 4, 8, 16)


class ServingError(RuntimeError):
    """The serving engine cannot honour a request or configuration."""


class _Req:
    """One queued request."""

    __slots__ = ("rows", "future", "_submit_t")

    def __init__(self, rows):
        self.rows = rows
        self.future = RequestFuture()
        self._submit_t = 0.0


class InferenceEngine:
    """Construct, :meth:`warmup`, then :meth:`submit`; always :meth:`close`
    (or use as a context manager), which stops the lane thread.

    Weights come from one of: a ``checkpoint`` path (a trainer checkpoint
    in the JAX package's format, through
    :func:`~..trainer.checkpoint.load_inference_state`; its meta is
    ``self.meta``), the JAX package's ``params``/``batch_stats`` numpy trees
    (through :func:`~..weights.params_from_jax`) or the port
    model's own ``state_dict``. ``device=None`` means the card."""

    def __init__(self, cfg: TrainConfig, *, checkpoint: str | None = None, params=None,
                 batch_stats=None, state_dict=None, row_buckets=DEFAULT_ROW_BUCKETS,
                 max_delay_ms: float = 2.0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = get_task(cfg.task_id)
        self.meta: dict = {}
        if sum(x is not None for x in (checkpoint, params, state_dict)) != 1:
            raise ServingError("pass either params (with batch_stats), state_dict or a "
                               "checkpoint: exactly one of them")
        if checkpoint is not None:
            params, batch_stats, self.meta = load_inference_state(checkpoint)
        if params is not None:
            state_dict = params_from_jax(cfg, params, batch_stats or {})
        model = self.spec.build_model(cfg, torch.Generator().manual_seed(cfg.seed))
        model.load_state_dict(state_dict)
        self.task = FederatedTask(model.to(self.device).eval())
        self.sample_shape = tuple(self.spec.serving.sample_shape(cfg))
        self.row_buckets = tuple(sorted(set(int(b) for b in row_buckets)))
        self._max_delay_ms = max_delay_ms
        self._lane = None
        self._lock = threading.Lock()  # stats and latencies
        self._latencies: list = []
        self._window = [None, None]  # first submit, last completion
        self.warmup_seconds = 0.0
        self.stats = {"requests": 0, "samples": 0}

    def warmup(self) -> dict:
        """Run every row bucket once on the device (builds and loads the
        kernel) and start the lane; returns ``{"infer/<bucket>": seconds}``."""
        t0 = time.monotonic()
        times = {}
        for b in self.row_buckets:
            tb = time.monotonic()
            x = torch.zeros((b,) + self.sample_shape, device=self.device)
            w = torch.ones((b,), device=self.device)
            eval_forward(self.task, x, None, w).cpu()
            times[f"infer/{b}"] = time.monotonic() - tb
        self.warmup_seconds = time.monotonic() - t0
        self._lane = Microbatcher(
            self._dispatch_infer, self.row_buckets,
            max_delay_ms=self._max_delay_ms, name="infer",
        )
        return times

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
            spans.append((r, at, n))
            at += n
        w[:at] = 1.0
        probs = eval_forward(
            self.task, torch.from_numpy(x).to(self.device), None,
            torch.from_numpy(w).to(self.device),
        ).float().cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.stats["requests"] += len(reqs)
            self.stats["samples"] += at
            self._latencies.extend(now - r._submit_t for r in reqs)
            self._window[1] = now
        for r, lo, n in spans:
            r.future.set_result(probs[lo:lo + n])

    def submit(self, rows):
        """``rows [n, *sample_shape]`` → a future of ``probs [n, C]``."""
        if self._lane is None:
            raise ServingError("call warmup() before submitting requests")
        rows = np.asarray(rows, np.float32)
        if rows.shape[1:] != self.sample_shape:
            raise ServingError(
                f"request rows shaped {rows.shape[1:]} but task "
                f"{self.cfg.task_id!r} serves {self.sample_shape}"
            )
        req = _Req(rows)
        with self._lock:
            if self._window[0] is None:
                self._window[0] = time.monotonic()
        self._lane.submit(req)
        return req.future

    def summary(self) -> dict:
        """Requests, samples and dispatches served, latency percentiles, and
        rates over the serving window (first submit to last completion)."""
        with self._lock:
            lats = sorted(self._latencies)
            stats = dict(self.stats)
            first, last = self._window
        lane = self._lane.stats if self._lane is not None else {}
        span = (last - first) if first is not None and last is not None else 0.0

        def pct(p):
            return 1e3 * lats[min(int(p * len(lats)), len(lats) - 1)] if lats else None

        return {
            "requests": stats["requests"],
            "samples": stats["samples"],
            "dispatches": lane.get("dispatches", 0),
            "pad_rows": lane.get("pad_rows", 0),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
            "requests_per_s": stats["requests"] / span if span > 0 else None,
            "samples_per_s": stats["samples"] / span if span > 0 else None,
            "warmup_seconds": self.warmup_seconds,
            "buckets": list(self.row_buckets),
            "device": str(self.device),
        }

    def close(self) -> dict:
        """Stop the lane; returns :meth:`summary`."""
        if self._lane is not None:
            self._lane.close()
        return self.summary()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
