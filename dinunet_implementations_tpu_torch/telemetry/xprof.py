"""``torch.profiler`` capture hooks, the device-trace half of telemetry: the
port of the JAX package's ``telemetry/xprof.py`` (there over
``jax.profiler``).

- the trainer (trainer/loop.py): :class:`XprofWindow` starts and stops a
  capture around an epoch window (``TrainConfig.xprof_dir`` +
  ``xprof_window``, CLI ``--xprof-dir``); ``profile_dir`` traces the whole
  fit through :class:`Trace`. The two exclude each other.
- measurement scripts: :func:`capture` (one explicit capture) and
  :func:`summarize_device_ops` (the device kernels of a written trace by
  total time).

A capture records the host's operators and, where CUDA is available, the
card's activity through CUPTI (``ProfilerActivity.CUDA``), and writes one
Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``) into its directory,
loadable in Perfetto. Nothing here catches the profiler's errors: a capture
that fails fails its caller, as ``jax.profiler`` does.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import shutil
import socket
import time
from contextlib import contextmanager

#: the suffix of the trace files a capture writes
TRACE_SUFFIX = ".pt.trace.json"


def _activities() -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Trace:
    """One running capture into ``trace_dir`` (``jax.profiler``'s
    ``start_trace``; :meth:`stop` is its ``stop_trace``)."""

    def __init__(self, trace_dir: str):
        import torch

        self.dir = trace_dir
        os.makedirs(trace_dir, exist_ok=True)
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.start()

    def stop(self) -> str:
        """Stop the capture and write its trace; returns the file's path."""
        self.prof.stop()
        path = os.path.join(self.dir, f"{socket.gethostname()}_{os.getpid()}."
                                      f"{int(time.time() * 1e3)}{TRACE_SUFFIX}")
        self.prof.export_chrome_trace(path)
        return path


class XprofWindow:
    """A capture around epochs ``[first, last]`` (inclusive, 1-based:
    ``TrainConfig.xprof_window``) into ``<xprof_dir>/<label>``.

    Call :meth:`epoch_begin` / :meth:`epoch_end` from the epoch loop and
    :meth:`close` from its ``finally``: an early stop or ``Preempted``
    inside the window still writes the trace."""

    def __init__(self, xprof_dir: str, window=(1, 1), label: str = ""):
        self.dir = xprof_dir
        w = tuple(window or (1, 1))
        self.first, self.last = int(w[0]), int(w[-1])
        self.label = label
        self._trace = None
        self.path = None  # the written trace file, once closed

    @property
    def active(self) -> bool:
        return self._trace is not None

    def epoch_begin(self, epoch: int) -> None:
        # a range test, not equality: a resumed fit whose first epoch lands
        # inside the window still captures the window's remaining epochs
        if self.dir and self._trace is None and self.first <= epoch <= self.last:
            self._trace = Trace(os.path.join(self.dir, self.label))

    def epoch_end(self, epoch: int) -> None:
        if self._trace is not None and epoch >= self.last:
            self.close()

    def close(self) -> None:
        if self._trace is not None:
            trace, self._trace = self._trace, None
            self.path = trace.stop()


@contextmanager
def capture(trace_dir: str, fresh: bool = True):
    """One explicit capture into ``trace_dir`` (``fresh=True`` clears an
    earlier capture there first)."""
    if fresh:
        shutil.rmtree(trace_dir, ignore_errors=True)
    trace = Trace(trace_dir)
    try:
        yield trace_dir
    finally:
        trace.stop()


def trace_files(trace_dir: str) -> list[str]:
    """The trace files the captures wrote under ``trace_dir``."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True))


def summarize_device_ops(trace_dir: str, top: int = 25) -> list[dict]:
    """The device kernels of the first trace file under ``trace_dir`` by
    total time: the complete (``"X"``) events of category ``kernel``, the
    card's own execution as CUPTI records it (host operators, runtime calls
    and copies are not counted). Returns ``[{"name", "total_us", "count"},
    ...]``, longest first; an empty list for a capture without CUDA
    activity."""
    paths = trace_files(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    with open(paths[0]) as fh:
        d = json.load(fh)
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in d.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        agg[e["name"]] += float(e.get("dur", 0))
        cnt[e["name"]] += 1
    return [{"name": n, "total_us": v, "count": cnt[n]} for n, v in agg.most_common(top)]
