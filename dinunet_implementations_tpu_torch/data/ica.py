"""The ICA-timecourse dataset (fMRI windowed classification): the port's
own copy of the JAX package's ``data/ica.py``.

- The inventory is the ``[data_index, label]`` rows of the labels CSV.
- The data file holds one array ``[subjects, components, temporal]``
  (``.npy``, or the first array of an ``.npz``).
- Each subject is cut into ``temporal_size // window_size`` windows;
  window ``j`` covers ``[j*window_stride, j*window_stride + window_size)``.
  The window COUNT comes from ``window_size`` even when ``window_stride``
  differs: overlapping windows leave the tail uncovered. That is the
  reference's rule (``comps/icalstm/__init__.py:28-33``), kept as it is.
  A sample is ``[windows, components, window_size]``.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .api import DataHandle, SiteArrays, SiteDataset


def load_timecourses(path: str) -> np.ndarray:
    """The ``[subjects, components, temporal]`` array of a .npy/.npz."""
    data = np.load(path)
    if isinstance(data, np.lib.npyio.NpzFile):
        data = data[list(data.files)[0]]
    return np.asarray(data)


def window_timecourses(data: np.ndarray, temporal_size: int, window_size: int,
                       window_stride: int) -> np.ndarray:
    """``[N, C, T]`` → ``[N, windows, C, W]`` by the reference's rule
    (count from ``window_size``, offset from ``window_stride``)."""
    samples_per_sub = int(temporal_size / window_size)
    n, c, _ = data.shape
    out = np.zeros((n, samples_per_sub, c, window_size), data.dtype)
    for j in range(samples_per_sub):
        lo = j * window_stride
        out[:, j, :, :] = data[:, :, lo:lo + window_size]
    return out


class ICADataset(SiteDataset):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.data = None
        self.window_size = self.cache["window_size"]
        self.window_stride = self.cache["window_stride"]
        self.temporal_size = self.cache["temporal_size"]
        self.num_components = self.cache["num_components"]

    def _load_indices(self, files, **kw):
        data = load_timecourses(self.path(cache_key="data_file"))
        self.data = window_timecourses(
            data, self.temporal_size, self.window_size, self.window_stride
        ).astype(np.float32)
        self.indices += [list(f) for f in files]

    def __getitem__(self, ix) -> dict:
        data_index, y = self.indices[ix]
        return {"inputs": self.data[int(data_index)], "labels": int(y), "ix": ix}

    def as_arrays(self) -> SiteArrays:
        rows = np.asarray([int(i) for i, _ in self.indices])
        return SiteArrays(
            self.data[rows],
            np.asarray([int(y) for _, y in self.indices], np.int32),
            np.arange(len(rows), dtype=np.int32),
        )


class ICADataHandle(DataHandle):
    """The inventory: the ``[index, label]`` rows of the labels CSV."""

    def list_files(self) -> list:
        path = os.path.join(self.state["baseDirectory"], self.cache["labels_file"])
        with open(path, newline="") as fh:
            reader = csv.reader(fh)
            next(reader)  # header
            return [[int(float(r[0])), int(float(r[1]))] for r in reader if r]
