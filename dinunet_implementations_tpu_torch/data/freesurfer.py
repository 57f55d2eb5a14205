"""The FreeSurfer aseg-volume dataset: the port's own copy of the JAX
package's ``data/freesurfer.py``.

The reference's semantics (``comps/fs/__init__.py:11-39``, ``:66-71``):

- the site inventory is the index column of the covariate CSV
  (``labels_file``; indexed by ``data_column`` when present);
- labels come from ``labels_column``; string labels coerce as
  :func:`coerce_label` says, ints and bools cast to int;
- each sample file is a tab-separated table ``name\\tvalue`` with one
  header row (skipped); the feature vector is normalized by its own max
  (each subject's 66 volumes divided by that subject's largest volume).

``as_arrays`` reads every file once into a dense ``[n, input_size]``
float32 matrix through the native batch reader (``data/native_io.py``),
with the Python reader as its fallback, instead of re-reading the TSVs per
item per epoch.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from . import native_io
from .api import DataHandle, SiteArrays, SiteDataset


def _read_covariates(path: str, data_column: str | None):
    """Read the covariate CSV into (index list, {index → row dict})."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return [], {}
    cols = rows[0].keys()
    key = data_column if data_column in cols else next(iter(cols))
    index = [r[key] for r in rows]
    return index, {r[key]: r for r in rows}


def coerce_label(y, bug_compatible: bool = False) -> int:
    """Reference label coercion (``comps/fs/__init__.py:25-31``).

    The reference maps *every* string through ``int(y.strip().lower() ==
    'true')``, so the string ``"1"`` becomes 0 there. As in JAX, numeric
    strings parse numerically here (``"1"`` → 1); only the literal
    true/false strings use the boolean rule. ``bug_compatible=True``
    (``FSArgs.bug_compatible_labels``) reproduces the reference's rule.
    """
    if isinstance(y, str):
        low = y.strip().lower()
        if bug_compatible:
            return int(low == "true")
        if low in ("true", "false"):
            return int(low == "true")
        return int(float(y))
    return int(y)


def read_aseg_stats(path: str) -> np.ndarray:
    """Read one aseg-stats TSV → max-normalized float32 feature vector."""
    vals = []
    with open(path) as fh:
        next(fh)  # header row (reference: skiprows=1)
        for line in fh:
            line = line.strip()
            if not line:
                continue
            vals.append(float(line.split("\t")[1]))
    x = np.asarray(vals, np.float64)
    x = x / x.max()
    return x.astype(np.float32)


class FreeSurferDataset(SiteDataset):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.labels = None  # {file → row dict}, lazy like the reference

    def _ensure_labels(self):
        if self.labels is None:
            path = os.path.join(
                self.state["baseDirectory"], self.cache["labels_file"]
            )
            _, self.labels = _read_covariates(path, self.cache.get("data_column"))

    def load_index(self, file):
        self._ensure_labels()
        y = self.labels[file][self.cache["labels_column"]]
        self.indices.append(
            [file, coerce_label(y, self.cache.get("bug_compatible_labels", False))]
        )

    def __getitem__(self, ix) -> dict:
        file, y = self.indices[ix]
        x = read_aseg_stats(os.path.join(self.path(), file))
        return {"inputs": x, "labels": y, "ix": ix}

    def as_arrays(self) -> SiteArrays:
        n = len(self.indices)
        files = [os.path.join(self.path(), f) for f, _ in self.indices]
        mat = None
        if n:
            # the native threaded batch parse (native/fastio.cpp); the first
            # file is read in Python to learn the feature count, as in JAX
            first = read_aseg_stats(files[0])
            mat = native_io.read_aseg_batch(files, len(first))
            if mat is None:  # no compiler, or a malformed file: pure Python
                mat = np.stack([first] + [read_aseg_stats(f) for f in files[1:]])
                native_io.READS["python"] += 1
        return SiteArrays(
            mat if n else np.zeros((0, 0), np.float32),
            np.asarray([y for _, y in self.indices], np.int32),
            np.arange(n, dtype=np.int32),
        )


class FSVDataHandle(DataHandle):
    """Site inventory = covariate CSV index column
    (reference ``comps/fs/__init__.py:66-71``)."""

    def list_files(self) -> list:
        path = os.path.join(self.state["baseDirectory"], self.cache["labels_file"])
        index, _ = _read_covariates(path, self.cache.get("data_column"))
        return index
