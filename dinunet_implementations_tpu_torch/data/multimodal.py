"""The multimodal FS+ICA dataset: the port's own copy of the JAX package's
``data/multimodal.py``.

One site directory holds both modalities: the FreeSurfer covariate CSV
(``labels_file``) with its aseg files (``data/freesurfer.py``) and the ICA
timecourses (``data_file``, windowed as ``data/ica.py`` windows them),
joined row by row (row i of the covariate CSV with subject i of the
timecourses). A sample is one packed float vector ``[fs_input_size +
windows·C·W]``, so the site-batch pipeline takes it as any other array;
``MultimodalNet`` unpacks it by static offsets.
"""

from __future__ import annotations

import os

import numpy as np

from .api import DataHandle, SiteArrays, SiteDataset
from .freesurfer import _read_covariates, coerce_label, read_aseg_stats
from .ica import load_timecourses, window_timecourses


class MultimodalDataset(SiteDataset):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.fs_feats = None
        self.ica_windows = None

    def _load_indices(self, files, **kw):
        base = self.state["baseDirectory"]
        index, rows = _read_covariates(os.path.join(base, self.cache["labels_file"]),
                                       self.cache.get("data_column"))
        labels_col = self.cache["labels_column"]
        tc = load_timecourses(self.path(cache_key="data_file"))
        self.ica_windows = window_timecourses(
            tc, self.cache["temporal_size"], self.cache["window_size"],
            self.cache["window_stride"]).astype(np.float32)
        n = min(len(index), len(self.ica_windows))
        self.fs_feats = np.stack([read_aseg_stats(os.path.join(base, f)) for f in index[:n]])
        self.indices += [[i, coerce_label(rows[index[i]][labels_col])] for i in range(n)]

    def __getitem__(self, ix) -> dict:
        i, y = self.indices[ix]
        packed = np.concatenate([self.fs_feats[int(i)], self.ica_windows[int(i)].reshape(-1)])
        return {"inputs": packed, "labels": int(y), "ix": ix}

    def as_arrays(self) -> SiteArrays:
        rows = np.asarray([int(i) for i, _ in self.indices])
        packed = np.concatenate(
            [self.fs_feats[rows], self.ica_windows[rows].reshape(len(rows), -1)], axis=1)
        return SiteArrays(
            packed.astype(np.float32),
            np.asarray([int(y) for _, y in self.indices], np.int32),
            np.arange(len(rows), dtype=np.int32),
        )


class MultimodalDataHandle(DataHandle):
    """The inventory: the covariate CSV's index (the FS convention)."""

    def list_files(self) -> list:
        path = os.path.join(self.state["baseDirectory"], self.cache["labels_file"])
        index, _ = _read_covariates(path, self.cache.get("data_column"))
        return index
