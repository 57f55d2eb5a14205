"""A synthetic ICA simulator tree, generated on demand: the port's own copy
of the JAX package's ``data/demo.py:make_ica_demo_tree``. It writes the
reference's simulator layout (``input/local{i}/simulatorRun`` with
``timecourses.npz`` and ``labels.csv``, and one ``inputspec.json`` entry a
site) with a real class signal, so a fit on it learns.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_ica_demo_tree(root: str, n_sites: int = 2, subjects: int = 24, comps: int = 16,
                       temporal: int = 80, window: int = 10, stride: int = 10, seed: int = 0,
                       shift: float = 0.8) -> str:
    """Generate an ICA-Classification simulator tree under ``root``.
    Label-1 subjects get a ``+shift``·σ mean shift in the first quarter of
    the components. The inputspec pins a narrow model (encoder 32, BiLSTM
    24); returns ``root``."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n_sites):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        os.makedirs(d, exist_ok=True)
        y = rng.integers(0, 2, subjects)
        X = rng.normal(size=(subjects, comps, temporal)).astype(np.float32)
        X[:, : comps // 4] += (y[:, None, None] * shift).astype(np.float32)
        np.savez(os.path.join(d, "timecourses.npz"), X)
        with open(os.path.join(d, "labels.csv"), "w") as fh:
            fh.write("index,label\n")
            for j in range(subjects):
                fh.write(f"{j},{int(y[j])}\n")
        spec.append({k: {"value": v} for k, v in dict(
            data_file="timecourses.npz",
            labels_file="labels.csv",
            temporal_size=temporal,
            window_size=window,
            window_stride=stride,
            num_components=comps,
            input_size=32,
            hidden_size=24,
            num_class=2,
        ).items()})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root
