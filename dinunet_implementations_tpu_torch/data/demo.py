"""Synthetic simulator trees, generated on demand: the port's own copy of
the JAX package's ``data/demo.py`` (the FS, ICA and multimodal trees, the
same bytes from the same seed). Each is the reference's simulator layout
(``input/local{i}/simulatorRun`` and one ``inputspec.json`` entry a site)
with a real class signal, so a fit on it learns.

    python -m dinunet_implementations_tpu_torch.data.demo datasets/demo
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path datasets/demo

- FS: ``siteN_Covariate.csv`` (``freesurferfile,isControl,age``) and one
  ``subject{j}_aseg_stats.txt`` name/value TSV a subject, 66 features
  (the reference's ``datasets/test_fsl`` layout), sites of uneven size.
- ICA: ``timecourses.npz`` and ``labels.csv``, windowing in the inputspec.
- Multimodal: both in one site directory, the covariate CSV, its aseg files
  and ``timecourses.npz``, joined row by row.
"""

from __future__ import annotations

import json
import os

import numpy as np

#: the reference's 66 aseg features (its ``compspec.json`` input_size)
N_FS_FEATURES = 66


def make_fs_demo_tree(root: str, n_sites: int = 4, subjects: int = 32,
                      n_features: int = N_FS_FEATURES, seed: int = 0,
                      shift: float = 1.0) -> str:
    """Generate an FS-Classification simulator tree under ``root``.
    Label-1 subjects get a ``+shift``·σ bump in the first quarter of the
    features, on per-feature scales spanning about 3 decades like real aseg
    volumes; each site holds ``subjects`` ±25 % subjects, uneven like the
    reference fixture's 73/50/100/80/120. Returns ``root``."""
    rng = np.random.default_rng(seed)
    scales = 10.0 ** rng.uniform(1, 4, size=n_features)
    spec = []
    for i in range(n_sites):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        os.makedirs(d, exist_ok=True)
        n_i = int(subjects * (0.75 + 0.5 * rng.random()))
        y = rng.integers(0, 2, n_i)
        with open(os.path.join(d, f"site{i + 1}_Covariate.csv"), "w") as fh:
            fh.write("freesurferfile,isControl,age\n")
            for j in range(n_i):
                age = 20 + 50 * rng.random()
                fh.write(f"subject{j}_aseg_stats.txt,{'True' if y[j] else 'False'},{age:.1f}\n")
        for j in range(n_i):
            x = np.abs(rng.normal(1.0, 0.2, n_features))
            if y[j]:
                x[: n_features // 4] += shift * 0.2
            vals = x * scales
            with open(os.path.join(d, f"subject{j}_aseg_stats.txt"), "w") as fh:
                fh.write(f"Measure:volume\tsubject{j}\n")
                for k in range(n_features):
                    fh.write(f"feature-{k}\t{vals[k]:.2f}\n")
        spec.append({k: {"value": v} for k, v in dict(
            labels_file=f"site{i + 1}_Covariate.csv",
            data_column="freesurferfile",
            labels_column="isControl",
            mode="train",
            input_size=n_features,
            hidden_sizes=[256, 128, 64, 32],
            num_class=2,
        ).items()})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root


def make_ica_demo_tree(root: str, n_sites: int = 2, subjects: int = 24, comps: int = 16,
                       temporal: int = 80, window: int = 10, stride: int = 10, seed: int = 0,
                       shift: float = 0.8, input_size: int = 32, hidden_size: int = 24) -> str:
    """Generate an ICA-Classification simulator tree under ``root``.
    Label-1 subjects get a ``+shift``·σ mean shift in the first quarter of
    the components. The inputspec pins a narrow model (by default encoder
    32, BiLSTM 24); returns ``root``."""
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
            input_size=input_size,
            hidden_size=hidden_size,
            num_class=2,
        ).items()})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root


def make_multimodal_demo_tree(root: str, n_sites: int = 2, subjects: int = 24,
                              n_features: int = 16, comps: int = 8, temporal: int = 40,
                              window: int = 10, stride: int = 10, seed: int = 0,
                              shift: float = 0.8) -> str:
    """Generate a Multimodal-Classification simulator tree under ``root``:
    each site directory holds the FS covariate CSV and one aseg file a
    subject, and the ICA ``timecourses.npz``, joined row by row. Label-1
    subjects get a ``+shift``·σ bump in the first quarter of the FS
    features and of the ICA components. The inputspec pins a narrow
    transformer (embed 32, 4 heads, 1 layer); returns ``root``."""
    rng = np.random.default_rng(seed)
    scales = 10.0 ** rng.uniform(1, 4, size=n_features)
    spec = []
    for i in range(n_sites):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        os.makedirs(d, exist_ok=True)
        y = rng.integers(0, 2, subjects)
        with open(os.path.join(d, f"site{i + 1}_Covariate.csv"), "w") as fh:
            fh.write("freesurferfile,isControl,age\n")
            for j in range(subjects):
                fh.write(f"subject{j}_aseg_stats.txt,{'True' if y[j] else 'False'},"
                         f"{20 + 50 * rng.random():.1f}\n")
        for j in range(subjects):
            x = np.abs(rng.normal(1.0, 0.2, n_features))
            if y[j]:
                x[: n_features // 4] += shift * 0.2
            vals = x * scales
            with open(os.path.join(d, f"subject{j}_aseg_stats.txt"), "w") as fh:
                fh.write(f"Measure:volume\tsubject{j}\n")
                for k in range(n_features):
                    fh.write(f"feature-{k}\t{vals[k]:.2f}\n")
        X = rng.normal(size=(subjects, comps, temporal)).astype(np.float32)
        X[:, : comps // 4] += (y[:, None, None] * shift).astype(np.float32)
        np.savez(os.path.join(d, "timecourses.npz"), X)
        spec.append({k: {"value": v} for k, v in dict(
            task_id="Multimodal-Classification",
            labels_file=f"site{i + 1}_Covariate.csv",
            data_column="freesurferfile",
            labels_column="isControl",
            data_file="timecourses.npz",
            fs_input_size=n_features,
            num_components=comps,
            temporal_size=temporal,
            window_size=window,
            window_stride=stride,
            embed_dim=32,
            num_heads=4,
            num_layers=1,
            num_class=2,
        ).items()})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root


def make_hard_ica_tree(root: str, n_sites: int = 6, seed: int = 7) -> str:
    """The JAX package's hard-SNR golden tree (its tests' recipe): 24
    subjects a site, 8 components of 40 timepoints in windows of 5, the
    class a +0.35σ shift in 2 of the 8 components, a model of encoder 16
    and BiLSTM 12. The same bytes as that recipe's tree for the same
    ``n_sites`` and ``seed``; returns ``root``."""
    return make_ica_demo_tree(root, n_sites=n_sites, subjects=24, comps=8, temporal=40, window=5,
                              stride=5, seed=seed, shift=0.35, input_size=16, hidden_size=12)


def make_demo_tree(root: str, task: str = "FS-Classification", **kw) -> str:
    """Dispatch by task id (the FS, ICA and multimodal tasks, with JAX's
    short names); returns ``root``."""
    if task in ("FS-Classification", "FSL", "fs"):
        return make_fs_demo_tree(root, **kw)
    if task in ("ICA-Classification", "ICA", "ica"):
        return make_ica_demo_tree(root, **kw)
    if task in ("Multimodal-Classification", "multimodal", "mm"):
        return make_multimodal_demo_tree(root, **kw)
    raise ValueError(f"unknown demo task {task!r}")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m dinunet_implementations_tpu_torch.data.demo",
                                description="Generate a self-contained demo simulator tree.")
    p.add_argument("root", help="directory to create (e.g. datasets/demo)")
    p.add_argument("--task", default="FS-Classification",
                   help="FS-Classification (default), ICA-Classification or "
                        "Multimodal-Classification")
    p.add_argument("--sites", type=int, default=None)
    p.add_argument("--subjects", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    kw = {"seed": args.seed}
    if args.sites is not None:
        kw["n_sites"] = args.sites
    if args.subjects is not None:
        kw["subjects"] = args.subjects
    make_demo_tree(args.root, args.task, **kw)
    n_files = sum(len(fs) for _, _, fs in os.walk(args.root))
    print(f"demo tree ready: {args.root} ({n_files} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
