"""The runners over a dataset tree: the port's counterpart of the JAX
package's ``runner/fed_runner.py``.

- :class:`FedRunner`, the COINSTAC simulator's replacement, finds the
  ``input/local*/simulatorRun`` site directories, resolves each site's
  config from the tree's ``inputspec.json``, reads and splits each site,
  and fits every fold with all sites on one device.
- :class:`SiteRunner`, the reference's one-site harness
  (``comps/*/site_run.py``), fits one site of the tree alone, a federation
  of one, fold by fold.

``FedDaemon`` of the JAX module is not ported (ROADMAP A10 (b)), and neither
runner wraps a fold in the JAX package's ``sanitized_fit`` (A12).
"""

from __future__ import annotations

import glob
import os
import re

from ..core.config import TrainConfig, resolve_site_configs
from ..core.device import resolve_device
from ..data.api import build_site_dataset
from ..data.splits import resolve_splits
from ..trainer.loop import FederatedTrainer
from .registry import build_model, get_task, task_cache


def _site_dir_key(path: str):
    """Numeric-then-lexicographic sort key of a ``local*`` site directory:
    the number comes from the ``local*`` segment only, a segment without
    digits sorts first, and the full path breaks ties."""
    segment = os.path.basename(os.path.dirname(path))
    m = re.search(r"([0-9]+)", segment)
    return (int(m.group(1)) if m else -1, path)


def discover_site_dirs(dataset_dir: str) -> list[str]:
    """The reference fixture's layout, ``<dataset_dir>/input/local{i}/
    simulatorRun``; ``dataset_dir`` itself is the one site when there are
    no ``local*`` directories."""
    pattern = os.path.join(dataset_dir, "input", "local*", "simulatorRun")
    return sorted(glob.glob(pattern), key=_site_dir_key) or [dataset_dir]


def load_site_splits(cfg: TrainConfig, site_dirs: list[str],
                     site_cfgs: list[TrainConfig] | None = None) -> list[dict]:
    """Each site's arrays split into folds: a list (one entry a fold) of
    ``{"train", "validation", "test"}`` lists of ``SiteArrays``, one a
    site. Site ``i`` splits with seed ``site_cfg.seed + i``; the fold count
    is the smallest of any site's."""
    site_cfgs = site_cfgs or [cfg] * len(site_dirs)
    spec = get_task(cfg.task_id)
    site_arrays, site_splits = [], []
    for i, (d, scfg) in enumerate(zip(site_dirs, site_cfgs)):
        ds = build_site_dataset(spec.dataset_cls, spec.handle_cls, task_cache(scfg),
                                {"baseDirectory": d}, mode=scfg.mode)
        arrs = ds.as_arrays()
        site_arrays.append(arrs)
        args = scfg.task_args()
        site_splits.append(resolve_splits(
            len(arrs), split_ratio=scfg.split_ratio, num_folds=scfg.num_folds,
            split_files=tuple(getattr(args, "split_files", ()) or ()), base_dir=d,
            seed=scfg.seed + i))
    folds = []
    for k in range(min(len(s) for s in site_splits)):
        fold = {"train": [], "validation": [], "test": []}
        for arrs, splits in zip(site_arrays, site_splits):
            for key in fold:
                fold[key].append(arrs.take(splits[k][key]))
        folds.append(fold)
    return folds


class FedRunner:
    """Federated training over a reference-style dataset tree, on
    ``device`` (the card unless the caller asks for ``"cpu"``).
    ``overrides`` are config fields (``epochs=3``, ``pipeline="host"``, …)
    applied before the tree's inputspec. ``mesh="auto"`` resolves to one
    device; any other mesh is multi-GPU (ROADMAP A11) and raises."""

    def __init__(self, cfg: TrainConfig | None = None, data_path: str = ".",
                 out_dir: str | None = None, mesh="auto", fault_plan=None, attack_plan=None,
                 device=None, **overrides):
        if mesh not in ("auto", None):
            raise NotImplementedError("FedRunner(mesh=...) is not ported: ROADMAP A11 "
                                      "(multi-GPU); the port runs every site on one device")
        cfg = (cfg or TrainConfig()).with_overrides(overrides)
        self.data_path = data_path
        self.fault_plan, self.attack_plan = fault_plan, attack_plan
        self.site_dirs = discover_site_dirs(data_path)
        self.site_cfgs = resolve_site_configs(cfg, data_path, num_sites=len(self.site_dirs))
        # owner-scoped fields come from site 0 (one owner config; the
        # per-site inputspecs override member fields)
        self.cfg = self.site_cfgs[0].replace(num_sites=len(self.site_dirs))
        self.out_dir = out_dir or os.path.join(data_path, "output")
        self.mesh = None
        self.device = resolve_device(device)

    def run(self, folds=None, verbose: bool = True, resume: bool = False) -> list[dict]:
        """Fit every fold (or those listed in ``folds``); ``resume=True``
        continues each from its last checkpoint; ``cfg.mode == "test"``
        evaluates each fold's best checkpoint instead of training."""
        all_folds = load_site_splits(self.cfg, self.site_dirs, self.site_cfgs)
        fold_ids = list(range(len(all_folds)))
        if folds is not None:
            all_folds = [all_folds[k] for k in folds]
            fold_ids = list(folds)
        results = []
        for k, fold in zip(fold_ids, all_folds):
            trainer = FederatedTrainer(
                self.cfg, build_model(self.cfg, device=self.device), self.mesh,
                out_dir=self.out_dir, fault_plan=self.fault_plan, attack_plan=self.attack_plan,
                device=self.device)
            results.append(trainer.fit(fold["train"], fold["validation"], fold["test"], fold=k,
                                       verbose=verbose, resume=resume))
        return results


#: the reference's short task names (its ``taks_id`` kwarg)
_SHORT_TASK_IDS = {"FSL": "FS-Classification", "ICA": "ICA-Classification"}


class SiteRunner:
    """One site of a dataset tree fitted alone, on ``device`` (the card
    unless the caller asks for ``"cpu"``). ``taks_id`` is the reference's
    kwarg, spelled as it spells it, and takes its short names ("FSL",
    "ICA") or a task id; ``task_id`` wins when both are given.
    ``site_index`` is clamped to the sites present. Other keyword arguments
    are config overrides, applied before the tree's inputspec."""

    def __init__(self, taks_id: str | None = None, task_id: str | None = None,
                 data_path: str = ".", mode: str = "train", seed: int = 0, site_index: int = 0,
                 split_ratio=(0.8, 0.1, 0.1), monitor_metric: str = "auc",
                 metric_direction: str = "maximize", log_header: str = "Loss|AUC",
                 batch_size: int = 16, out_dir: str | None = None, device=None, **kw):
        tid = task_id or _SHORT_TASK_IDS.get(taks_id, taks_id)
        self.site_index = site_index
        self.cfg = TrainConfig(task_id=tid, mode=mode, seed=seed, split_ratio=tuple(split_ratio),
                               monitor_metric=monitor_metric, metric_direction=metric_direction,
                               log_header=log_header, batch_size=batch_size).with_overrides(kw)
        self.data_path = data_path
        self.out_dir = out_dir
        self.device = resolve_device(device)

    def run(self, trainer_cls=None, dataset_cls=None, handle_cls=None,
            verbose: bool = True) -> list[dict]:
        """Fit every fold of the site's own split (seed ``cfg.seed``), each
        with ``mesh=None``. The reference's positional (trainer, dataset,
        handle) are taken; the registry supplies the defaults and the
        trainer is always :class:`FederatedTrainer`."""
        site_dirs = discover_site_dirs(self.data_path)
        site_cfgs = resolve_site_configs(self.cfg, self.data_path, num_sites=len(site_dirs))
        ix = min(self.site_index, len(site_dirs) - 1)
        cfg = site_cfgs[ix]
        spec = get_task(cfg.task_id)
        ds = build_site_dataset(dataset_cls or spec.dataset_cls, handle_cls or spec.handle_cls,
                                task_cache(cfg), {"baseDirectory": site_dirs[ix]}, mode=cfg.mode)
        arrs = ds.as_arrays()
        args = cfg.task_args()
        splits = resolve_splits(
            len(arrs), split_ratio=cfg.split_ratio, num_folds=cfg.num_folds,
            split_files=tuple(getattr(args, "split_files", ()) or ()), base_dir=site_dirs[ix],
            seed=cfg.seed)
        results = []
        for k, split in enumerate(splits):
            trainer = FederatedTrainer(cfg, build_model(cfg, device=self.device), mesh=None,
                                       out_dir=self.out_dir, device=self.device)
            results.append(trainer.fit([arrs.take(split["train"])],
                                       [arrs.take(split["validation"])],
                                       [arrs.take(split["test"])], fold=k, verbose=verbose))
        return results
