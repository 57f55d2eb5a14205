"""The reference's two result notebooks, from the port's own runs: the
counterpart of the JAX package's ``analysis.py``.

1. :func:`pretrain_study`: the reference ``NB.ipynb`` cells 6-17, a k-fold
   FS classification trained from scratch against warm-started by
   pretraining on the largest site (``compspec.json:120-127``), read back
   from each fold's ``logs.json`` and ``test_metrics.csv``: the mean
   early-stop epoch (68.5 from scratch against 42.7 pretrained in the
   reference's published run) and the accuracy and F1 of each fold for the
   boxplots.
2. :func:`engine_comparison`: the reference ``nnlogs.ipynb`` cell 2, for
   each aggregation engine the test ``[loss, AUC]`` with the total and the
   compute-only wall-clock, parsed from the run's ``logs.json``.

Both train through :class:`~.runner.fed_runner.FedRunner` on ``device``
(the card unless the caller asks for ``"cpu"``) and read back the files the
runner wrote, which keeps the notebooks' log schema honest.

    from dinunet_implementations_tpu_torch.analysis import pretrain_study
    report = pretrain_study("datasets/test_fsl", "out/study", num_folds=10)
    print(report["summary_markdown"])
"""

from __future__ import annotations

import csv
import json
import os

from .core.config import PretrainArgs, TrainConfig
from .runner.fed_runner import FedRunner
from .trainer.logs import fold_dir


def _read_fold_logs(out_dir: str, task_id: str, fold_ids: list[int]) -> list[dict]:
    logs = []
    for k in fold_ids:
        with open(os.path.join(fold_dir(out_dir, "remote", task_id, k), "logs.json")) as fh:
            logs.append(json.load(fh))
    return logs


def _arm_stats(logs: list[dict]) -> dict:
    epochs = [lg["best_val_epoch"] for lg in logs]
    aucs = [lg["test_metrics"][0][1] for lg in logs]
    losses = [lg["test_metrics"][0][0] for lg in logs]
    n = max(len(logs), 1)
    return {
        "folds": len(logs),
        "best_val_epochs": epochs,
        "test_aucs": aucs,
        "test_losses": losses,
        "mean_best_val_epoch": sum(epochs) / n,
        "mean_test_auc": sum(aucs) / n,
        "mean_test_loss": sum(losses) / n,
    }


def engine_comparison(data_path: str, out_dir: str,
                      engines: tuple[str, ...] = ("dSGD", "rankDAD", "powerSGD"),
                      base_cfg: TrainConfig | None = None, fold: int = 0,
                      verbose: bool = False, device=None) -> dict:
    """The ``nnlogs.ipynb`` cell-2 table from the port's own runs.

    Fits fold ``fold`` of ``data_path`` once an engine under
    ``<out_dir>/<engine>``, then parses each run's remote ``logs.json`` as
    the notebook does: test ``[loss, AUC]``, the cumulative wall-clock and
    the summed compute-only time. Returns the rows and a rendered
    ``summary_markdown``, also written to ``<out_dir>/engine_comparison.md``.
    """
    cfg = base_cfg or TrainConfig(agg_engine="dSGD", epochs=101, patience=35, seed=0)
    rows: dict = {}
    for engine in engines:
        arm_out = os.path.join(out_dir, engine)
        runner = FedRunner(cfg.replace(agg_engine=engine), data_path=data_path,
                           out_dir=arm_out, device=device)
        runner.run(folds=[fold], verbose=verbose)
        lg = _read_fold_logs(arm_out, runner.cfg.task_id, [fold])[0]
        rows[engine] = {
            "test_metrics": lg["test_metrics"][0],  # [loss, auc]
            "total_duration": (lg["cumulative_total_duration"] or [0.0])[-1],
            "computation_time": sum(lg["time_spent_on_computation"]),
            "best_val_epoch": lg["best_val_epoch"],
        }
    lines = [
        "# Aggregation-engine comparison (nnlogs.ipynb cell 2 equivalent)",
        "",
        f"Dataset: `{data_path}`, fold {fold}",
        "",
        "| engine | test [loss, AUC] | total s | compute s | best epoch |",
        "|---|---|---|---|---|",
    ]
    for engine, r in rows.items():
        loss, auc = r["test_metrics"]
        lines.append(f"| {engine} | [{loss:.5f}, {auc:.5f}] | {r['total_duration']:.1f} | "
                     f"{r['computation_time']:.1f} | {r['best_val_epoch']} |")
    report = {"engines": rows, "summary_markdown": "\n".join(lines)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "engine_comparison.md"), "w") as fh:
        fh.write(report["summary_markdown"] + "\n")
    return report


def write_study_figures(out_dir: str, score_rows: list, epoch_rows: list) -> list[str]:
    """The pretrain study's two boxplots (reference ``NB.ipynb`` cells
    8-11): ``assets/perf_box.png``, accuracy and F1 per experiment, and
    ``assets/pretrain_box.png``, the stop epoch per experiment.

    ``score_rows`` are ``[experiment, score_name, value]`` triples (the
    notebook's ``SCORE`` table), ``epoch_rows`` ``[experiment, epoch]``
    pairs (its ``EPOCH`` table). Draws with matplotlib (Agg, no display)
    when it imports and returns the paths written; returns ``[]`` without
    it (the markdown and the CSV are written either way).
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib is optional
        return []
    assets = os.path.join(out_dir, "assets")
    os.makedirs(assets, exist_ok=True)
    paths = []

    experiments = list(dict.fromkeys(r[0] for r in score_rows))
    scores = list(dict.fromkeys(r[1] for r in score_rows))
    fig, ax = plt.subplots(figsize=(8, 5))
    width, colors = 0.18, ["#4c72b0", "#dd8452", "#55a868", "#c44e52"]
    for si, score in enumerate(scores):
        data = [[r[2] for r in score_rows if r[0] == e and r[1] == score] for e in experiments]
        pos = [i + (si - (len(scores) - 1) / 2) * (width * 1.2) for i in range(len(experiments))]
        bp = ax.boxplot(data, positions=pos, widths=width, showmeans=True, patch_artist=True)
        for box in bp["boxes"]:
            box.set_facecolor(colors[si % len(colors)])
    ax.set_xticks(range(len(experiments)))
    ax.set_xticklabels(experiments)
    ax.set_ylabel("Value")
    ax.set_title("Test performance: scratch vs pre-training k-fold boxplot (higher is better)")
    ax.legend(handles=[plt.Rectangle((0, 0), 1, 1, fc=colors[i % len(colors)])
                       for i in range(len(scores))], labels=scores)
    p = os.path.join(assets, "perf_box.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)

    experiments = list(dict.fromkeys(r[0] for r in epoch_rows))
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.boxplot([[r[1] for r in epoch_rows if r[0] == e] for e in experiments], widths=0.25,
               showmeans=True)
    # labels through the axis: the boxplot keyword was renamed in
    # matplotlib 3.9, so neither spelling spans versions
    ax.set_xticks(range(1, len(experiments) + 1))
    ax.set_xticklabels(experiments)
    ax.set_ylabel("Stopped on epoch")
    ax.set_title("Train from scratch vs with pre-training k-fold boxplot (lower is better)")
    p = os.path.join(assets, "pretrain_box.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)
    return paths


def pretrain_study(data_path: str, out_dir: str, num_folds: int = 10,
                   pretrain_epochs: int = 20, base_cfg: TrainConfig | None = None,
                   folds: list[int] | None = None, verbose: bool = False,
                   device=None) -> dict:
    """Both study arms, fitted under ``<out_dir>/scratch`` and
    ``<out_dir>/pretrained``, and their convergence statistics.

    Returns each arm's statistics, the epoch speedup and a rendered
    ``summary_markdown``; writes ``pretrain_study.md``,
    ``pretrain_study.csv`` and, with matplotlib, the boxplots under
    ``out_dir``.
    """
    cfg = (base_cfg or TrainConfig(agg_engine="dSGD", epochs=101, patience=35, seed=0)
           ).replace(num_folds=num_folds)
    arms = {
        "scratch": cfg.replace(pretrain=False),
        "pretrained": cfg.replace(pretrain=True,
                                  pretrain_args=PretrainArgs(epochs=pretrain_epochs)),
    }
    report: dict = {"arms": {}}
    for name, arm_cfg in arms.items():
        arm_out = os.path.join(out_dir, name)
        runner = FedRunner(arm_cfg, data_path=data_path, out_dir=arm_out, device=device)
        results = runner.run(folds=folds, verbose=verbose)
        # read logs.json back as the reference study does. The fold
        # directories are named by the real fold id (fold_3 for folds=[1, 3]),
        # so read by id, not by position
        fold_ids = list(folds) if folds is not None else list(range(len(results)))
        logs = _read_fold_logs(arm_out, runner.cfg.task_id, fold_ids)
        stats = _arm_stats(logs)
        stats["fold_ids"] = fold_ids
        # each fold's accuracy and F1, read from test_metrics.csv as NB.ipynb
        # cell 6 reads it (line 1, columns 1 and 2)
        accs, f1s = [], []
        for k in fold_ids:
            path = os.path.join(fold_dir(arm_out, "remote", runner.cfg.task_id, k),
                                "test_metrics.csv")
            with open(path) as fh:
                line = fh.readlines()[1].split(",")
            accs.append(float(line[1]))
            f1s.append(float(line[2]))
        stats["test_accuracies"] = accs
        stats["test_f1s"] = f1s
        for lg, res in zip(logs, results):
            if lg["best_val_epoch"] != res["best_val_epoch"]:
                raise RuntimeError(f"{name}: logs.json's best_val_epoch {lg['best_val_epoch']} "
                                   f"disagrees with the fit's {res['best_val_epoch']}")
        report["arms"][name] = stats

    s, p = report["arms"]["scratch"], report["arms"]["pretrained"]
    report["epoch_speedup"] = (s["mean_best_val_epoch"] / p["mean_best_val_epoch"]
                               if p["mean_best_val_epoch"] else float("inf"))
    report["reference"] = {
        "mean_stop_epoch_scratch": 68.5,  # NB.ipynb cell 12
        "mean_stop_epoch_pretrained": 42.7,  # NB.ipynb cell 14
    }
    lines = [
        "# Pretrain convergence study",
        "",
        f"Dataset: `{data_path}` — {s['folds']} folds, pretrain_epochs={pretrain_epochs}",
        "",
        "| arm | mean best_val_epoch | mean test AUC | mean test loss |",
        "|---|---|---|---|",
        f"| scratch | {s['mean_best_val_epoch']:.1f} | {s['mean_test_auc']:.4f} | "
        f"{s['mean_test_loss']:.4f} |",
        f"| pretrained | {p['mean_best_val_epoch']:.1f} | {p['mean_test_auc']:.4f} | "
        f"{p['mean_test_loss']:.4f} |",
        "",
        f"Convergence speedup (scratch/pretrained epochs): **{report['epoch_speedup']:.2f}×** — "
        "the reference's 10-fold study reports 68.5 vs 42.7 (1.60×, NB.ipynb cells 12-14).",
    ]
    report["summary_markdown"] = "\n".join(lines)
    os.makedirs(out_dir, exist_ok=True)
    # the notebook's SCORE and EPOCH tables (cells 6, 10) for the boxplots
    label = {"scratch": "Acc. from scratch", "pretrained": "Acc. with pre-training"}
    elabel = {"scratch": "Convergence from scratch.",
              "pretrained": "Convergence with pre-training."}
    score_rows, epoch_rows = [], []
    for name, stats in report["arms"].items():
        for a, f in zip(stats["test_accuracies"], stats["test_f1s"]):
            score_rows.append([label[name], "Accuracy", a])
            score_rows.append([label[name], "F1", f])
        for e in stats["best_val_epochs"]:
            epoch_rows.append([elabel[name], e])
    report["figures"] = write_study_figures(out_dir, score_rows, epoch_rows)
    with open(os.path.join(out_dir, "pretrain_study.md"), "w") as fh:
        fh.write(report["summary_markdown"] + "\n")
    with open(os.path.join(out_dir, "pretrain_study.csv"), "w", newline="") as fh:
        wr = csv.writer(fh)
        wr.writerow(["arm", "fold", "best_val_epoch", "test_auc", "test_loss"])
        for name, stats in report["arms"].items():
            for k, ep, auc, loss in zip(stats["fold_ids"], stats["best_val_epochs"],
                                        stats["test_aucs"], stats["test_losses"]):
                wr.writerow([name, k, ep, auc, loss])
    return report
