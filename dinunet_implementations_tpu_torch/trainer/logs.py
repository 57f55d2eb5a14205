"""Output writers, in the layout and keys the reference's notebooks read:
the port's own copy of the JAX package's ``trainer/logs.py``, with its
health, telemetry and privacy fields (each empty while its option is
off).

- ``logs.json``: ``agg_engine``, ``test_metrics`` (nested, ``[[loss,
  auc]]``), ``best_val_epoch``, ``cumulative_total_duration``,
  ``time_spent_on_computation`` and ``local_iter_duration`` /
  ``remote_iter_duration`` (``nnlogs.ipynb`` cell 2; ``NB.ipynb`` cells
  2-3, 34-36);
- ``test_metrics.csv``: a header and one row, accuracy and f1 in columns 1
  and 2 (``NB.ipynb`` cell 6);
- the directory layout ``<out>/<site>/simulatorRun/<task_id>/fold_<k>/``
  and the remote's zipped global results next to the task directory.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import zipfile

_LOGGER_NAME = "dinunet_implementations_tpu_torch"


class _StdoutHandler(logging.StreamHandler):
    """A handler that looks ``sys.stdout`` up at each record (pytest and
    notebooks swap the stream after import)."""

    def emit(self, record):
        self.stream = sys.stdout
        super().emit(record)


def get_logger() -> logging.Logger:
    """The port's logger: plain lines on stdout, gated by
    ``DINUNET_LOG_LEVEL`` (default INFO)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        level = os.environ.get("DINUNET_LOG_LEVEL", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
    return logger


def log_info(msg: str) -> None:
    """Progress lines (per-epoch readouts)."""
    get_logger().info(msg)


def log_warning(msg: str) -> None:
    """Recoverable but noteworthy conditions (clamps, empty splits)."""
    get_logger().warning(msg)


def fold_dir(out_dir: str, site: str, task_id: str, fold: int) -> str:
    d = os.path.join(out_dir, site, "simulatorRun", task_id, f"fold_{fold}")
    os.makedirs(d, exist_ok=True)
    return d


def write_logs_json(dirpath: str, agg_engine: str, test_metrics: list, best_val_epoch: int,
                    cumulative_total_duration: list, time_spent_on_computation: list,
                    iter_durations: list, side: str = "local", extra: dict | None = None) -> str:
    log = {
        "agg_engine": agg_engine,
        "test_metrics": test_metrics,
        "best_val_epoch": int(best_val_epoch),
        "cumulative_total_duration": [round(x, 6) for x in cumulative_total_duration],
        "time_spent_on_computation": [round(x, 6) for x in time_spent_on_computation],
        f"{side}_iter_duration": [round(x, 6) for x in iter_durations],
    }
    if extra:
        log.update(extra)
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, "logs.json")
    with open(path, "w") as fh:
        json.dump(log, fh, indent=2)
    return path


def health_log_fields(site_health: dict | None, site_index: int | None = None) -> dict:
    """``logs.json`` fields of the per-site health counters: rounds each
    site skipped and whether it ended the fit quarantined, and under the
    reputation layer each site's anomaly score (rounded to 6 places) and
    suspect streak. ``site_index=None`` gives the remote's lists, an index
    that site's scalars; ``{}`` when no counters were kept
    (``mode="test"``)."""
    if not site_health:
        return {}
    reputation = "site_anomaly_score" in site_health
    if site_index is None:
        out = {"site_skipped_rounds": list(site_health["site_skipped_rounds"]),
               "site_quarantined": list(site_health["site_quarantined"])}
        if reputation:
            out["site_anomaly_score"] = [round(v, 6) for v in site_health["site_anomaly_score"]]
            out["site_suspect_streak"] = list(site_health["site_suspect_streak"])
        return out
    out = {"skipped_rounds": site_health["site_skipped_rounds"][site_index],
           "quarantined": site_health["site_quarantined"][site_index]}
    if reputation:
        out["anomaly_score"] = round(site_health["site_anomaly_score"][site_index], 6)
        out["suspect_streak"] = site_health["site_suspect_streak"][site_index]
    return out


def telemetry_log_fields(summary: dict | None, site_index: int | None = None) -> dict:
    """``logs.json`` fields of the round metrics' rollup
    (``telemetry.metrics.telemetry_summary``), JAX's: the remote's full
    lists with ``site_index=None``, one site's scalars for
    ``local{i}/logs.json``; ``{}`` when telemetry was off."""
    if not summary:
        return {}
    if site_index is None:
        return {
            "site_grad_norm_last": list(summary["site_grad_norm_last"]),
            "site_grad_norm_max": list(summary["site_grad_norm_max"]),
            "site_grad_norm_mean": list(summary["site_grad_norm_mean"]),
            "site_residual_norm_mean": list(summary["site_residual_norm_mean"]),
            "update_norm_last": summary["update_norm_last"],
            "payload_bytes_per_round": summary["payload_bytes_per_round"],
            "dcn_bytes_per_round": summary.get("dcn_bytes_per_round", 0.0),
        }
    return {
        "grad_norm_last": summary["site_grad_norm_last"][site_index],
        "grad_norm_max": summary["site_grad_norm_max"][site_index],
        "grad_norm_mean": summary["site_grad_norm_mean"][site_index],
        "residual_norm_mean": summary["site_residual_norm_mean"][site_index],
    }


def privacy_log_fields(results: dict) -> dict:
    """``logs.json`` fields of the spent differential privacy: the fit's
    final (ε, δ), absent when the DP mechanism was off or noiseless."""
    if "dp_epsilon" not in results:
        return {}
    return {"dp_epsilon": results["dp_epsilon"], "dp_delta": results["dp_delta"]}


def write_test_metrics_csv(dirpath: str, fold: int, metrics: dict) -> str:
    """``metrics``: name → value; accuracy and f1 must be present (the
    notebook reads columns 1 and 2)."""
    names = ["accuracy", "f1"] + [k for k in metrics if k not in ("accuracy", "f1")]
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, "test_metrics.csv")
    with open(path, "w") as fh:
        fh.write("fold," + ",".join(names) + "\n")
        fh.write(f"fold_{fold}," + ",".join(f"{metrics[n]:.5f}" for n in names) + "\n")
    return path


def zip_global_results(out_dir: str, remote_site: str = "remote", num_sites: int = 0,
                       task_id: str | None = None) -> str:
    """Zip the remote's result tree into ``simulatorRun/global_results.zip``
    (archive paths start at ``fold_k/``) and copy it into each local
    site's ``simulatorRun/``, as the reference's remote transfer does.
    ``task_id`` picks the task directory; ``None`` takes the only one and
    raises when there are several."""
    remote_dir = os.path.join(out_dir, remote_site, "simulatorRun")
    if task_id is None:
        tasks = [t for t in sorted(os.listdir(remote_dir))
                 if os.path.isdir(os.path.join(remote_dir, t))]
        if len(tasks) != 1:
            raise ValueError(f"out_dir holds {len(tasks)} task dirs {tasks}; pass task_id")
        task_id = tasks[0]
    task_dir = os.path.join(remote_dir, task_id)
    zpath = os.path.join(remote_dir, "global_results.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        for root, _, files in os.walk(task_dir):
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, task_dir))
    for i in range(num_sites):
        site_dir = os.path.join(out_dir, f"local{i}", "simulatorRun")
        if os.path.isdir(site_dir):
            shutil.copyfile(zpath, os.path.join(site_dir, "global_results.zip"))
    return zpath
