"""The port's fit resumed from its rotating checkpoint against the same fit
run without a break, on the ICA demo tree of tests/test_torch_port_fit.py
(its fixture and helpers), for both input pipelines.

A file of its own so that ``pytest --dist loadfile`` can place its two
cases (rankDAD fits of 4 + 2 + 2 epochs each) on another worker than the
rest of ``test_torch_port_fit.py``.
"""

import pytest
from test_torch_port_fit import _cfgs, _port_fold, _port_trainer, _same_state, tree  # noqa: F401

from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_resume_matches_the_uninterrupted_fit(tree, tmp_path, pipeline):
    _, cfg = _cfgs(tree, epochs=4, validation_epochs=1, monitor_metric="loss",
                   pipeline=pipeline, agg_engine="rankDAD")
    fold = _port_fold(cfg, tree)
    args = (fold["train"], fold["validation"], fold["test"])
    whole = _port_trainer(cfg, str(tmp_path / "whole")).fit(*args, verbose=False)
    _port_trainer(cfg.replace(epochs=2), str(tmp_path / "cut")).fit(*args, verbose=False)
    resumed = _port_trainer(cfg, str(tmp_path / "cut")).fit(*args, verbose=False, resume=True)
    assert resumed["epoch_losses"] == whole["epoch_losses"]
    for k in ("best_val_epoch", "best_val_metric", "stopped_epoch", "test_metrics",
              "test_scores", "site_test_metrics", "site_health"):
        assert resumed[k] == whole[k], k
    _same_state(resumed["state"], whole["state"])
    meta = tckpt.load_meta(str(tmp_path / "cut" / "remote" / "simulatorRun" /
                               "ICA-Classification" / "fold_0" / "checkpoint_latest.msgpack"))
    assert meta["epoch"] == 4 and len(meta["epoch_losses"]) == 4
    assert len(meta["time_spent_on_computation"]) == 4
    assert {"best_val_epoch", "best_val_metric", "since_best", "iter_durations",
            "cumulative_total_duration", "fold"} <= set(meta)
