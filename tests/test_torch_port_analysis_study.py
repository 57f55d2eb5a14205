"""The pretrain study of ``analysis.py`` (the reference ``NB.ipynb``
cells 6-17), the port against the JAX package, on the tree, start
checkpoint and tolerances of ``tests/test_torch_port_analysis.py``: both
arms, two folds of five (fold ids 0 and 2), two pretraining epochs, three
epochs; equal fold ids and ``best_val_epoch``, test loss, AUC, accuracy and
F1 within ``METRIC_ATOL``, the same markdown rows, CSV header and rows.
"""

import csv
import os

import numpy as np
from test_torch_port_analysis import KW, METRIC_ATOL, _md_rows, both, start, tree  # noqa: F401

from dinunet_implementations_tpu import analysis as janalysis
from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu_torch import analysis as tanalysis
from dinunet_implementations_tpu_torch.core import config as tconfig


def test_pretrain_study_matches_jax(tree, start, tmp_path, both):
    kw = dict(KW, agg_engine="dSGD", pretrained_path=start)
    # five folds: each fold trains on 3/5 of a site, more rows than the
    # pretraining batch of 16
    args = dict(num_folds=5, pretrain_epochs=2, folds=[0, 2])
    want = janalysis.pretrain_study(tree, str(tmp_path / "j"), base_cfg=jconfig.TrainConfig(**kw),
                                    **args)
    got = tanalysis.pretrain_study(tree, str(tmp_path / "t"), base_cfg=tconfig.TrainConfig(**kw),
                                   device="cpu", **args)
    for arm in ("scratch", "pretrained"):
        g, w = got["arms"][arm], want["arms"][arm]
        # the fold directories are named by the real fold id
        assert g["fold_ids"] == w["fold_ids"] == [0, 2]
        assert g["best_val_epochs"] == w["best_val_epochs"], arm
        np.testing.assert_allclose(g["test_losses"], w["test_losses"], atol=METRIC_ATOL, rtol=0)
        np.testing.assert_allclose(g["test_aucs"], w["test_aucs"], atol=METRIC_ATOL, rtol=0)
        np.testing.assert_allclose(g["test_accuracies"], w["test_accuracies"],
                                   atol=METRIC_ATOL, rtol=0)
        np.testing.assert_allclose(g["test_f1s"], w["test_f1s"], atol=METRIC_ATOL, rtol=0)
    assert got["arms"]["scratch"]["test_losses"] != got["arms"]["pretrained"]["test_losses"]
    assert got["epoch_speedup"] == want["epoch_speedup"]
    assert _md_rows(got["summary_markdown"]) == _md_rows(want["summary_markdown"])
    rows = {}
    for side in ("j", "t"):
        with open(tmp_path / side / "pretrain_study.csv", newline="") as fh:
            rows[side] = list(csv.reader(fh))
    assert rows["t"][0] == rows["j"][0] == ["arm", "fold", "best_val_epoch", "test_auc",
                                            "test_loss"]
    assert [r[:3] for r in rows["t"]] == [r[:3] for r in rows["j"]]
    assert len(rows["t"]) == 1 + 2 * 2
    assert [os.path.basename(p) for p in got["figures"]] == [
        os.path.basename(p) for p in want["figures"]]
