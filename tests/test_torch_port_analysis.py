"""The reference notebooks' tables (``analysis.py``), the port against the
JAX package.

Both packages' ``engine_comparison`` (here) and ``pretrain_study``
(``tests/test_torch_port_analysis_study.py``, its own file so that the two
run on separate workers) run on one
small FS demo tree (the port's ``data/demo.py``: the tree of
``tests/test_torch_port_fs_fit.py``, two sites of about 40 subjects, the
reference's 66 aseg features and MSANNet's full hidden widths from the
tree's inputspec), from one JAX-written checkpoint (``pretrained_path``);
JAX's fits run with ``mesh=None`` and JAX's cold-start Ω is handed across
for rankDAD, as in that file, whose fit tolerances hold the test ``[loss,
AUC]`` here. ``best_val_epoch`` and the fold ids are equal; the markdown
tables, the CSV header and its row count are the same.

The tree is the one those tolerances were measured on. A rankDAD fit's
test loss is sensitive to rounding at the 1e-3 level on other trees: on
the seed-0 tree of 64 subjects JAX's own 3-epoch fit moves from 0.48494 to
0.48419 when its start weights are perturbed by 1e-7 (relative), and the
port's lands on 0.48419; each round's aggregate agrees within 1.3e-4 of a
leaf's max (inside ``AGG_SHARE`` of that file).
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu import analysis as janalysis
from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.engines import lowrank as jlowrank
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu_torch import analysis as tanalysis
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import rankdad as trankdad
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner

TREE = dict(n_sites=2, subjects=40, seed=3)
KW = dict(epochs=3, batch_size=8, seed=2, monitor_metric="loss", patience=35)
# test [loss, AUC] (rounded to 5 decimals by the writer): the FS fit
# tolerances of tests/test_torch_port_fs_fit.py (FIT_TOL's pooled test
# metrics, 1e-4 for every engine)
METRIC_ATOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdemo.make_fs_demo_tree(str(tmp_path_factory.mktemp("fs_tree")), **TREE)


@pytest.fixture(scope="module")
def start(tree, tmp_path_factory):
    """A JAX checkpoint of the tree's model: every fit starts from it."""
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    state = jloop.FederatedTrainer(cfg, jregistry.get_task(cfg.task_id).build_model(cfg),
                                   None).init_state(jnp.ones((2, 66)),
                                                    num_sites=TREE["n_sites"])
    path = str(tmp_path_factory.mktemp("start") / "start.msgpack")
    jckpt.save_checkpoint(path, state)
    return path


def _jax_omega(G, r, device=None):
    m, n = (int(d) for d in tuple(getattr(G, "shape", G))[-2:])
    om = torch.from_numpy(np.array(jlowrank.default_omega(np.zeros((m, n)), r)))
    return om if device is None else om.to(device)


@pytest.fixture
def both(monkeypatch):
    """JAX's analysis over ``FedRunner(mesh=None)``, the port's on the CPU
    with JAX's cold-start Ω; the sanitizer off whatever an earlier test
    left in the environment (each package's runner reads the variable)."""
    monkeypatch.delenv("DINUNET_SANITIZE", raising=False)
    monkeypatch.setattr(janalysis, "FedRunner", functools.partial(jrunner.FedRunner, mesh=None))
    monkeypatch.setattr(tanalysis, "FedRunner",
                        functools.partial(trunner.FedRunner, device="cpu"))
    monkeypatch.setattr(trankdad, "default_omega", _jax_omega)


def _md_rows(text: str) -> list:
    """The markdown table's rows, each cell's numbers left out (the values
    are held apart, at their tolerance)."""
    return [[c.strip() if not any(ch.isdigit() for ch in c) else "#" for c in line.split("|")]
            for line in text.splitlines() if line.startswith("|")]


def test_engine_comparison_matches_jax(tree, start, tmp_path, both):
    kw = dict(KW, pretrained_path=start)
    want = janalysis.engine_comparison(tree, str(tmp_path / "j"), engines=("dSGD", "rankDAD"),
                                       base_cfg=jconfig.TrainConfig(**kw))
    got = tanalysis.engine_comparison(tree, str(tmp_path / "t"), engines=("dSGD", "rankDAD"),
                                      base_cfg=tconfig.TrainConfig(**kw), device="cpu")
    assert list(got["engines"]) == list(want["engines"]) == ["dSGD", "rankDAD"]
    for engine, w in want["engines"].items():
        g = got["engines"][engine]
        assert g["best_val_epoch"] == w["best_val_epoch"], engine
        np.testing.assert_allclose(g["test_metrics"], w["test_metrics"], atol=METRIC_ATOL,
                                   rtol=0, err_msg=engine)
        assert g["computation_time"] > 0 and g["total_duration"] > 0
    assert _md_rows(got["summary_markdown"]) == _md_rows(want["summary_markdown"])
    with open(tmp_path / "t" / "engine_comparison.md") as fh:
        assert fh.read() == got["summary_markdown"] + "\n"


SCORE = [["Acc. from scratch", "Accuracy", 0.8], ["Acc. from scratch", "F1", 0.7],
         ["Acc. with pre-training", "Accuracy", 0.85], ["Acc. with pre-training", "F1", 0.75]] * 3
EPOCHS = [["Convergence from scratch.", 60], ["Convergence with pre-training.", 40]] * 3


@pytest.mark.parametrize("matplotlib", ["present", "absent"])
def test_write_study_figures_without_training(tmp_path, monkeypatch, matplotlib):
    """Both boxplots from SCORE- and EPOCH-shaped rows, the same files as
    JAX's; ``[]`` from both when matplotlib does not import (the card's
    machine has none)."""
    if matplotlib == "absent":
        for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    else:
        pytest.importorskip("matplotlib")
    want = janalysis.write_study_figures(str(tmp_path / "j"), SCORE, EPOCHS)
    got = tanalysis.write_study_figures(str(tmp_path / "t"), SCORE, EPOCHS)
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == [
        os.path.relpath(p, tmp_path / "j") for p in want]
    assert len(got) == (2 if matplotlib == "present" else 0)
    for p in got:
        assert os.path.getsize(p) > 0
