"""The port's site data against the JAX package's: the ICA dataset and its
windowing (data/ica.py), the splits (data/splits.py), the demo tree
(data/demo.py), the per-site config resolution (core/config.py), the
per-fold site arrays of the runner (runner/fed_runner.py
``load_site_splits``) and the host batches (data/batching.py). Every
comparison is exact: the same files, the same index sets, the same bytes."""

import dataclasses
import json
import os

import numpy as np
import pytest

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.data import demo as jdemo
from dinunet_implementations_tpu.data import ica as jica
from dinunet_implementations_tpu.data import splits as jsplits
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import api as tdata
from dinunet_implementations_tpu_torch.data import batching as tbatching
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.data import ica as tica
from dinunet_implementations_tpu_torch.data import splits as tsplits

TREE = dict(n_sites=3, subjects=20, comps=16, temporal=80, window=10)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kw", [{}, TREE, dict(TREE, seed=5, stride=5, shift=0.3)])
def test_demo_tree_is_file_for_file_the_jax_tree(tmp_path, kw):
    jdemo.make_ica_demo_tree(str(tmp_path / "jax"), **kw)
    tdemo.make_ica_demo_tree(str(tmp_path / "port"), **kw)
    want, got = _tree_files(tmp_path / "jax"), _tree_files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("stride", [10, 5, 7])
def test_window_timecourses_match_jax(stride):
    data = np.random.default_rng(1).standard_normal((5, 6, 83)).astype(np.float32)
    _same(tica.window_timecourses(data, 80, 10, stride),
          jica.window_timecourses(data, 80, 10, stride), stride)


def _site_dataset(pkg_data, pkg_ica, cfg, site_dir):
    cache = dataclasses.asdict(cfg.ica_args)
    return pkg_data.build_site_dataset(pkg_ica.ICADataset, pkg_ica.ICADataHandle, cache,
                                       {"baseDirectory": site_dir}, mode=cfg.mode)


def test_ica_dataset_arrays_match_jax(tmp_path):
    root = jdemo.make_ica_demo_tree(str(tmp_path), **dict(TREE, stride=5))
    jcfgs = jconfig.resolve_site_configs(jconfig.TrainConfig(task_id="ICA-Classification"), root)
    tcfgs = tconfig.resolve_site_configs(tconfig.TrainConfig(task_id="ICA-Classification"), root)
    for i, (jc, tc) in enumerate(zip(jcfgs, tcfgs, strict=True)):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        jds, tds = _site_dataset(jdata, jica, jc, d), _site_dataset(tdata, tica, tc, d)
        assert len(tds) == len(jds) == TREE["subjects"]
        assert tds.indices == jds.indices
        want, got = jds.as_arrays(), tds.as_arrays()
        for name in ("inputs", "labels", "indices"):
            _same(getattr(got, name), getattr(want, name), name)
        assert got.inputs.shape[1:] == (8, TREE["comps"], TREE["window"])
        # the generic loader of the base class gives the same arrays
        generic = tdata.SiteDataset.as_arrays(tds)
        for name in ("inputs", "labels", "indices"):
            _same(getattr(generic, name), getattr(want, name), name)
        assert tds.path() == jds.path() == os.path.join(d, "timecourses.npz")


@pytest.mark.parametrize("n,ratio,seed", [(20, (0.8, 0.1, 0.1), 0), (37, (0.7, 0.15, 0.15), 3),
                                          (11, (0.8, 0.2), 1), (9, [0.5, 0.5, 0.0], 2)])
def test_split_by_ratio_matches_jax(n, ratio, seed):
    want, got = jsplits.split_by_ratio(n, ratio, seed), tsplits.split_by_ratio(n, ratio, seed)
    for k in jsplits.SPLIT_KEYS:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("n,k,seed", [(20, 2, 0), (23, 3, 1), (40, 5, 7)])
def test_kfold_splits_match_jax(n, k, seed):
    want, got = jsplits.kfold_splits(n, k, seed), tsplits.kfold_splits(n, k, seed)
    assert len(got) == len(want) == k
    for w, g in zip(want, got):
        for key in jsplits.SPLIT_KEYS:
            _same(g[key], w[key], key)
    with pytest.raises(ValueError, match="num_folds"):
        tsplits.kfold_splits(n, 1)


def test_resolve_splits_matches_jax_with_split_files_and_folds(tmp_path):
    for i, spec in enumerate(({"train": [0, 2, 4], "validation": [1], "test": [3]},
                              {"train": [1, 3], "test": [0, 2, 4]})):
        with open(tmp_path / f"split{i}.json", "w") as fh:
            json.dump(spec, fh)
    cases = [dict(split_files=("split0.json", "split1.json"), base_dir=str(tmp_path)),
             dict(num_folds=4, seed=2), dict(split_ratio=(0.6, 0.2, 0.2), seed=9), dict()]
    for kw in cases:
        want, got = jsplits.resolve_splits(25, **kw), tsplits.resolve_splits(25, **kw)
        assert len(got) == len(want), kw
        for w, g in zip(want, got):
            for key in jsplits.SPLIT_KEYS:
                assert np.asarray(g[key]).tolist() == np.asarray(w[key]).tolist(), (kw, key)


def test_resolve_site_configs_with_gui_lists_matches_jax(tmp_path):
    spec = [{"split_ratio": {"value": [0.6, 0.2, 0.2]}, "batch_size": {"value": 4},
             "ICA-Classification_args": {"value": {"hidden_size": 12, "split_files": ["a.json"]}},
             "num_components": {"value": 8}, "monitor_metric": {"value": "loss"},
             "unknown_key": {"value": 1}},
            {"epochs": 3, "ica_args": {"window_size": 5}, "num_folds": 3, "log_header": "Loss|F1"}]
    with open(tmp_path / "inputspec.json", "w") as fh:
        json.dump(spec, fh)
    jbase = jconfig.TrainConfig(task_id="ICA-Classification", seed=4)
    tbase = tconfig.TrainConfig(task_id="ICA-Classification", seed=4)
    want = jconfig.resolve_site_configs(jbase, str(tmp_path), num_sites=3)
    got = tconfig.resolve_site_configs(tbase, str(tmp_path), num_sites=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in dataclasses.fields(tconfig.TrainConfig):
            if f.name not in ("fs_args", "ica_args", "smri3d_args", "multimodal_args"):
                assert getattr(g, f.name) == getattr(w, f.name), f.name
        for block in ("smri3d_args", "multimodal_args"):
            assert dataclasses.asdict(getattr(g, block)) == dataclasses.asdict(
                getattr(w, block)), block
        for f in dataclasses.fields(tconfig.ICAArgs):
            assert getattr(g.ica_args, f.name) == getattr(w.ica_args, f.name), f.name
        for f in dataclasses.fields(tconfig.FSArgs):
            assert getattr(g.fs_args, f.name) == getattr(w.fs_args, f.name), f.name
    assert got[0].split_ratio == (0.6, 0.2, 0.2) and got[0].ica_args.split_files == ("a.json",)
    assert got[2].ica_args == got[0].ica_args  # site 2 cycles to entry 0
    assert got[0].task_args() is got[0].ica_args
    single = tmp_path / "one"
    single.mkdir()
    with open(single / "inputspec.json", "w") as fh:
        json.dump({"batch_size": {"value": 2}}, fh)
    assert [c.batch_size for c in tconfig.resolve_site_configs(tbase, str(single))] == [2]
    assert tconfig.load_inputspec(str(single / "inputspec.json")) == \
        jconfig.load_inputspec(str(single / "inputspec.json"))


def _sites(cls, sizes=(9, 17, 0, 13), seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rng.standard_normal((n, 6, 4, 5)).astype(np.float32),
                rng.integers(0, 2, n).astype(np.int32),
                rng.permutation(n).astype(np.int32)) for n in sizes]


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, pad_mode="mask"),
                                dict(seed=1, drop_last=False), dict(seed=2, steps=7),
                                dict(shuffle=False, drop_last=False, pad_mode="mask")])
def test_host_batches_are_byte_identical_to_jax(kw):
    jsites, tsites = _sites(jdata.SiteArrays), _sites(tdata.SiteArrays)
    want, got = jbatching.plan_epoch(jsites, 4, **kw), tbatching.plan_epoch(tsites, 4, **kw)
    for name in ("inputs", "labels", "weights", "indices"):
        _same(getattr(got, name), getattr(want, name), name)
    assert (got.num_sites, got.steps, got.batch_size) == (want.num_sites, want.steps,
                                                          want.batch_size)
    plan = tbatching.plan_epoch_positions(tsites, 4, **kw)
    direct = tbatching.materialize_plan(tsites, plan)
    _same(direct.inputs, want.inputs, "materialize_plan")
    # padding slots carry zero input, label and weight and index -1
    pad = got.indices < 0
    assert (got.weights[pad] == 0).all() and (got.inputs[pad] == 0).all()
    assert (got.weights[~pad] == 1).all()


def test_eval_batches_are_byte_identical_to_jax():
    jsites, tsites = _sites(jdata.SiteArrays, seed=3), _sites(tdata.SiteArrays, seed=3)
    for b in (3, 4, 16):
        want, got = jbatching.plan_eval(jsites, b), tbatching.plan_eval(tsites, b)
        for name in ("inputs", "labels", "weights", "indices"):
            _same(getattr(got, name), getattr(want, name), f"{name} at batch {b}")
        # every sample exactly once
        assert int(got.weights.sum()) == sum(len(s) for s in tsites)


@pytest.mark.parametrize("kw", [dict(), dict(num_folds=3), dict(split_ratio=(0.6, 0.2, 0.2))])
def test_load_site_splits_gives_jax_arrays_per_fold_and_site(tmp_path, kw):
    from dinunet_implementations_tpu.runner import fed_runner as jrunner
    from dinunet_implementations_tpu_torch.runner import fed_runner as trunner

    root = tdemo.make_ica_demo_tree(str(tmp_path), **TREE)
    base = dict(task_id="ICA-Classification", seed=3, **kw)
    jcfgs = jconfig.resolve_site_configs(jconfig.TrainConfig(**base), root)
    tcfgs = tconfig.resolve_site_configs(tconfig.TrainConfig(**base), root)
    dirs = trunner.discover_site_dirs(root)
    assert dirs == jrunner.discover_site_dirs(root)
    want = jrunner.load_site_splits(jcfgs[0], dirs, jcfgs)
    got = trunner.load_site_splits(tcfgs[0], dirs, tcfgs)
    assert len(got) == len(want) == kw.get("num_folds", 1)
    for gf, wf in zip(got, want):
        for key in ("train", "validation", "test"):
            assert len(gf[key]) == len(wf[key]) == TREE["n_sites"]
            for g, w in zip(gf[key], wf[key]):
                for name in ("inputs", "labels", "indices"):
                    _same(getattr(g, name), getattr(w, name), f"{key} {name}")


def test_site_dirs_sort_by_number_as_in_jax(tmp_path):
    from dinunet_implementations_tpu.runner import fed_runner as jrunner
    from dinunet_implementations_tpu_torch.runner import fed_runner as trunner

    for name in ("local10", "local2", "local", "local_backup", "local0"):
        (tmp_path / "input" / name / "simulatorRun").mkdir(parents=True)
    got = trunner.discover_site_dirs(str(tmp_path))
    assert got == jrunner.discover_site_dirs(str(tmp_path))
    assert [os.path.basename(os.path.dirname(p)) for p in got][-3:] == ["local0", "local2",
                                                                         "local10"]
    assert trunner.discover_site_dirs(str(tmp_path / "input")) == [str(tmp_path / "input")]
