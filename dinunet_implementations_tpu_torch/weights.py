"""Weight bridge: the JAX package's model variables and training state as
the port's, for each ported model (ICALstm, MSANNet, SMRI3DNet,
MultimodalNet).

The input is the nested dicts that the JAX model carries, with numpy arrays
(or anything ``numpy.asarray`` takes) as leaves. Each model class builds
its own :class:`LeafTable` (``leaf_table``) and tells it from a tree's
leaves (``leaf_table_of``); the table names every parameter and running
statistic on both sides: flax kernels are ``[in, out]`` and ``nn.Linear``
weights ``[out, in]``; the LSTM cells keep the JAX layout and both biases, ``b_ih``
and ``b_hh``, leaf for leaf; MSANNet's BatchNorms keep no running
statistics, so its ``batch_stats`` is empty. A tree with a missing or an
extra leaf is rejected.

:func:`params_from_jax` turns ``(params, batch_stats)`` into the
``state_dict`` of the model a config names. :func:`train_state_from_jax`
carries a whole JAX ``TrainState`` (its numpy leaves: params,
batch_stats, the optax Adam ``count/mu/nu``, the engine state, round and
health) into the port's :class:`~.trainer.steps.TrainState`, and
:func:`train_state_to_jax` turns one back into numpy trees in JAX layout;
:func:`train_state_from_tree` reads those trees back (the checkpoint files
carry them). These read the model's table off the tree itself
(:func:`table_of`). The engine states (rankDAD's per-site Ω ``[S, n,
r]``, powerSGD's per-site ``q [S, n, r]`` and ``e [S, m, n]``) are kept
in the JAX matrix orientation by both packages, so they cross unchanged,
leaf for leaf (None for a dense leaf).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class LeafTable:
    """One model's leaves: ``params`` holds ``(port name, JAX path,
    transposed)`` for every parameter (``transposed``: the port keeps the
    transpose of the JAX matrix), ``stats`` ``(port buffer name, JAX
    path)`` for every running statistic."""

    model: str
    params: tuple
    stats: tuple = ()

    @property
    def transposed(self) -> frozenset:
        """The port parameters stored as the transpose of their JAX matrix
        (``nn.Linear`` weights ``[out, in]``): what the low-rank engines
        factorize through a transposed view."""
        return frozenset(n for n, _, tr in self.params if tr)

    @property
    def leaf_index(self) -> dict:
        """Each port parameter's index among the leaves of the JAX params
        tree in ``jax.tree.flatten`` order, which sorts the keys at every
        level: the key of powerSGD's first Q."""
        names = sorted(self.params, key=lambda t: tuple(t[1].split("/")))
        return {n: i for i, (n, _, _) in enumerate(names)}


def leaf_table(cfg) -> LeafTable:
    """The table of the model that ``cfg``'s task names, as the task
    registry gives it."""
    from .runner.registry import get_task

    return get_task(cfg.task_id).leaf_table(cfg)


def table_of(tree) -> LeafTable:
    """The table of a params tree, JAX's (nested dicts) or the port's
    (``state_dict`` names), from the registered model whose leaves it holds
    (each model's ``leaf_table_of``)."""
    from .runner.registry import TASKS

    paths = {tuple(re.split(r"[/.]", k)) for k in _leaves(tree)}
    for spec in TASKS.values():
        table = spec.model_cls.leaf_table_of(paths)
        if table is not None:
            return table
    raise ValueError(f"not the params of a ported model: leaves {sorted(paths)}")


def _leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (str(k),)))
        return out
    if tree is None or torch.is_tensor(tree):
        return {"/".join(prefix): tree}
    return {"/".join(prefix): np.asarray(tree)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _t(a) -> torch.Tensor:
    """A contiguous f32 CPU tensor of its own: from numpy (a transposed
    view too), or from a tensor of any float dtype (a bf16 checkpoint
    leaf). Contiguous, as the epoch's own results are, so that a restored
    state computes bit for bit what the state it was saved from would."""
    if torch.is_tensor(a):
        return a.detach().to(device="cpu", dtype=torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _check_leaves(problems: list, what: str, have: dict, want: set) -> None:
    if set(have) - want:
        problems.append(f"{what} has extra leaves {sorted(set(have) - want)}")
    if want - set(have):
        problems.append(f"{what} is missing leaves {sorted(want - set(have))}")


def _raise_if(problems: list, table: LeafTable) -> None:
    if problems:
        raise ValueError(f"not an {table.model} variable tree: " + "; ".join(problems))


def _port_params(p: dict, table: LeafTable) -> dict:
    # the last two axes: a per-site leaf [S, ...] (a buffered gradient)
    # transposes as its matrix does
    return {n: _t(np.swapaxes(p[j], -1, -2) if tr else p[j]) for n, j, tr in table.params}


def _params_to_port(tree, table: LeafTable, what: str, names=None) -> dict:
    """A params-shaped JAX tree (the params, Adam's mu or nu, a leading
    site axis or not) as port tensors by ``state_dict`` name; ``names``
    (default: every parameter) the leaves it must hold, e.g. the
    personalized heads'."""
    p, problems = _leaves(tree), []
    rows = [t for t in table.params if names is None or t[0] in names]
    _check_leaves(problems, what, p, {j for _, j, _ in rows})
    _raise_if(problems, table)
    return {n: _t(np.swapaxes(p[j], -1, -2) if tr else p[j]) for n, j, tr in rows}


def _params_to_jax(tensors: dict, table: LeafTable) -> dict:
    """Port tensors by ``state_dict`` name (every parameter, or a subset
    such as the heads) as a JAX-layout tree."""
    flat = {}
    for n, j, tr in table.params:
        if n in tensors:
            a = tensors[n].detach().cpu().numpy()
            flat[j] = np.swapaxes(a, -1, -2) if tr else a
    return _nest(flat)


def _stats_to_jax(tensors: dict, table: LeafTable) -> dict:
    return _nest({j: tensors[n].detach().cpu().numpy() for n, j in table.stats})


def _state_dict_from(table: LeafTable, params, batch_stats) -> dict:
    p, s, problems = _leaves(params), _leaves(batch_stats), []
    _check_leaves(problems, "params", p, {j for _, j, _ in table.params})
    _check_leaves(problems, "batch_stats", s, {j for _, j in table.stats})
    _raise_if(problems, table)
    sd = _port_params(p, table)
    sd.update({n: _t(s[j]) for n, j in table.stats})
    return sd


def params_from_jax(cfg, params, batch_stats) -> dict:
    """``(params, batch_stats)`` of the JAX model that ``cfg``'s task names
    → the port model's ``state_dict`` (f32 CPU tensors)."""
    return _state_dict_from(leaf_table(cfg), params, batch_stats)


def _adam_part(opt_state):
    """The optax ``ScaleByAdamState`` inside an optimizer state (a chain's
    tuple), or None for a stateless optimizer such as SGD."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    return next((p for p in parts if hasattr(p, "mu") and hasattr(p, "nu")), None)


def train_state_from_jax(state, rng: int = 0, device=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's ``TrainState`` on ``device`` (the card unless
    the caller asks for ``"cpu"``), its model's table read off the params
    tree. JAX's PRNG key does not carry over: the port draws dropout from
    ``rng``."""
    adam = _adam_part(state.opt_state)
    opt = {} if adam is None else {"count": adam.count, "mu": adam.mu, "nu": adam.nu}
    personal = getattr(state, "personal", None)
    if personal:
        padam = _adam_part(personal["opt"])
        personal = {"params": personal["params"],
                    "opt": {} if padam is None else {"count": padam.count, "mu": padam.mu,
                                                     "nu": padam.nu}}
    return train_state_from_tree(
        {"params": state.params, "batch_stats": state.batch_stats, "opt_state": opt,
         "engine_state": state.engine_state, "rng": rng, "round": state.round,
         "health": state.health, "buffers": getattr(state, "buffers", None),
         "overlap": getattr(state, "overlap", None), "personal": personal,
         "telemetry": getattr(state, "telemetry", None)}, device=device)


#: the engine states' keys: rankDAD's warm-start Ω, powerSGD's right
#: factor and residual; each a params-shaped tree of per-site leaves
_ENGINE_STATES = ({"omega"}, {"q", "e"})


def engine_state_from_jax(engine_state, table: LeafTable, device=None, names=None) -> dict:
    """A JAX engine state (``{}`` for dSGD, rankDAD's ``{"omega": ...}``,
    powerSGD's ``{"q": ..., "e": ...}``) of the model of ``table`` as the
    port's, by ``state_dict`` name; raises ``ValueError`` for a tree of
    other leaves. ``names`` (default: every parameter) are the leaves the
    engine aggregates: the shared ones under personalization."""
    if not engine_state:
        return {}
    if set(engine_state) not in _ENGINE_STATES:
        raise ValueError(f"not an engine state of the port: keys {sorted(engine_state)}")
    rows = [t for t in table.params if names is None or t[0] in names]
    out, problems = {}, []
    for key in sorted(engine_state):
        tree = _leaves(engine_state[key])
        _check_leaves(problems, f"engine_state {key}", tree, {j for _, j, _ in rows})
        _raise_if(problems, table)
        out[key] = {n: None if tree[j] is None else _t(tree[j]).to(device) for n, j, _ in rows}
    return out


def personal_to_jax(personal: dict | None, table: LeafTable) -> dict | None:
    """The personalized heads' per-site rows in JAX's layout: ``{"params":
    the head subtree [S, ...], "opt": {"count" [S], "mu", "nu"} (Adam) or
    {}}``, the head kernels transposed on their last two axes. None stays
    None."""
    if personal is None:
        return None
    opt = personal["opt"]
    return {"params": _params_to_jax(personal["params"], table),
            "opt": {} if not opt else {"count": opt["count"].cpu().numpy(),
                                       "mu": _params_to_jax(opt["mu"], table),
                                       "nu": _params_to_jax(opt["nu"], table)}}


def personal_from_jax(tree, table: LeafTable, device=None) -> dict | None:
    """:func:`personal_to_jax`'s trees (numpy leaves) as the port's rows on
    ``device``; None or empty gives None."""
    if not tree or not tree.get("params"):
        return None
    stored = _leaves(tree["params"])
    head = {n for n, j, _ in table.params if j in stored}
    params = _params_to_port(tree["params"], table, "personal params", head)
    opt, out = tree.get("opt") or {}, {}
    if opt:
        out = {"count": torch.from_numpy(np.array(opt["count"], np.int32)).to(device),
               "mu": {n: v.to(device) for n, v in
                      _params_to_port(opt["mu"], table, "personal mu", head).items()},
               "nu": {n: v.to(device) for n, v in
                      _params_to_port(opt["nu"], table, "personal nu", head).items()}}
    return {"params": {n: v.to(device) for n, v in params.items()}, "opt": out}


def slot_tree_to_jax(tree: dict | None, table: LeafTable) -> dict | None:
    """A staleness buffer (``{"grads", "weight", "age"}``) or the overlap
    stash (``{"grads", "stats", "weight", "loss", "live", "valid"}``),
    every leaf with the leading site axis, as JAX's tree: ``grads`` and
    ``stats`` in JAX layout, the per-site vectors as numpy. None stays
    None."""
    if tree is None:
        return None
    convert = {"grads": lambda v: _params_to_jax(v, table),
               "stats": lambda v: _stats_to_jax(v, table)}
    return {k: convert[k](v) if k in convert else v.cpu().numpy() for k, v in tree.items()}


def slot_tree_from_jax(tree, table: LeafTable, device=None) -> dict | None:
    """JAX's staleness buffer or overlap stash (numpy leaves) as the
    port's, on ``device``; None or empty gives None. Each vector keeps its
    dtype (``age`` int32)."""
    if not tree:
        return None

    def stats(v):
        st, problems = _leaves(v), []
        _check_leaves(problems, "stats", st, {j for _, j in table.stats})
        _raise_if(problems, table)
        return {n: _t(st[j]) for n, j in table.stats}

    convert = {"grads": lambda v: _params_to_port(v, table, "grads"), "stats": stats}
    out = {}
    for k, v in tree.items():
        if k in convert:
            out[k] = {n: t.to(device) for n, t in convert[k](v).items()}
        else:
            out[k] = torch.from_numpy(np.array(v)).to(device)
    return out


def telemetry_from_jax(tree, device=None) -> dict | None:
    """JAX's round-metric accumulators (``[S]`` numpy leaves) as the
    port's tensors on ``device``, each keeping its dtype (``rounds`` and
    ``held_rounds`` int32); None or empty gives None."""
    if not tree:
        return None
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}


def train_state_from_tree(tree: dict, table: LeafTable | None = None, device=None):
    """A training state as numpy trees in JAX layout (what
    :func:`train_state_to_jax` gives: ``params``, ``batch_stats``,
    ``opt_state`` ``{"count", "mu", "nu"}`` or ``{}``, ``engine_state``,
    ``rng`` (the port's int seed), ``round``, ``health``, optionally
    ``buffers``, ``overlap``, ``personal`` and ``telemetry``) as the port's
    ``TrainState`` on ``device`` (the card unless the caller asks for
    ``"cpu"``). ``table`` defaults to the params tree's own."""
    from .core.device import resolve_device
    from .trainer.steps import TrainState

    dev = resolve_device(device)
    table = table or table_of(tree["params"])
    sd = _state_dict_from(table, tree["params"], tree["batch_stats"])
    params = {n: sd[n].to(dev) for n, _, _ in table.params}
    stats = {n: sd[n].to(dev) for n, _ in table.stats}
    opt, opt_state = tree["opt_state"], {}
    if opt:
        opt_state = {
            "count": torch.tensor(int(np.asarray(opt["count"])), dtype=torch.int32, device=dev),
            "mu": {n: v.to(dev) for n, v in _params_to_port(opt["mu"], table, "mu").items()},
            "nu": {n: v.to(dev) for n, v in _params_to_port(opt["nu"], table, "nu").items()},
        }
    from .robustness.health import health_from_numpy

    health = health_from_numpy(tree["health"], dev)
    personal = personal_from_jax(tree.get("personal"), table, dev)
    # under personalization the engine state covers the shared leaves only
    shared = None if personal is None else set(params) - set(personal["params"])
    return TrainState(params=params, batch_stats=stats, opt_state=opt_state,
                      engine_state=engine_state_from_jax(tree["engine_state"], table, dev, shared),
                      rng=int(tree["rng"]), round=int(np.asarray(tree["round"])), health=health,
                      buffers=slot_tree_from_jax(tree.get("buffers"), table, dev),
                      overlap=slot_tree_from_jax(tree.get("overlap"), table, dev),
                      personal=personal, telemetry=telemetry_from_jax(tree.get("telemetry"), dev))


def train_state_to_jax(state) -> dict:
    """The port's ``TrainState`` as numpy trees in JAX layout: ``params``,
    ``batch_stats``, ``opt_state`` (``{"count", "mu", "nu"}`` for Adam,
    ``{}`` for SGD), ``engine_state`` (``{}`` for dSGD, rankDAD's
    ``{"omega": ...}``, powerSGD's ``{"q": ..., "e": ...}``, as JAX nests
    them), ``rng`` (the int seed), ``round``, ``health``, the
    ``buffers`` and ``overlap`` trees of :func:`slot_tree_to_jax`, the
    heads' rows of :func:`personal_to_jax` and the round metrics
    ``telemetry`` (None while their mode is off);
    the model's table is read off the state's params."""
    table = table_of(state.params)
    opt = {}
    if state.opt_state:
        opt = {"count": int(state.opt_state["count"]),
               "mu": _params_to_jax(state.opt_state["mu"], table),
               "nu": _params_to_jax(state.opt_state["nu"], table)}
    return {
        "params": _params_to_jax(state.params, table),
        "batch_stats": _stats_to_jax(state.batch_stats, table),
        "opt_state": opt,
        "engine_state": {key: _nest({
            j: None if tree[n] is None else tree[n].detach().cpu().numpy()
            for n, j, _ in table.params if n in tree})
            for key, tree in state.engine_state.items()},
        "rng": int(state.rng),
        "round": int(state.round),
        "health": {k: v.cpu().numpy() for k, v in state.health.items()},
        "buffers": slot_tree_to_jax(state.buffers, table),
        "overlap": slot_tree_to_jax(state.overlap, table),
        "personal": personal_to_jax(getattr(state, "personal", None), table),
        "telemetry": (None if getattr(state, "telemetry", None) is None
                      else {k: v.cpu().numpy() for k, v in state.telemetry.items()}),
    }
