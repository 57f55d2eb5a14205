"""Weight bridge: the JAX package's ICA-LSTM variables and training state
as the port's.

The input is the nested dicts that the JAX model carries, with numpy arrays
(or anything ``numpy.asarray`` takes) as leaves. Flax kernels are ``[in,
out]`` and ``nn.Linear`` weights ``[out, in]``; the LSTM cells keep the JAX
layout and both biases, ``b_ih`` and ``b_hh``, leaf for leaf. A tree with a
missing or an extra leaf is rejected.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` (its numpy
leaves: params, batch_stats, the optax Adam ``count/mu/nu``, the engine
state, round and health) into the port's :class:`~.trainer.steps.TrainState`,
and :func:`train_state_to_jax` turns one back into numpy trees in JAX
layout; :func:`train_state_from_tree` reads those trees back (the
checkpoint files carry them). The engine states (rankDAD's per-site Ω
``[S, n, r]``, powerSGD's per-site ``q [S, n, r]`` and ``e [S, m, n]``) are
kept in the JAX matrix orientation by both packages, so they cross
unchanged, leaf for leaf (None for a dense leaf).
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = ("encoder", "cls_fc1", "cls_fc2", "cls_fc3")
_CELL = ("w_ih", "b_ih", "w_hh", "b_hh")
_STATS = (("cls_bn.running_mean", "cls_bn/mean"), ("cls_bn.running_var", "cls_bn/var"))


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


def _param_names(bidirectional: bool) -> list[tuple[str, str, bool]]:
    """``(port name, JAX path, transposed)`` for every parameter."""
    names = []
    for n in _DENSE:
        names += [(f"{n}.weight", f"{n}/kernel", True), (f"{n}.bias", f"{n}/bias", False)]
    for d in ("fwd", "rev") if bidirectional else ("fwd",):
        names += [(f"lstm.{d}.{leaf}", f"lstm/{d}/{leaf}", False) for leaf in _CELL]
    names += [("cls_bn.weight", "cls_bn/scale", False), ("cls_bn.bias", "cls_bn/bias", False)]
    return names


def jax_transposed_leaves(bidirectional: bool = True) -> frozenset:
    """The port parameters stored as the transpose of their JAX matrix
    (``nn.Linear`` weights ``[out, in]``): what the low-rank engines
    factorize through a transposed view."""
    return frozenset(n for n, _, tr in _param_names(bidirectional) if tr)


def jax_leaf_index(bidirectional: bool = True) -> dict:
    """Each port parameter's index among the leaves of the JAX params tree
    in ``jax.tree.flatten`` order, which sorts the keys at every level:
    the key of powerSGD's first Q."""
    names = sorted(_param_names(bidirectional), key=lambda t: tuple(t[1].split("/")))
    return {n: i for i, (n, _, _) in enumerate(names)}


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


def _raise_if(problems: list) -> None:
    if problems:
        raise ValueError("not an ICALstm variable tree: " + "; ".join(problems))


def _port_params(p: dict, bidirectional: bool) -> dict:
    return {n: _t(p[j].T if tr else p[j]) for n, j, tr in _param_names(bidirectional)}


def _params_to_port(tree, bidirectional: bool, what: str) -> dict:
    """A params-shaped JAX tree (Adam's mu or nu) as port tensors by
    ``state_dict`` name."""
    p, problems = _leaves(tree), []
    _check_leaves(problems, what, p, {j for _, j, _ in _param_names(bidirectional)})
    _raise_if(problems)
    return _port_params(p, bidirectional)


def _params_to_jax(tensors: dict, bidirectional: bool) -> dict:
    flat = {}
    for n, j, tr in _param_names(bidirectional):
        a = tensors[n].detach().cpu().numpy()
        flat[j] = a.T if tr else a
    return _nest(flat)


def icalstm_params_from_jax(params, batch_stats, bidirectional: bool = True) -> dict:
    """``(params, batch_stats)`` of the JAX ``ICALstm`` → the port
    :class:`~.models.icalstm.ICALstm`'s ``state_dict`` (f32 CPU tensors)."""
    p, s, problems = _leaves(params), _leaves(batch_stats), []
    _check_leaves(problems, "params", p, {j for _, j, _ in _param_names(bidirectional)})
    _check_leaves(problems, "batch_stats", s, {j for _, j in _STATS})
    _raise_if(problems)
    sd = _port_params(p, bidirectional)
    sd.update({n: _t(s[j]) for n, j in _STATS})
    return sd


def _adam_part(opt_state):
    """The optax ``ScaleByAdamState`` inside an optimizer state (a chain's
    tuple), or None for a stateless optimizer such as SGD."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    return next((p for p in parts if hasattr(p, "mu") and hasattr(p, "nu")), None)


def train_state_from_jax(state, bidirectional: bool = True, rng: int = 0, device=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's ``TrainState`` on ``device`` (the card unless
    the caller asks for ``"cpu"``). JAX's PRNG key does not carry over:
    the port draws dropout from ``rng``."""
    adam = _adam_part(state.opt_state)
    opt = {} if adam is None else {"count": adam.count, "mu": adam.mu, "nu": adam.nu}
    return train_state_from_tree(
        {"params": state.params, "batch_stats": state.batch_stats, "opt_state": opt,
         "engine_state": state.engine_state, "rng": rng, "round": state.round,
         "health": state.health}, bidirectional, device)


#: the engine states' keys: rankDAD's warm-start Ω, powerSGD's right
#: factor and residual; each a params-shaped tree of per-site leaves
_ENGINE_STATES = ({"omega"}, {"q", "e"})


def engine_state_from_jax(engine_state, bidirectional: bool = True, device=None) -> dict:
    """A JAX engine state (``{}`` for dSGD, rankDAD's ``{"omega": ...}``,
    powerSGD's ``{"q": ..., "e": ...}``) as the port's, by ``state_dict``
    name; raises ``ValueError`` for a tree of other leaves."""
    if not engine_state:
        return {}
    if set(engine_state) not in _ENGINE_STATES:
        raise ValueError(f"not an engine state of the port: keys {sorted(engine_state)}")
    out, problems = {}, []
    for key in sorted(engine_state):
        tree = _leaves(engine_state[key])
        _check_leaves(problems, f"engine_state {key}", tree,
                      {j for _, j, _ in _param_names(bidirectional)})
        _raise_if(problems)
        out[key] = {n: None if tree[j] is None else _t(tree[j]).to(device)
                    for n, j, _ in _param_names(bidirectional)}
    return out


def train_state_from_tree(tree: dict, bidirectional: bool = True, device=None):
    """A training state as numpy trees in JAX layout (what
    :func:`train_state_to_jax` gives: ``params``, ``batch_stats``,
    ``opt_state`` ``{"count", "mu", "nu"}`` or ``{}``, ``engine_state``,
    ``rng`` (the port's int seed), ``round``, ``health``) as the port's
    ``TrainState`` on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    from .core.device import resolve_device
    from .trainer.steps import TrainState

    dev = resolve_device(device)
    sd = icalstm_params_from_jax(tree["params"], tree["batch_stats"], bidirectional)
    params = {n: sd[n].to(dev) for n, _, _ in _param_names(bidirectional)}
    stats = {n: sd[n].to(dev) for n, _ in _STATS}
    opt, opt_state = tree["opt_state"], {}
    if opt:
        opt_state = {
            "count": torch.tensor(int(np.asarray(opt["count"])), dtype=torch.int32, device=dev),
            "mu": {n: v.to(dev) for n, v in _params_to_port(opt["mu"], bidirectional, "mu").items()},
            "nu": {n: v.to(dev) for n, v in _params_to_port(opt["nu"], bidirectional, "nu").items()},
        }
    health = {k: torch.from_numpy(np.array(v, dtype=np.int32)).to(dev)
              for k, v in tree["health"].items()}
    return TrainState(params=params, batch_stats=stats, opt_state=opt_state,
                      engine_state=engine_state_from_jax(tree["engine_state"], bidirectional, dev),
                      rng=int(tree["rng"]), round=int(np.asarray(tree["round"])), health=health)


def train_state_to_jax(state, bidirectional: bool = True) -> dict:
    """The port's ``TrainState`` as numpy trees in JAX layout: ``params``,
    ``batch_stats``, ``opt_state`` (``{"count", "mu", "nu"}`` for Adam,
    ``{}`` for SGD), ``engine_state`` (``{}`` for dSGD, rankDAD's
    ``{"omega": ...}``, powerSGD's ``{"q": ..., "e": ...}``, as JAX nests
    them), ``rng`` (the int seed), ``round``
    and ``health``."""
    opt = {}
    if state.opt_state:
        opt = {"count": int(state.opt_state["count"]),
               "mu": _params_to_jax(state.opt_state["mu"], bidirectional),
               "nu": _params_to_jax(state.opt_state["nu"], bidirectional)}
    return {
        "params": _params_to_jax(state.params, bidirectional),
        "batch_stats": _nest({j: state.batch_stats[n].detach().cpu().numpy() for n, j in _STATS}),
        "opt_state": opt,
        "engine_state": {key: _nest({
            j: None if tree[n] is None else tree[n].detach().cpu().numpy()
            for n, j, _ in _param_names(bidirectional)})
            for key, tree in state.engine_state.items()},
        "rng": int(state.rng),
        "round": int(state.round),
        "health": {k: v.cpu().numpy() for k, v in state.health.items()},
    }
