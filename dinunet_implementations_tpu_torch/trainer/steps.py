"""The federated train and eval steps: the counterpart of the JAX package's
``trainer/steps.py`` for one card.

Eval: :class:`FederatedTask` and :func:`eval_forward`, the one inference
forward that the serving engine runs; :func:`make_eval_fn` runs it over
dense per-site batches from a training state, every site of a step folded
into the rows of one call where the model's eval BatchNorm allows it.

Training: :func:`make_train_epoch_fn` runs one epoch of federated
training (the engine's aggregation: dSGD, rankDAD or powerSGD) with every site
folded onto the card, as the JAX epoch does with ``mesh=None``. Two
pipelines feed it the same rounds: ``"device"`` keeps the sites' data
resident as an ``[S, N_max, ...]`` inventory, takes an ``[S, steps, B]``
index plan an epoch and gathers each round's batch on the device;
``"host"`` takes the dense ``[S, steps, B, ...]`` epoch from the host and
copies each round's block to the device. A round runs
``local_iterations`` micro-batches per site with example-weighted gradient
accumulation, then an ``AttackPlan``'s transform of the hostile sites'
gradients, the engine's aggregation across sites, sync-BN, the round loss,
the health counters (and the reputation layer under a robust
aggregation), and ONE optimizer update on the aggregate.

Per-site gradients come from an explicit site axis: each round the
parameters enter the model as stride-0 views ``[S, ...]`` (every site
provably holds the same values), the model runs all sites in one pass
(``ICALstm.site_forward``: the LSTM kernels fold sites into rows;
``MSANNet.site_forward`` and ``MultimodalNet.site_forward``: batched
products, per-site BatchNorms and LayerNorms; ``SMRI3DNet.site_forward``:
one grouped convolution a stage, the sites side by side), and
autograd returns each site's own gradient ``[S, ...]``, where JAX takes
``vmap(grad)``.

Over a process group (``mesh=``, a parallel/mesh.py ``SiteMesh``) each
rank runs the same rounds on its own ``[K]`` block of the ``S = W·K``
sites: its inputs, masks and per-site state are that block, the engine
reduces in two levels over the group, and the round's loss, live totals
and sync-BN statistics are summed over the group as JAX's
``two_level_psum`` does (the live total once a round, in the loss's
collective, and handed to the engine); every rank then applies the same
update. A state
under a mesh holds the rank's block of every per-site leaf
(:func:`gather_site_state` and :func:`site_state_block` cross between
the two forms). Dropout draws every site's mask and keeps the block's
(``models.layers.SiteBlockDraw``), so the result does not depend on W.
Over a sliced mesh (parallel/mesh.py ``sliced_site_mesh``) the engine's
reductions grow the slice tier and the epoch takes the whole-slice
liveness mask and the slice quorum (:func:`make_train_epoch_fn`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device
from ..engines.base import MESH_PLANES_ITEM, default_async_buffers, staleness_weights
from ..models.layers import BatchNorm, SiteBlockDraw
from ..parallel.collectives import (
    check_robust_agg,
    flat_psum,
    per_site,
    site_all_gather,
    site_flat,
)
from ..privacy.dpsgd import make_dp_fn
from ..privacy.personalize import default_personal, graft_shared, head_leaf_paths, strip_tree
from ..robustness.health import REPUTATION_KEYS, default_health, reputation_fields
from ..telemetry.metrics import (
    TELEMETRY_KEYS,
    default_round_telemetry,
    jax_leaf_order,
    payload_bytes_of,
    tree_sq_sum,
)


class FederatedTask:
    """Bundles a model with its apply plumbing. The serving weights and
    running statistics live in the ``nn.Module``; training carries its own
    in a :class:`TrainState`."""

    def __init__(self, model):
        self.model = model

    def apply(self, x, train: bool = False, mask=None):
        return self.model(x, train=train, mask=mask)


def eval_forward(task: FederatedTask, x, y=None, w=None):
    """Softmax probabilities of ``x [B, ...]``; ``w [B]`` is the per-row
    valid mask (weight-0 rows are padding). With labels ``y`` it also
    returns the per-example cross-entropy; with ``y=None`` (serving) there
    is no label work at all."""
    with torch.inference_mode():
        logits = task.apply(x, train=False, mask=w)
        probs = torch.softmax(logits, -1)
        if y is None:
            return probs
        ce = -torch.log_softmax(logits, -1).gather(-1, y.long()[..., None])[..., 0]
        return probs, ce


class _StateTask:
    """A task whose forward reads its weights and running statistics from a
    training state's dicts instead of the module's own."""

    def __init__(self, model, tensors: dict):
        self.model, self.tensors = model, tensors

    def apply(self, x, train: bool = False, mask=None):
        return torch.func.functional_call(self.model, self.tensors, (x,),
                                          {"train": train, "mask": mask})


def _to_device(a, dev, dtype=None) -> torch.Tensor:
    """A host block (numpy or a CPU tensor, any strides) as a contiguous
    tensor on ``dev``."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype).contiguous()


def eval_folds_sites(model) -> bool:
    """Whether an eval may run the rows of several sites in one forward:
    exactly when every BatchNorm of ``model`` normalizes by its running
    statistics in eval (ICALstm) or has none (MultimodalNet), not by the
    batch's moments (MSANNet, SMRI3DNet)."""
    return all(m.track_running_stats for m in model.modules() if isinstance(m, BatchNorm))


def _global_sites(mesh, rows: int) -> int:
    """The global site count of an epoch over ``mesh`` whose per-site input
    has ``rows`` rows: the mesh's ``W·K`` when it was built for a site
    count (the input may then be the whole ``[S]`` or the rank's ``[K]``),
    else ``rows`` (the whole ``[S]``)."""
    return rows if mesh.pack is None else mesh.world * mesh.pack


def _block_of(a, S: int, block: slice):
    """The rank's rows of a per-site array whose leading dim is ``S`` (the
    global sites) or already the block's length."""
    n = block.stop - block.start
    if a.shape[0] == S:
        return a[block]
    if a.shape[0] == n:
        return a
    raise ValueError(f"a per-site array of {a.shape[0]} rows is neither the {S} sites nor this "
                     f"rank's {n}")


def make_eval_fn(task: FederatedTask, device=None, personalize: tuple = (), mesh=None):
    """The full-pass eval of a training state, on ``device`` (the card
    unless the caller asks for ``"cpu"``): ``eval_fn(state, inputs [S,
    steps, B, ...], labels [S, steps, B], weights [S, steps, B])`` returns
    per-site ``probs [S, steps, B, C]``, ``loss_sum [S]`` and ``weight_sum
    [S]``; metric scalars are computed on the host (trainer/metrics.py).

    Each step copies its ``[S, B, ...]`` block to the device and runs
    :func:`eval_forward`, the forward the serving engine runs. A model
    whose every BatchNorm keeps running statistics, and so normalizes each
    row by them in eval (:func:`eval_folds_sites`: ICALstm, and
    MultimodalNet, which has none), folds the sites into the rows of one
    call (two K1 launches on the card for ICALstm, one a direction), which
    is exact. A model whose BatchNorms take the batch moments in eval too
    (MSANNet, SMRI3DNet) runs each site's rows in a call of their own, so
    each site is normalized by its own rows, as JAX's per-site ``vmap``
    does. Weight-0
    rows are padding: they carry weight 0 into the loss sum and the
    statistics through ``mask=``. This is JAX's ``make_eval_fn``.

    ``mesh`` (a process group's ``SiteMesh``): each rank evaluates its own
    block of the sites of ``[S, ...]`` inputs and the outputs are gathered,
    so every rank returns all ``S`` sites' (JAX's ``fetch_site_outputs``);
    ``personalize`` is not run over a group.

    ``personalize`` (head patterns): a state that carries ``personal`` rows
    evaluates each site on its own head. A model that folds the sites
    keeps one call for every site's rows through its ``site_forward`` in
    eval mode, with the head leaves per site (ICALstm's LSTM still runs
    every site's rows in one call). Any other model runs each site's rows
    in a call of their own on its merged weights. A state without rows (a
    params-only restore) evaluates the global heads, as in JAX."""
    personal_on = bool(tuple(personalize))
    if mesh is not None:
        if personal_on:
            raise NotImplementedError("personalize over a process group (mesh) is not ported: "
                                      f"ROADMAP {MESH_PLANES_ITEM}")
        device = mesh.device
    dev = resolve_device(device)
    fold = eval_folds_sites(task.model)

    def eval_fn(state: TrainState, inputs, labels, weights):
        if mesh is not None:
            S_all = _global_sites(mesh, inputs.shape[0])
            block, axis = mesh.block(S_all), mesh.axis(S_all)
            probs, loss_sum, w_sum = local_eval(state, *(_block_of(a, S_all, block)
                                                         for a in (inputs, labels, weights)))
            return tuple(site_all_gather(t, axis) for t in (probs, loss_sum, w_sum))
        return local_eval(state, inputs, labels, weights)

    def local_eval(state: TrainState, inputs, labels, weights):
        S, steps, B = inputs.shape[:3]
        heads = (state.personal["params"]
                 if personal_on and state.personal is not None else None)
        st = _StateTask(task.model, {**state.params, **state.batch_stats})
        sts = [st] * S
        if heads is not None and not fold:
            sts = [_StateTask(task.model, {**state.params, **{k: v[s] for k, v in heads.items()},
                                           **state.batch_stats}) for s in range(S)]
        probs, loss_sum, w_sum = [], torch.zeros(S, device=dev), torch.zeros(S, device=dev)
        for k in range(steps):
            x = _to_device(inputs[:, k], dev, torch.float32)
            y = _to_device(labels[:, k], dev)
            w = _to_device(weights[:, k], dev, torch.float32)
            if fold and heads is not None:
                p, ce = _site_eval(task.model, state, heads, x, y, w)
            elif fold:
                p, ce = eval_forward(st, x.reshape((S * B,) + x.shape[2:]), y.reshape(-1),
                                     w.reshape(-1))
            else:
                p, ce = (torch.stack(t) for t in zip(
                    *(eval_forward(sts[s], x[s], y[s], w[s]) for s in range(S))))
            probs.append(p.reshape(S, B, -1))
            loss_sum = loss_sum + (ce.reshape(S, B) * w).sum(1)
            w_sum = w_sum + w.sum(1)
        return torch.stack(probs, 1), loss_sum, w_sum

    return eval_fn


def _site_eval(model, state: TrainState, heads: dict, x, y, w):
    """:func:`eval_forward` of every site at once with each site's own head
    leaves (``model.site_forward`` in eval mode): ``x [S, B, ...]`` →
    ``(probs [S, B, C], ce [S, B])``."""
    S = x.shape[0]
    params = {k: heads[k] if k in heads else v.unsqueeze(0).expand(S, *v.shape)
              for k, v in state.params.items()}
    with torch.inference_mode():
        logits, _ = model.site_forward(params, x, w, state.batch_stats, train=False)
        probs = torch.softmax(logits, -1)
        ce = -torch.log_softmax(logits, -1).gather(-1, y.long()[..., None])[..., 0]
    return probs, ce


def cross_entropy(logits, labels, weights):
    """Masked mean cross-entropy over the last batch axis: ``logits [...,
    B, C]``, ``labels, weights [..., B]`` → ``[...]``, so a leading site
    axis gives one loss per site."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (ce * weights).sum(-1) / torch.clamp(weights.sum(-1), min=1.0)


@dataclass(frozen=True)
class Optimizer:
    """A functional optimizer, optax's shape: ``init(params) -> state``,
    ``update(grads, state) -> (updates, state)``; params and states are
    dicts of tensors, so a round with no live weight holds them with
    ``torch.where``."""

    name: str
    init: Callable
    update: Callable


def make_optimizer(name: str, learning_rate: float) -> Optimizer:
    """Adam (the reference's optimizer) or SGD at ``learning_rate``, with
    optax's arithmetic: Adam's moments ``(1 - b) * g**k + b * m``, bias
    correction by the step ``count``, and ``eps`` outside the square
    root."""
    if name == "adam":
        return _adam(learning_rate)
    if name == "sgd":
        return Optimizer("sgd", lambda params: {},
                         lambda grads, state: ({k: -learning_rate * g for k, g in grads.items()},
                                               state))
    raise ValueError(f"unknown optimizer {name!r}")


def _adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state):
        """One step; a ``count`` with a leading site axis (the personalized
        heads' per-site rows, ``[S]``) corrects each row's moments by its
        own count."""
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
        count = state["count"] + 1
        c = count.float()
        bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
        updates = {k: -lr * ((mu[k] / per_site(bc1, mu[k]))
                             / (torch.sqrt(nu[k] / per_site(bc2, nu[k])) + eps)) for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer("adam", init, update)


@dataclass
class TrainState:
    """What an epoch carries: ``params`` and ``batch_stats`` by the model's
    ``state_dict`` names, the optimizer state (``{"count", "mu", "nu"}`` for
    Adam), the per-site engine state (``{}`` for dSGD; rankDAD's
    ``{"omega": {name: [S, n, r] or None}}``), the dropout seed ``rng``, the
    global ``round`` and the per-site ``health`` counters. ``buffers`` are
    the per-slot staleness buffers of the buffered-async rounds
    (``engines.default_async_buffers``), ``overlap`` the stash of the
    overlapped rounds (:func:`default_overlap_stash`), ``personal`` the
    personalized heads' per-site rows (``{"params": {name: [S, ...]},
    "opt": ...}``, privacy/personalize.py) and ``telemetry`` the per-site
    round metrics (telemetry/metrics.py), each None while its mode is
    off."""

    params: dict
    batch_stats: dict
    opt_state: dict
    engine_state: dict
    rng: int
    round: int
    health: dict
    buffers: dict | None = None
    overlap: dict | None = None
    personal: dict | None = None
    telemetry: dict | None = None


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _freeze_dead(alive, new, old):
    """Hold a dead site's engine state for the round, leaf by leaf of the
    nested state (``alive [S]`` bool; None leaves stay None): its
    warm-start subspace resumes where it left off when the site returns."""
    if isinstance(new, dict):
        return {k: _freeze_dead(alive, v, old[k]) for k, v in new.items()}
    return None if new is None else torch.where(per_site(alive, new), new, old)


def init_train_state(task: FederatedTask, engine, optimizer: Optimizer, rng: int = 0,
                     num_sites: int = 1, reputation: bool = False, staleness_bound: int = 0,
                     overlap_rounds: bool = False, personalize: tuple = (),
                     telemetry: bool = False) -> TrainState:
    """The first state of a fit, from the weights and running statistics of
    ``task.model`` (on the model's device). The engine state is one copy
    per site, a leading ``[num_sites]`` axis, as in JAX; ``reputation=True``
    (a robust aggregation's fit) adds the reputation health fields,
    ``staleness_bound > 0`` the never-deposited staleness buffers,
    ``overlap_rounds=True`` the empty overlap stash and ``personalize``
    (head patterns, privacy/personalize.py) the per-site head rows, with the
    engine state built on the shared leaves only; ``telemetry=True`` the
    zero round metrics (telemetry/metrics.py)."""
    params = {k: v.detach().clone() for k, v in task.model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in task.model.named_buffers()}
    dev = next(iter(params.values())).device
    head = head_leaf_paths(params, personalize)
    site_state = _tree_map(lambda a: a.unsqueeze(0).repeat(num_sites, *([1] * a.dim())),
                           engine.init(strip_tree(params, head, keep_head=False)))
    return TrainState(params=params, batch_stats=stats, opt_state=optimizer.init(params),
                      engine_state=site_state, rng=rng, round=0,
                      health=default_health(num_sites, reputation, dev),
                      buffers=(default_async_buffers(num_sites, params)
                               if staleness_bound > 0 else None),
                      overlap=(default_overlap_stash(num_sites, params, stats)
                               if overlap_rounds else None),
                      personal=(default_personal(num_sites, params, head, optimizer)
                                if head else None),
                      telemetry=default_round_telemetry(num_sites, dev) if telemetry else None)


#: the TrainState fields whose leaves carry the leading per-site axis
SITE_FIELDS = ("engine_state", "health", "buffers", "overlap", "personal", "telemetry")


def _site_rows(state: TrainState) -> int:
    return next(iter(state.health.values())).shape[0]


def gather_site_state(state: TrainState, mesh) -> TrainState:
    """A mesh state (every per-site leaf the rank's ``[K]`` block) as the
    whole ``[S]`` state, on every rank: one all-gather a per-site leaf. A
    collective: every rank of the group calls it. ``mesh=None`` returns
    ``state``."""
    if mesh is None:
        return state
    axis = mesh.axis(mesh.world * _site_rows(state))
    return dataclasses.replace(state, **{
        f: _tree_map(lambda a: site_all_gather(a, axis), getattr(state, f)) for f in SITE_FIELDS})


def site_state_block(state: TrainState, mesh) -> TrainState:
    """A whole ``[S]`` state (a checkpoint's) as this rank's block of every
    per-site leaf, on the rank's device; ``mesh=None`` returns ``state``."""
    if mesh is None:
        return state
    block = mesh.block(_site_rows(state))
    return dataclasses.replace(state, **{
        f: _tree_map(lambda a: a[block].contiguous(), getattr(state, f)) for f in SITE_FIELDS})


def default_overlap_stash(num_sites: int, params: dict, batch_stats: dict) -> dict:
    """The empty stash of the overlapped rounds, JAX's
    ``default_overlap_stash``: per site the ``grads``, ``stats``,
    ``weight``, ``loss`` and ``live`` of the round whose update is still to
    be applied, and ``valid`` (0: nothing stashed yet, so the fit's first
    round applies nothing). Every leaf has the leading ``[num_sites]``
    axis."""
    dev = next(iter(params.values())).device

    def zeros(tree):
        return {k: torch.zeros((num_sites,) + tuple(v.shape), dtype=v.dtype, device=dev)
                for k, v in tree.items()}

    vec = lambda: torch.zeros(num_sites, dtype=torch.float32, device=dev)  # noqa: E731
    return {"grads": zeros(params), "stats": zeros(batch_stats), "weight": vec(),
            "loss": vec(), "live": vec(), "valid": vec()}


def _gather_batch(inv_x, inv_y, ixs, poison=None):
    """On-device batch gather for every site: ``ixs [S, L, B]`` sample
    positions into the resident inventory (``inv_x [S, N, ...]``, ``inv_y
    [S, N]``); ``-1`` marks padding, which becomes zero input, label and
    weight. ``poison [S]`` (the round's NaN-injection gate) overwrites a
    site's whole round block with NaN. Returns ``(x [S, L, B, ...], y, w)``."""
    valid = ixs >= 0
    flat = torch.clamp(ixs, min=0).reshape(ixs.shape[0], -1)
    site = torch.arange(ixs.shape[0], device=ixs.device)[:, None]
    xb = inv_x[site, flat].reshape(ixs.shape + inv_x.shape[2:])
    yb = inv_y[site, flat].reshape(ixs.shape)
    xb = torch.where(per_site(valid, xb), xb, torch.zeros((), dtype=xb.dtype, device=xb.device))
    yb = torch.where(valid, yb, torch.zeros((), dtype=yb.dtype, device=yb.device))
    if poison is not None:
        nan = torch.full((), float("nan"), dtype=xb.dtype, device=xb.device)
        xb = torch.where(per_site(poison > 0, xb), nan, xb)
    return xb, yb, valid.float()


#: make_train_epoch_fn options of the JAX package that are not ported yet:
#: name -> (the value that means "off", the ROADMAP item that ports it)
_UNPORTED = {
    "sequence_microbatches": (0, "A11 (c)"),
}
#: options of the JAX package that only govern how its program runs (scan
#: inputs, buffer donation) and change no result: any value is taken
_EXECUTION_ONLY = ("rounds_scan_xs", "donate_state")


def _check_options(options: dict) -> None:
    """Refuse the JAX options this port does not run (see
    :func:`make_train_epoch_fn`), before anything is built."""
    for name in sorted(options):
        value = options[name]
        if name in _EXECUTION_ONLY:
            continue
        if name not in _UNPORTED:
            raise TypeError(f"make_train_epoch_fn() got an unexpected option {name!r}")
        off, item = _UNPORTED[name]
        if value != off:
            raise NotImplementedError(f"make_train_epoch_fn({name}={value!r}) is not ported: "
                                      f"ROADMAP {item}")


def _hold(go, new, old):
    """``new`` where the 0-dim bool ``go`` holds, else ``old``, leaf by leaf
    through nested dicts (None leaves stay None)."""
    if isinstance(new, dict):
        return {k: _hold(go, v, old[k]) for k, v in new.items()}
    return None if new is None else torch.where(go, new, old)


def _ensure_health(health: dict, S: int, reputation: bool, dev) -> dict:
    """The epoch's health tree, as JAX's ``_ensure_health`` leaves it: fresh
    counters for another site count; the reputation fields added fresh
    when a robust epoch starts from a plain state, and dropped when a plain
    epoch starts from a robust one."""
    if health is None or health["streak"].shape[0] != S:
        return default_health(S, reputation, dev)
    if reputation and "suspect_streak" not in health:
        return {**health, **reputation_fields(S, dev)}
    if not reputation and "suspect_streak" in health:
        return {k: v for k, v in health.items() if k not in REPUTATION_KEYS}
    return health


def make_train_epoch_fn(task: FederatedTask, engine, optimizer: Optimizer,
                        local_iterations: int = 1, quarantine_rounds: int | None = 3,
                        device=None, pipeline: str = "device", attack_plan=None,
                        robust_agg: str = "none", reputation_z: float = 2.0,
                        reputation_rounds: int = 8, staleness_bound: int = 0,
                        staleness_decay: float = 0.5, overlap_rounds: bool = False,
                        dp_clip: float = 0.0, dp_noise_multiplier: float = 0.0, dp_seed: int = 0,
                        personalize: tuple = (), telemetry: bool = False, mesh=None,
                        min_slices: int = 1, **options):
    """Build the epoch function, on ``device`` (the card unless the caller
    asks for ``"cpu"``). Both pipelines return ``(state, losses
    [rounds])`` and run the same rounds; only the batch source differs.

    - ``pipeline="device"`` (the default): ``epoch(state, inv_x [S, N_max,
      ...], inv_y [S, N_max], idx [S, steps, B], live=None, poison=None,
      attack=None)``. ``idx`` is the epoch's plan
      (``data.plan_epoch_positions``) into the resident inventory, and each
      round gathers its batch on the device; ``poison [S, rounds]`` is the
      NaN-injection gate.
    - ``pipeline="host"``: ``epoch(state, inputs [S, steps, B, ...],
      labels [S, steps, B], weights [S, steps, B], live=None,
      attack=None)``, the dense epoch of ``data.plan_epoch`` on the host
      (numpy or CPU tensors). Each round's ``[S, L, B, ...]`` block is
      copied to the device just before the round, so the device never
      holds the dense epoch. As in JAX, this path takes no ``poison``: NaN
      injection on the host path is the data layer's
      (``robustness.poison_inputs``).

    The default differs from JAX's ``make_train_epoch_fn``, which
    defaults to ``"host"``; JAX's ``TrainConfig.pipeline`` defaults to
    ``"device"``, and so does this function. Any other value raises
    ``ValueError``.

    ``steps`` are consumed in rounds of ``local_iterations`` micro-batches
    and a trailing remainder is dropped. ``live [S, rounds]`` is the
    scheduled liveness mask.

    Hostile sites: ``attack [S, rounds]`` is an ``AttackPlan``'s int32
    code mask (``robustness.attack_window``); each round the plan's
    transform (``robustness.make_attack_fn``, keyed by the global round and
    the site row) replaces a hostile site's finished round gradient before
    the engine. A mask without ``attack_plan`` raises ``ValueError``, as
    in JAX. ``robust_agg`` (the engine's mode, ``"none"`` by default)
    switches on the reputation layer: each round a live site's anomaly
    z-score, the larger of the z-scores of its distance to the aggregate
    and of its gradient norm across the live sites, above
    ``reputation_z`` extends its suspect streak, and
    ``reputation_rounds`` consecutive such rounds latch the quarantine
    flag (0 scores only); ``anomaly`` keeps a moving average of the
    score's positive part (robustness/health.py).

    Guarded rounds (``quarantine_rounds >= 0``, a ``live`` mask, an attack
    mask or the reputation layer): a site contributes iff it is scheduled
    live AND its round gradient is finite AND it is not quarantined; a dead
    site's engine state is frozen, its weight is 0 in the aggregate,
    sync-BN and the round loss; the health counters advance, and
    ``quarantine_rounds`` consecutive non-finite rounds latch the sticky
    quarantine flag (0 keeps the per-round skip only). A round with no live
    weight holds params, optimizer state and running statistics, and
    reports a NaN loss. ``quarantine_rounds < 0`` with none of the others
    runs the unguarded round. ``None`` means 3.

    Buffered-async rounds (``staleness_bound > 0``): each site owns a slot
    of ``state.buffers``. A round where the site arrives (scheduled live
    AND finite AND not quarantined) deposits its fresh gradient and example
    weight and resets the slot's age to 0; a round where it does not (a
    drop, a ``delay_at`` straggler, an empty membership slot) keeps the
    buffer and ages it. The engine aggregates the buffers, each slot
    weighted by ``weight * staleness_decay ** age`` and masked like a dead
    site past ``staleness_bound``; a slot's engine state freezes unless its
    weight is positive. The round loss, sync-BN and the health counters
    stay keyed on fresh arrivals; params and the optimizer hold in a round
    with no in-bound buffered weight. ``decay ** 0`` is exactly 1, so a
    round where every site arrives is the bulk-sync round bit for bit.

    Overlapped rounds (``overlap_rounds=True``): round *t* computes its
    gradients at the carried parameters and stashes them
    (``state.overlap``), and applies round *t - 1*'s stash, JAX's
    one-round-delayed pipelined update. The fit's first round applies
    nothing and reports a NaN loss; the health counters advance only on a
    valid stash; the liveness of a stashed round is that of the round its
    data came from, and so is the dropout seed. The stash rides the state,
    so it survives the epoch boundary and a checkpoint. On one card there
    is no collective to hide: the semantics are JAX's, on one stream.
    ``overlap_rounds`` with ``staleness_bound > 0`` raises ``ValueError``,
    as in JAX. Both modes imply the guarded round; both off run the
    program as before.

    The privacy plane (privacy/): ``dp_clip`` / ``dp_noise_multiplier``
    switch on DP-SGD, which clips each site's fresh round gradient to the
    norm ``dp_clip`` and adds ``dp_noise_multiplier · dp_clip`` of Gaussian
    noise drawn per (``dp_seed``, site, global round, leaf), right after the
    site's gradient phase and before an attack, the staleness buffers and
    the overlap stash (privacy/dpsgd.py; noise needs a clip). The engine's
    ``secure_agg`` mode takes the global round. ``personalize`` (head
    patterns, privacy/personalize.py) keeps the matched leaves out of the
    aggregation: each site's forward runs on its own head row of
    ``state.personal``, the engine sees the shared leaves only, the
    optimizer's aggregate is zero on the head leaves (the global head never
    moves), and each site's head row takes its own optimizer step, gated on
    the round's contribute mask (a dead site's head freezes; in the
    buffered mode on fresh arrivals, in the overlapped mode on the stash's
    round). An epoch built without ``personalize`` drops a state's rows; one
    built with it fills fresh rows from the current params when the state
    has none, or rows for another site count.

    Round metrics (``telemetry=True``, telemetry/metrics.py): every round
    adds, per site, the squared norm of the gradient the site ships (after
    DP and an attack; the sums and the max take finite rounds only, the
    last keeps a NaN), the squared distance of its shared leaves to the
    engine's aggregate, the squared norm of the applied update (0 in a
    round with no live weight), the engine's modeled wire bytes and one to
    ``rounds``, into ``state.telemetry``. In the overlapped mode the metrics
    read the stash's payload and the empty stash's round counts nothing; in
    the buffered mode they read the fresh gradient against the aggregate of
    the buffers. Each sum adds the leaves in JAX's leaf order
    (``telemetry.metrics.tree_sq_sum``), one reduction a leaf over every
    site. The metrics only read: params, optimizer, engine state, health
    and losses are those of the epoch without them, bit for bit. An epoch
    built without ``telemetry`` drops a state's accumulators; one built with
    it fills fresh ones when the state has none, or ones of other keys or
    another site count.

    The process group (``mesh``, a parallel/mesh.py ``SiteMesh``): the
    epoch runs on ``mesh.device`` over the rank's ``[K]`` block (module
    docstring). It takes ``[S, ...]`` inputs, plans and masks (each rank
    keeps its rows) or the rank's ``[K, ...]`` blocks of them
    (parallel/distributed.py ``put_site_batch``); the state's per-site
    leaves are the block's. The robust aggregation, the buffered and
    overlapped rounds, DP, personalized heads, round telemetry and attack
    plans are not run over a group and raise ``NotImplementedError``
    naming ROADMAP A20.

    Slices (a sliced mesh): both pipelines take ``slice_live
    [num_slices, rounds]``, the whole-slice liveness mask (replicated:
    parallel/distributed.py ``put_epoch_plan``). Each round every rank
    multiplies its own slice's gate into the site-level liveness, so a
    dead slice's sites sit the round out exactly as sites a ``live`` mask
    drops (JAX's production rounds). ``min_slices`` is the slice quorum:
    with the mask fed, a round with fewer live slices HOLDS, its engine
    state, health and running statistics reverted, params and optimizer
    unchanged and its loss NaN; ``epoch.held_rounds`` holds the last
    epoch's per-round held flags. The mask is refused on an unsliced
    topology and with another row count than the mesh's slices;
    ``min_slices > 1`` needs a sliced mesh of at least that many slices
    (JAX's ``ValueError``s).

    The other options of the JAX ``make_train_epoch_fn`` are taken by
    name. ``rounds_scan_xs`` and ``donate_state`` govern only how the JAX
    program runs and take any value. Every other option at a value other
    than "off" (the ring LSTM's microbatches) raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    _check_options(options)
    n_slices = 1 if mesh is None else mesh.slices
    sliced = n_slices > 1
    if min_slices < 1:
        raise ValueError(f"min_slices must be >= 1, got {min_slices}")
    if min_slices > 1 and not sliced:
        raise ValueError(f"min_slices={min_slices} needs a sliced mesh (num_slices > 1) — there "
                         "is no slice quorum on a single-slice topology")
    if min_slices > 1 and min_slices > n_slices:
        raise ValueError(f"min_slices={min_slices} exceeds the mesh's {n_slices} slices — every "
                         "round would hold")
    if staleness_bound < 0:
        raise ValueError(f"staleness_bound must be >= 0, got {staleness_bound}")
    if not 0.0 < staleness_decay <= 1.0:
        raise ValueError(f"staleness_decay must be in (0, 1], got {staleness_decay}")
    check_robust_agg(robust_agg)
    if reputation_rounds < 0:
        raise ValueError(f"reputation_rounds must be >= 0, got {reputation_rounds}")
    if pipeline not in ("host", "device"):
        raise ValueError(f"pipeline must be 'host' or 'device', got {pipeline!r}")
    if local_iterations < 1:
        raise ValueError(f"local_iterations must be >= 1, got {local_iterations}")
    buffered, overlap = staleness_bound > 0, bool(overlap_rounds)
    if overlap and buffered:
        raise ValueError(
            "overlap_rounds and staleness_bound > 0 are mutually exclusive: both buffer "
            "per-site updates with their own staleness semantics (one-round pipeline delay vs "
            "decay^age weighting) and composing them would compound the delays")
    if quarantine_rounds is None:
        quarantine_rounds = 3
    if mesh is not None:
        for name, on in (("robust_agg", robust_agg != "none"), ("staleness_bound", buffered),
                         ("overlap_rounds", overlap),
                         ("dp_clip / dp_noise_multiplier", bool(dp_clip or dp_noise_multiplier)),
                         ("personalize", bool(tuple(personalize))), ("telemetry", telemetry),
                         ("attack_plan", attack_plan is not None
                          and attack_plan.injects_attacks())):
            if on:
                raise NotImplementedError(f"{name} over a process group (mesh) is not ported: "
                                          f"ROADMAP {MESH_PLANES_ITEM}")
        device = mesh.device
    dev = resolve_device(device)
    model = task.model
    L = local_iterations
    reputation = robust_agg != "none"
    attacks = attack_plan is not None and attack_plan.injects_attacks()
    # the privacy plane: the head partition and the DP transform, built
    # from the model's leaves (nothing when both are off)
    names = dict(model.named_parameters())
    head = head_leaf_paths(names, personalize)
    dp = None
    if dp_clip or dp_noise_multiplier:
        from ..weights import table_of

        dp = make_dp_fn(dp_clip, dp_noise_multiplier, dp_seed, head, table_of(names))

    # the round metrics: JAX's leaf order of every leaf and of the shipped
    # ones, and the engine's wire bytes a round over the shipped leaves
    order = shared_order = None
    wire_b = 0.0
    if telemetry:
        from ..weights import table_of

        order = jax_leaf_order(list(names), table_of(names))
        shared_order = [k for k in order if k not in head]
        wire_b = payload_bytes_of(engine, {k: names[k] for k in shared_order})

    def round_metrics(ts, payload, agg):
        """The per-site accumulators after one round's payload (JAX's
        ``_ts_round``); the update norm is added after the optimizer."""
        gsq = tree_sq_sum(payload, order, site_axis=True)
        rsq = tree_sq_sum({k: payload[k] - agg[k] for k in shared_order}, shared_order,
                          site_axis=True)
        gsq_f = torch.where(gsq.isfinite(), gsq, 0.0)
        # dcn_bytes stays: one card ships nothing across slices
        return {**ts, "grad_sq_last": gsq,
                "grad_sq_max": torch.maximum(ts["grad_sq_max"], gsq_f),
                "grad_sq_sum": ts["grad_sq_sum"] + gsq_f,
                "payload_bytes": ts["payload_bytes"] + wire_b,
                "residual_sq_sum": ts["residual_sq_sum"] + torch.where(rsq.isfinite(), rsq, 0.0),
                "rounds": ts["rounds"] + 1}

    def update_metrics(ts, updates, go=None):
        """The applied update's squared norm into every site's row; 0 in a
        round whose ``go`` (live weight) is false."""
        usq = tree_sq_sum(updates, order)
        if go is not None:
            usq = torch.where(go, usq, 0.0)
        return {**ts, "update_sq_last": torch.zeros_like(ts["update_sq_last"]) + usq,
                "update_sq_sum": ts["update_sq_sum"] + usq}

    def eng(tree):
        """What the engine aggregates: the shared leaves."""
        return strip_tree(tree, head, keep_head=False) if head else tree

    def aggregate(grads, engine_state, weight, live, params, rnd, axis=None, total=None):
        """The engine on the shared leaves, its aggregate back at full
        structure (zero on the head leaves); over a group with ``axis``,
        where ``total`` is the round's live weight summed over every site."""
        kw = {} if axis is None else {"axis": axis, "total": total}
        agg, es = engine.aggregate(eng(grads), engine_state, weight, live=live, rnd=rnd, **kw)
        return (graft_shared(params, agg, head) if head else agg), es

    def personal_apply(personal, site_grad, alive):
        """Each site's head row, one optimizer step on its own head
        gradient; ``alive [S]`` (None: every site) gates the rows."""
        if personal is None:
            return None
        upd, opt = optimizer.update({k: site_grad[k] for k in head}, personal["opt"])
        new = {"params": {k: v + upd[k] for k, v in personal["params"].items()}, "opt": opt}
        return new if alive is None else _freeze_dead(alive, new, personal)

    def site_round(params, stats, xb, yb, wb, gen, heads=None):
        """Every site's gradient phase of one round: ``L`` micro-batches,
        gradients accumulated weighted by example count, the running
        statistics carried per site from one micro-batch to the next.
        ``heads`` are the sites' own head rows (``[S, ...]``), which take
        the place of the global head leaves."""
        S = xb.shape[0]
        run = {k: v.unsqueeze(0).expand(S, *v.shape) for k, v in stats.items()}
        g_sum, n_sum = None, torch.zeros(S, device=dev)
        loss_sum = torch.zeros(S, device=dev)
        for i in range(L):
            leaves = {k: (heads[k] if heads is not None and k in heads
                          else v.unsqueeze(0).expand(S, *v.shape)).detach().requires_grad_()
                      for k, v in params.items()}
            logits, run = model.site_forward(leaves, xb[:, i], wb[:, i], run, gen)
            loss = cross_entropy(logits, yb[:, i], wb[:, i])
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
            n = wb[:, i].sum(1)
            weighted = {k: g * per_site(n, g) for k, g in zip(leaves, grads)}
            g_sum = weighted if g_sum is None else {k: g_sum[k] + g for k, g in weighted.items()}
            n_sum = n_sum + n
            loss_sum = loss_sum + loss.detach() * n
        site_grad = {k: g / per_site(torch.clamp(n_sum, min=1.0), g) for k, g in g_sum.items()}
        return site_grad, n_sum, run, loss_sum

    def reputation_round(prev, health, flat, agg_flat, contribute):
        """The reputation layer's round (JAX's ``_reputation_round``): the
        z-scores across the live sites of each site's distance to the
        aggregate and of its gradient norm, over the shipped tree (``flat
        [S, N]``, the aggregate ``agg_flat [N]`` laid out alike). A site
        sitting the round out holds its streak and its score."""
        livef = (contribute > 0).float()
        n_live = torch.clamp(livef.sum(), min=1.0)

        def z_of(x):
            xf = torch.where(livef > 0, x, 0.0)
            m1 = xf.sum() / n_live
            m2 = (xf * xf).sum() / n_live
            std = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
            return (x - m1) / torch.clamp(std, min=1e-12)

        d = flat - agg_flat
        dsq, nsq = (d * d).sum(1), (flat * flat).sum(1)
        # a non-finite site's z is NaN, which fails every comparison
        z = torch.maximum(z_of(torch.sqrt(torch.clamp(dsq, min=0.0))),
                          z_of(torch.sqrt(torch.clamp(nsq, min=0.0))))
        live = contribute > 0
        suspect = (z > reputation_z) & live
        streak = torch.where(suspect, prev["suspect_streak"] + 1,
                             torch.where(live, 0, prev["suspect_streak"])).int()
        quarantined = health["quarantined"]
        if reputation_rounds > 0:
            quarantined = torch.maximum(quarantined, (streak >= reputation_rounds).int())
        anomaly = torch.where(live, 0.9 * prev["anomaly"] + 0.1 * torch.clamp(z, min=0.0),
                              prev["anomaly"])
        return {**health, "suspect_streak": streak, "quarantined": quarantined,
                "anomaly": anomaly}, z

    def round_sums(weight, loss_w, axis):
        """The round's weight total and loss sum (``loss_w``, each site's
        contribution) over every site; over a group in one collective,
        before the engine's, which takes the total from here."""
        total, loss = flat_psum([weight.sum(), loss_w.sum()], axis)
        return total, loss

    def sync_stats(weight, total, site_stats, axis):
        """Sync-BN: the statistics of ``site_stats`` each weighted by
        ``weight`` over ``total``; over a group one collective, none for a
        model without running statistics."""
        scale = torch.where(total > 0, weight.float() / torch.clamp(total, min=1e-12),
                            torch.zeros_like(weight.float()))
        stats = {k: (s * per_site(scale, s)).sum(0) for k, s in site_stats.items()}
        return dict(zip(stats, flat_psum(list(stats.values()), axis)))

    def apply_round(health, engine_state, buffers, personal, params, stats, ls, site_grad,
                    n_sum, site_stats, loss_sum, rnd, axis=None):
        """The guarded round's aggregate-and-account half on one payload
        (this round's, or the overlap stash's): liveness, the engine's
        aggregation (over the staleness buffers in the async mode),
        sync-BN, the round loss, the health counters, the reputation layer
        and the personalized heads' step. Returns ``(agg, engine_state,
        health, buffers, personal, stats, loss, total_live, z)``;
        ``total_live`` gates the parameter update."""
        # liveness: scheduled live AND finite AND not quarantined
        flat = site_flat(site_grad)
        finite = flat.isfinite().all(1)
        contribute = ls * finite.float() * (1.0 - (health["quarantined"] > 0).float())
        alive = contribute > 0
        n_eff = n_sum * contribute
        total_fresh, loss_live = round_sums(n_eff, torch.where(alive, loss_sum, 0.0), axis)
        if buffered:
            # arrivals deposit; every slot aggregates at its decayed weight
            buffers = {"grads": {k: torch.where(per_site(alive, g), g, buffers["grads"][k])
                                 for k, g in site_grad.items()},
                       "weight": torch.where(alive, n_sum, buffers["weight"]),
                       "age": torch.where(alive, 0, buffers["age"] + 1).int()}
            stale_w = staleness_weights(buffers["age"], staleness_bound, staleness_decay)
            eff_w = buffers["weight"] * stale_w
            agg, es_new = aggregate(buffers["grads"], engine_state, eff_w, (stale_w > 0).float(),
                                    params, rnd)
            engine_state = _freeze_dead(stale_w > 0, es_new, engine_state)
            total_live = eff_w.sum()
        else:
            # the engine's live weight n_sum·(contribute > 0) is n_eff for a
            # 0/1 contribute mask: its total is total_fresh
            agg, es_new = aggregate(site_grad, engine_state, n_sum, contribute, params, rnd, axis,
                                    total_fresh)
            engine_state = _freeze_dead(alive, es_new, engine_state)
        # a head never leaves its site, so it steps on fresh arrivals only
        personal = personal_apply(personal, site_grad, alive)
        # sync-BN: the example-weighted mean of the arriving sites'
        # statistics (a dead site's may be NaN: where-zeroed), held when
        # nobody arrives
        mean_stats = sync_stats(
            n_eff, total_fresh,
            {k: torch.where(per_site(alive, s), s, 0.0) for k, s in site_stats.items()}, axis)
        if not buffered:
            total_live = total_fresh
        fresh = total_fresh > 0
        stats = {k: torch.where(fresh, v, stats[k]) for k, v in mean_stats.items()}
        loss_round = torch.where(fresh, loss_live / torch.clamp(total_fresh, min=1.0),
                                 float("nan"))
        streak = torch.where(finite, 0, health["streak"] + 1).int()
        quarantined = health["quarantined"]
        if quarantine_rounds > 0:
            quarantined = torch.maximum(quarantined, (streak >= quarantine_rounds).int())
        new_health = {**health, "streak": streak, "skips": health["skips"] + (~alive).int(),
                      "quarantined": quarantined}
        z = None
        if reputation:
            # the scores read the shipped (shared) leaves
            shipped = eng(site_grad)
            agg_flat = torch.cat([agg[k].reshape(-1).float() for k in shipped])
            new_health, z = reputation_round(health, new_health,
                                             site_flat(shipped) if head else flat, agg_flat,
                                             contribute)
            z = torch.where(alive, z, float("nan"))
        return (agg, engine_state, new_health, buffers, personal, stats, loss_round, total_live,
                z)

    def run_rounds(state: TrainState, S: int, rounds: int, batch, live, attack, S_all=None,
                   slice_live=None):
        """The epoch's rounds over ``S`` sites (the rank's block of
        ``S_all`` under a mesh); ``batch(r)`` gives round ``r``'s ``(x [S,
        L, B, ...], y [S, L, B], w [S, L, B])`` on the device."""
        if slice_live is not None and not sliced:
            raise ValueError("a slice_live mask was fed on an unsliced topology — slice faults "
                             "need a (slice, site, model) mesh (TrainConfig.num_slices > 1)")
        if slice_live is not None and slice_live.shape[0] != n_slices:
            raise ValueError(f"slice_live has {slice_live.shape[0]} slice rows but the mesh has "
                             f"{n_slices} slices")
        sl_own = quorum = None
        if slice_live is not None:
            # the replicated mask: this rank's own slice's row, and (quorum
            # on) the live slices a round, with no collective
            sl_full = torch.as_tensor(slice_live, dtype=torch.float32, device=dev)[:, :rounds]
            sl_own = sl_full[mesh.slice_id]
            if min_slices > 1:
                quorum = sl_full.sum(0)
        axis = start = None
        if mesh is not None:
            axis = mesh.axis(S_all)
            start = mesh.block(S_all).start
            if live is not None:
                live = _block_of(live, S_all, mesh.block(S_all))
        if attack is not None and not attacks:
            raise ValueError("an attack mask was fed but no attack_plan was given to "
                             "make_train_epoch_fn (the plan carries the transform's parameters)")
        atk = None
        if attack is not None:
            from ..robustness.attacks import make_attack_fn
            from ..weights import table_of

            attack = np.asarray(attack.cpu() if torch.is_tensor(attack) else attack)[:, :rounds]
            # on the device once an epoch, as the liveness mask: the gate
            # reads each round's column there without a copy
            attack_dev = torch.as_tensor(attack, device=dev)
            atk = make_attack_fn(attack_plan, table_of(state.params))
        guard = (quarantine_rounds >= 0 or live is not None or reputation or atk is not None
                 or buffered or overlap or sl_own is not None)
        if live is not None:
            live = torch.as_tensor(live, dtype=torch.float32, device=dev)[:, :rounds]
        health = _ensure_health(state.health, S, reputation, dev)
        params, stats, opt_state = state.params, state.batch_stats, state.opt_state
        engine_state = state.engine_state
        # the buffers and the stash follow the mode this epoch was built
        # with, as JAX's epoch normalizes them: off drops a carried one,
        # on fills a fresh one (or one for another site count)
        buffers = ((state.buffers if state.buffers is not None
                    and state.buffers["age"].shape[0] == S
                    else default_async_buffers(S, params)) if buffered else None)
        ov = ((state.overlap if state.overlap is not None
               and state.overlap["valid"].shape[0] == S
               else default_overlap_stash(S, params, stats)) if overlap else None)
        # the head rows follow the partition this epoch was built with:
        # off drops carried rows, on fills fresh ones from the current
        # params (or ones for another site count)
        personal = None
        if head:
            carried = state.personal
            ok = carried is not None and next(iter(carried["params"].values())).shape[0] == S
            personal = carried if ok else default_personal(S, params, head, optimizer)
        # the accumulators follow the flag this epoch was built with
        ts = None
        if telemetry:
            ts = state.telemetry
            if ts is None or set(ts) != set(TELEMETRY_KEYS) or ts["rounds"].shape[0] != S:
                ts = default_round_telemetry(S, dev)
        losses, zs, helds = [], [], []
        for r in range(rounds):
            rnd = state.round + r
            gen = torch.Generator(device=dev)
            gen.manual_seed(state.rng * 1_000_003 + rnd)
            if mesh is not None:
                # every site's dropout draw, this block's rows of it
                gen = SiteBlockDraw(gen, S_all, start, S)
            xb, yb, wb = batch(r)
            site_grad, n_sum, site_stats, loss_sum = site_round(
                params, stats, xb, yb, wb, gen, None if personal is None else personal["params"])
            # an honest site privatizes what it ships; a hostile one lies
            # about the privatized quantity
            if dp is not None:
                site_grad = dp(site_grad, rnd)
            if atk is not None:
                site_grad = atk(site_grad, attack[:, r], attack_dev[:, r], rnd)
            if not guard:
                total, loss_all = round_sums(n_sum, loss_sum, axis)
                agg, engine_state = aggregate(site_grad, engine_state, n_sum, None, params, rnd,
                                              axis, total)
                personal = personal_apply(personal, site_grad, None)
                stats = sync_stats(n_sum, total, site_stats, axis)
                loss_round = loss_all / torch.clamp(total, min=1.0)
                updates, opt_state = optimizer.update(agg, opt_state)
                params = {k: v + updates[k] for k, v in params.items()}
                if ts is not None:
                    ts = update_metrics(round_metrics(ts, site_grad, agg), updates)
                losses.append(loss_round)
                continue
            ls = torch.ones(S, device=dev) if live is None else live[:, r]
            if sl_own is not None:
                # a dead slice is its sites dead: x1 is exact, x0 drops them
                ls = ls * sl_own[r]
            held = None
            if quorum is not None:
                # the quorum HOLD: the round runs, then every carried piece
                # reverts below min_slices live slices
                held = quorum[r] < float(min_slices)
                prev = (stats, engine_state, health)
                helds.append(held)
            if overlap:
                # apply the previous round's stash; stash this round's
                # payload for the next round (or the next epoch's first)
                (agg, engine_state, new_health, buffers, personal, stats, loss_round, total_live,
                 z) = apply_round(health, engine_state, buffers, personal, params, stats,
                                  ov["live"] * ov["valid"], ov["grads"], ov["weight"],
                                  ov["stats"], ov["loss"], rnd)
                valid = ov["valid"] > 0
                health = {k: torch.where(valid, v, health[k]) for k, v in new_health.items()}
                if ts is not None:
                    ts = {k: torch.where(valid, v, ts[k])
                          for k, v in round_metrics(ts, ov["grads"], agg).items()}
                ov = {"grads": site_grad, "stats": site_stats, "weight": n_sum,
                      "loss": loss_sum, "live": ls, "valid": torch.ones(S, device=dev)}
            else:
                (agg, engine_state, health, buffers, personal, stats, loss_round, total_live,
                 z) = apply_round(health, engine_state, buffers, personal, params, stats, ls,
                                  site_grad, n_sum, site_stats, loss_sum, rnd, axis)
                if ts is not None:
                    ts = round_metrics(ts, site_grad, agg)
            if z is not None:
                zs.append(z)
            if held is not None:
                stats, engine_state, health = (_hold(~held, new, old)
                                               for new, old in zip((stats, engine_state, health),
                                                                   prev))
                loss_round = torch.where(held, float("nan"), loss_round)
                total_live = torch.where(held, torch.zeros_like(total_live), total_live)
            # one update on the aggregate; a round with no live weight
            # holds params AND optimizer state
            go = total_live > 0
            updates, new_opt = optimizer.update(agg, opt_state)
            params = {k: torch.where(go, v + updates[k], v) for k, v in params.items()}
            opt_state = _hold(go, new_opt, opt_state)
            if ts is not None:
                ts = update_metrics(ts, updates, go)
            losses.append(loss_round)
        new_state = TrainState(params=params, batch_stats=stats, opt_state=opt_state,
                               engine_state=engine_state, rng=state.rng,
                               round=state.round + rounds, health=health, buffers=buffers,
                               overlap=ov, personal=personal, telemetry=ts)
        empty = torch.zeros(0, device=dev)
        reputation_z_trace[:] = [torch.stack(zs)] if zs else []
        held_rounds[:] = [torch.stack(helds)] if helds else []
        return new_state, torch.stack(losses) if losses else empty

    def sites_of(first):
        """``(S_all, take)``: the global site count of an epoch whose first
        per-site input is ``first``, and the function that keeps a per-site
        array's rows of this rank (the identity without a mesh)."""
        if mesh is None:
            return first.shape[0], lambda a: a
        S_all = _global_sites(mesh, first.shape[0])
        block = mesh.block(S_all)
        return S_all, lambda a: None if a is None else _block_of(a, S_all, block)

    def device_epoch(state: TrainState, inv_x, inv_y, idx, live=None, poison=None, attack=None,
                     slice_live=None):
        S_all, take = sites_of(idx)
        inv_x = torch.as_tensor(take(inv_x), device=dev)
        inv_y = torch.as_tensor(take(inv_y), device=dev)
        idx = torch.as_tensor(take(idx), device=dev)
        S, steps = idx.shape[:2]
        rounds = steps // L
        if poison is not None:
            poison = torch.as_tensor(take(poison), device=dev)[:, :rounds]
        return run_rounds(state, S, rounds, lambda r: _gather_batch(
            inv_x, inv_y, idx[:, r * L:(r + 1) * L], None if poison is None else poison[:, r]),
            live, attack, S_all, slice_live)

    def host_epoch(state: TrainState, inputs, labels, weights, live=None, attack=None,
                   slice_live=None):
        S_all, take = sites_of(inputs)
        inputs, labels, weights = take(inputs), take(labels), take(weights)
        S, steps = inputs.shape[:2]

        def batch(r):
            sl = slice(r * L, (r + 1) * L)
            return (_to_device(inputs[:, sl], dev, torch.float32), _to_device(labels[:, sl], dev),
                    _to_device(weights[:, sl], dev, torch.float32))

        return run_rounds(state, S, steps // L, batch, live, attack, S_all, slice_live)

    epoch = device_epoch if pipeline == "device" else host_epoch
    # the last epoch's anomaly z-scores [rounds, S] under the reputation
    # layer (NaN where a site sat out), for a caller that watches how near
    # the threshold its decisions fall
    reputation_z_trace: list = []
    epoch.reputation_z_trace = reputation_z_trace
    # the last epoch's per-round quorum holds [rounds] (bool), with a slice
    # quorum fed; empty otherwise
    held_rounds: list = []
    epoch.held_rounds = held_rounds
    return epoch
