"""The federated training loop: the port's counterpart of the JAX
package's ``trainer/loop.py`` ``FederatedTrainer``, with every site folded
onto one device (JAX's ``mesh=None``) or over a process group (``mesh=``,
a parallel/mesh.py ``SiteMesh``: each rank trains its own block of the
sites, every rank holds the same replicated params, and only rank 0, the
coordinator, writes logs, checkpoints and outputs; a checkpoint holds
every site's state, gathered before the write, so one written by W ranks
loads at any other W and in JAX).

One :class:`FederatedTrainer` drives, per fold:

- the epoch loop: one epoch function call an epoch (trainer/steps.py,
  ``cfg.pipeline`` "device" or "host"), validation every
  ``validation_epochs``, early stopping on ``monitor_metric`` /
  ``metric_direction`` after ``patience`` epochs without improvement, the
  best state kept and saved on improvement, and a rotating latest
  checkpoint every epoch with its bookkeeping (``resume=True`` continues
  from it);
- the final test on the best state, and ``logs.json`` (each site and the
  remote), ``test_metrics.csv``, ``checkpoint_best.msgpack`` and the zipped
  global results, in the JAX package's layout and file format.

Hostile and faulty sites: ``fault_plan`` (``robustness.FaultPlan``:
drops, flaky sites, stragglers, NaN inputs) and ``attack_plan``
(``robustness.AttackPlan``) are windowed on the global round counter of
each epoch, for both pipelines (the host pipeline poisons its dense
inputs, the device pipeline takes the NaN gate); ``cfg.robust_agg`` and
its knobs reach the engine and switch on the reputation layer.

Durable and elastic rounds: the epoch loop runs under a
``PreemptionGuard``, so a SIGTERM or SIGINT during an epoch raises
``Preempted`` after that epoch's rotating checkpoint, and a fault plan's
``kill_at_round`` raises it (exit code 75) after the checkpoint of the
epoch that crosses the round; ``resume=True`` continues bit for bit. The
``cfg.staleness_bound`` / ``staleness_decay`` and ``cfg.overlap_rounds``
modes reach the epoch function. ``membership_mask``, ``fixed_steps`` and
``fixed_inventory_rows`` are the elastic daemon's hooks
(runner/fed_runner.py ``FedDaemon``): an unoccupied slot's liveness is 0
every round, and the plan and the inventory keep their shapes across
churn.

Telemetry (``cfg.telemetry="on"``): the fit runs under the span tracer
(``fit``, ``epoch``, ``eval``, ``plan-build``, ``inventory-upload``,
``checkpoint``, ``test``, ``write-outputs``, ``pretrain``), the epoch keeps
the per-site round metrics (trainer/steps.py, telemetry/metrics.py), and one
sink a fold (telemetry/sink.py) writes ``manifest.json``, ``metrics.jsonl``
(an epoch row an epoch, events, a summary row) and the traces under
``cfg.telemetry_dir`` or ``<out_dir>/telemetry``, ``fold_<k>``; the sink
finalizes on every exit, early stop, ``Preempted`` and errors included.
The gauges and counters go to ``bus`` (``telemetry.global_bus()`` with
telemetry on when none is given); ``results["site_telemetry"]`` and each
``logs.json`` carry the metrics' rollup. The summary row's
``epoch_compiles`` counts the kernel libraries built or loaded during the
fit (``ops/_build.py`` ``BUILDS`` + ``LOADS``): the port has no jit cache
to count. ``cfg.profile_dir`` traces the whole fit, ``cfg.xprof_dir`` the
``cfg.xprof_window`` epochs (telemetry/xprof.py, ``torch.profiler``); they
exclude each other. ``cfg.compile_cache_dir`` moves the kernel libraries'
root (``ops/_build.enable_compile_cache``).

Options the port does not run raise ``NotImplementedError`` naming the
ROADMAP item that ports them, at any value other than "off": the model
axis and the ring LSTM's microbatches (A11 (c)); over a mesh also
telemetry, the robust
aggregation, the buffered and overlapped rounds, DP, secure aggregation,
personalized heads, pretraining and attack plans (A20).

Slices (a sliced ``SiteMesh``, ``cfg.num_slices > 1`` through
``FedRunner``): the fault plan's slice faults (``slice_drop_at``,
``slice_delay_at``; ``kill_slice_at`` only when the mesh spans no other
process, since over processes a kill is a real death) become each
epoch's ``[num_slices, rounds]`` slice-liveness mask, which the epoch
folds into site liveness under the ``cfg.min_slices`` quorum; the bus
counts the modeled inter-slice bytes (``train_dcn_bytes_total``).

The privacy plane: ``cfg.dp_clip`` / ``dp_noise_multiplier`` / ``dp_seed``,
``cfg.secure_agg`` and ``cfg.personalize`` reach the epoch function and
the engine. With noise, the trainer keeps the RDP accountant
(privacy/accounting.py), steps it by every epoch's rounds, reports ε at
``cfg.dp_delta`` (``results["dp_epsilon"]``, each ``logs.json``), carries
it in the rotating checkpoint's meta (a resumed fit continues ε exactly)
and stops cleanly, checkpointed, once ε reaches ``cfg.dp_epsilon_budget``.

Warm starts, skipped when a fit resumes: ``cfg.pretrained_path`` loads a
checkpoint's params, then ``cfg.pretrain`` with ``cfg.pretrain_args`` of
``epochs > 0`` pretrains on the largest training site (:meth:`_pretrain`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..data.api import SiteArrays, stack_site_inventory
from ..data.batching import plan_epoch, plan_epoch_positions, plan_eval
from ..engines import build_engine, make_dsgd
from ..engines.base import MESH_PLANES_ITEM
from ..ops import _build
from ..robustness.attacks import attack_window
from ..robustness.faults import fault_window, poison_inputs, slice_fault_window
from ..robustness.health import health_summary
from ..privacy import RdpAccountant, dp_enabled, effective_noise_multiplier, sampling_fraction
from ..robustness.preemption import PreemptionGuard, Preempted
from ..telemetry.bus import NULL_BUS, global_bus
from ..telemetry.tracer import NULL_TRACER, SpanTracer, duration
from ..weights import params_from_jax
from .checkpoint import load_checkpoint, load_inference_state, load_params, save_checkpoint
from .logs import (
    fold_dir,
    health_log_fields,
    log_info,
    log_warning,
    privacy_log_fields,
    telemetry_log_fields,
    write_logs_json,
    write_test_metrics_csv,
    zip_global_results,
)
from .metrics import Averages, ClassificationMetrics, MulticlassMetrics, is_improvement
from .steps import (
    FederatedTask,
    TrainState,
    gather_site_state,
    init_train_state,
    make_eval_fn,
    make_optimizer,
    make_train_epoch_fn,
    site_state_block,
)


def _refuse(cfg: TrainConfig, mesh) -> None:
    """Raise for the trainer options the port does not run (module
    docstring) and for values no trainer takes, before anything is built."""
    if cfg.telemetry not in ("on", "off"):
        raise ValueError(f"cfg.telemetry must be 'on' or 'off', got {cfg.telemetry!r}")
    if cfg.xprof_dir and cfg.profile_dir:
        raise ValueError("profile_dir (whole-fit trace) and xprof_dir (windowed capture) are "
                         "mutually exclusive: the profiler runs one capture at a time")
    if not 0.0 < cfg.dp_delta < 1.0:
        raise ValueError(f"dp_delta must be in (0, 1), got {cfg.dp_delta}")
    if cfg.dp_epsilon_budget < 0.0:
        raise ValueError(f"dp_epsilon_budget must be >= 0, got {cfg.dp_epsilon_budget}")
    noisy = dp_enabled(cfg.dp_clip, cfg.dp_noise_multiplier) and cfg.dp_noise_multiplier > 0.0
    if cfg.dp_epsilon_budget > 0.0 and not noisy:
        raise ValueError("dp_epsilon_budget needs dp_noise_multiplier > 0 — a noiseless "
                         "mechanism never exhausts any finite ε budget")
    for name, on, item in (("model_axis_size", cfg.model_axis_size != 1, "A11 (c)"),
                           ("sequence_microbatches", cfg.sequence_microbatches != 0, "A11 (c)")):
        if on:
            raise NotImplementedError(f"{name}={getattr(cfg, name)!r} is not ported: ROADMAP "
                                      f"{item}")
    if mesh is None:
        return
    from ..parallel.mesh import SiteMesh

    if not isinstance(mesh, SiteMesh):
        raise TypeError(f"mesh must be a parallel.mesh.SiteMesh or None, got "
                        f"{type(mesh).__name__}")
    # the epoch function refuses its own planes over a group; these two
    # act outside it (the engine's masked wire, the trainer's warm start)
    for name, on in (("secure_agg", cfg.secure_agg != "off"),
                     ("pretrain", bool(cfg.pretrain and cfg.pretrain_args
                                       and cfg.pretrain_args.epochs > 0))):
        if on:
            raise NotImplementedError(f"{name} over a process group (mesh) is not ported: "
                                      f"ROADMAP {MESH_PLANES_ITEM}")


class FederatedTrainer:
    def __init__(self, cfg: TrainConfig, model, mesh=None, out_dir: str | None = None,
                 fault_plan=None, bus=None, attack_plan=None, device=None):
        """``model`` is the task's model (its weights are the fit's first
        state); it moves to ``device``, the card unless the caller asks
        for ``"cpu"``. ``fault_plan`` and ``attack_plan`` are optional
        ``robustness.FaultPlan`` / ``AttackPlan``s; ``bus`` a
        ``telemetry.MetricsBus`` for the fit's gauges and counters;
        ``mesh`` a process group's ``SiteMesh`` (module docstring), whose
        device the fit runs on (``device`` must then be None or the same)."""
        _refuse(cfg, mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device!r} differs from the mesh's rank device "
                                 f"{mesh.device}")
            device = mesh.device
        if cfg.pipeline not in ("device", "host"):
            raise ValueError(f"cfg.pipeline must be 'device' or 'host', got {cfg.pipeline!r}")
        self.cfg = cfg
        self.out_dir = out_dir
        self.mesh = mesh
        self.fault_plan, self.attack_plan = fault_plan, attack_plan
        self.device = resolve_device(device)
        if cfg.compile_cache_dir:
            from ..ops._build import enable_compile_cache

            enable_compile_cache(cfg.compile_cache_dir)
        self._telemetry_on = cfg.telemetry == "on"
        self.tracer = SpanTracer() if self._telemetry_on else NULL_TRACER
        # host-side bookkeeping of values the loop already holds: the bus
        # adds no device sync and changes no epoch
        self.bus = bus if bus is not None else (global_bus() if self._telemetry_on else NULL_BUS)
        self._fit_tel = None  # the fold's artifact sink while a fit runs
        self._fit_summary: dict = {}
        # kernel libraries built plus loaded when the fit started
        # (epoch_compiles), and (built, loaded) by the end of the first
        # epoch of the fit, or of the daemon's life
        self._fit_builds0 = 0
        self._builds0 = None
        self.task = FederatedTask(model.to(self.device))
        self.engine = build_engine(cfg)
        self.optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate)
        self._pipeline = cfg.pipeline
        # the RDP ledger of a noisy mechanism: one for the batch fit and the
        # daemon's epochs alike (run_epoch steps it)
        noisy = dp_enabled(cfg.dp_clip, cfg.dp_noise_multiplier) and cfg.dp_noise_multiplier > 0
        self.dp_accountant = RdpAccountant() if noisy else None
        self._dp_epsilon = None  # the last reported ε (None: DP off or noiseless)
        # the modeled inter-slice bytes a round, for the bus: set once the
        # fit's site count is known (init_state); 0.0 at one slice
        self._dcn_bytes_round = 0.0
        # the port's epoch writes no tensor of the state it is given, so a
        # kept state (the best one) needs no copy: JAX donates the carried
        # state and must snapshot it
        self.epoch_fn = make_train_epoch_fn(
            self.task, self.engine, self.optimizer, cfg.local_iterations,
            cfg.quarantine_rounds, self.device, pipeline=cfg.pipeline,
            rounds_scan_xs=cfg.rounds_scan_xs, donate_state=cfg.donate_epoch_state,
            staleness_bound=cfg.staleness_bound, staleness_decay=cfg.staleness_decay,
            overlap_rounds=cfg.overlap_rounds, attack_plan=attack_plan, robust_agg=cfg.robust_agg,
            reputation_z=cfg.reputation_z, reputation_rounds=cfg.reputation_rounds,
            min_slices=cfg.min_slices, dp_clip=cfg.dp_clip,
            dp_noise_multiplier=cfg.dp_noise_multiplier, dp_seed=cfg.dp_seed,
            personalize=tuple(cfg.personalize), telemetry=self._telemetry_on, mesh=mesh)
        self.eval_fn = make_eval_fn(self.task, self.device, personalize=tuple(cfg.personalize),
                                    mesh=mesh)
        self._inventory = None  # device-resident site inventory, one per fit
        self._inventory_src = None  # the site arrays it was built from
        self._cache: dict = {}  # duration bookkeeping, reference-keyed
        self._last_transfer_bytes = 0  # host→device bytes of the last epoch
        self._num_sites = 1
        # the elastic daemon's hooks (runner/fed_runner.py FedDaemon): the
        # [S] slot occupancy folded into every epoch's liveness (an empty
        # slot never arrives; setting it always feeds a liveness mask), and
        # the pinned plan height and inventory rows, so that churn keeps
        # every shape. None: a batch fit's own.
        self.membership_mask = None
        self.fixed_steps = None
        self.fixed_inventory_rows = None

    # -- building blocks -------------------------------------------------

    def _coordinator(self) -> bool:
        """Whether this process writes the fit's files: always without a
        mesh, rank 0 over one (JAX's ``_coordinator``)."""
        return self.mesh is None or self.mesh.coordinator

    def _save(self, path: str, state, meta: dict, rotate: bool = True) -> None:
        """``save_checkpoint`` of every site's state: over a mesh each rank
        gathers the per-site leaves (a collective: every rank calls this)
        and rank 0 writes."""
        full = gather_site_state(state, self.mesh)
        if self._coordinator():
            save_checkpoint(path, full, meta=meta, rotate=rotate)

    def _load(self, path: str, like, with_meta: bool = False):
        """``load_checkpoint`` of a whole ``[S]`` checkpoint into ``like``
        (this rank's block over a mesh): every rank reads the file."""
        full_like = gather_site_state(like, self.mesh)
        out = load_checkpoint(path, full_like, with_meta=with_meta)
        state, meta = out if with_meta else (out, None)
        state = site_state_block(state, self.mesh)
        return (state, meta) if with_meta else state

    def init_state(self, sample_x=None, num_sites: int | None = None) -> TrainState:
        """The fit's first state from the model's weights; ``sample_x`` is
        taken for the JAX signature (the port's model is built with its
        shapes). Over a mesh its per-site leaves are this rank's block."""
        n = num_sites or self._num_sites
        if self.mesh is not None:
            if self.mesh.slices > 1:
                from ..parallel.mesh import pack_factor
                from ..telemetry.metrics import dcn_bytes_of

                k = pack_factor(self.mesh, n)
                self._dcn_bytes_round = dcn_bytes_of(
                    self.engine, dict(self.task.model.named_parameters()), pack=k,
                    sites_per_slice=k * self.mesh.per_slice, slices=self.mesh.slices)
            n = self.mesh.block(n).stop - self.mesh.block(n).start
        return init_train_state(self.task, self.engine, self.optimizer, rng=self.cfg.seed,
                                num_sites=n, reputation=self.cfg.robust_agg != "none",
                                staleness_bound=self.cfg.staleness_bound,
                                overlap_rounds=self.cfg.overlap_rounds,
                                personalize=tuple(self.cfg.personalize),
                                telemetry=self._telemetry_on)

    def _ensure_inventory(self, train_sites):
        """The device pipeline's resident inventory: copied to the device
        once per fit, keyed by the site arrays it holds."""
        key = tuple((id(s.inputs), id(s.labels), len(s)) for s in train_sites)
        if self._inventory is None or self._inventory_src != key:
            with self.tracer.span("inventory-upload"):
                inv = stack_site_inventory(train_sites, self.fixed_inventory_rows)
                if self.mesh is not None:
                    # each rank keeps its own block of the sites on its device
                    from ..parallel.distributed import put_site_inventory

                    self._inventory = put_site_inventory(self.mesh, inv)
                else:
                    self._inventory = (torch.from_numpy(inv.inputs).to(self.device),
                                       torch.from_numpy(inv.labels).to(self.device))
            self._inventory_src = key
        return self._inventory

    def _build_epoch_payload(self, train_sites, epoch: int, batch_size: int):
        """One epoch's device-pipeline input: the index plan of seed
        ``cfg.seed * 100003 + epoch``, the whole per-epoch host-to-device
        transfer of that pipeline. A pure function of the epoch (JAX builds
        it on a prefetch thread; the port inline)."""
        with self.tracer.span("plan-build", epoch=epoch):
            return plan_epoch_positions(train_sites, batch_size,
                                        seed=self.cfg.seed * 100003 + epoch, pad_mode="wrap",
                                        steps=self.fixed_steps)

    def _plan_masks(self, num_sites: int, round0: int, rounds: int):
        """The fault and attack masks of the global round window ``[round0,
        round0 + rounds)``: ``(live, nan_mask, attack)``, each None when
        its plan injects nothing there (a resumed fit replays the same
        pattern); the membership occupancy folds into ``live``."""
        live, nan_mask = fault_window(self.fault_plan, num_sites, round0, rounds)
        return (self._membership_live(live, num_sites, rounds), nan_mask,
                attack_window(self.attack_plan, num_sites, round0, rounds))

    def _slice_window(self, round0: int, rounds: int):
        """The fault plan's slice-liveness window, JAX's: ``[num_slices,
        rounds]`` or None (one slice, or no slice fault). A kill enters the
        mask only when the mesh spans no other process: over processes it
        is a real death (runner/dcn_worker.py), and a mask would keep a
        restarted slice dead."""
        from ..parallel.distributed import spans_processes
        from ..parallel.mesh import slice_count

        n_sl = slice_count(self.mesh)
        if n_sl <= 1 or self.fault_plan is None:
            return None
        return slice_fault_window(self.fault_plan, n_sl, round0, rounds,
                                  include_kills=not spans_processes(self.mesh))

    def _publish_slice_liveness(self, slice_live) -> None:
        """Each slice's live rounds this epoch as a bus gauge (JAX's
        ``train_slice_live_rounds``), with telemetry on only; round
        telemetry over a process group, where slices run, is ROADMAP
        A20."""
        if slice_live is None or not self._telemetry_on:
            return
        rows = np.asarray(slice_live)
        for sl_i in range(rows.shape[0]):
            self.bus.gauge("train_slice_live_rounds", float(rows[sl_i].sum()), slice=str(sl_i))

    def _membership_live(self, live, num_sites: int, rounds: int):
        """Fold the membership occupancy mask into an epoch's ``[S,
        rounds]`` liveness: an unoccupied slot never arrives. With the mask
        set, a liveness mask is always fed, as JAX's trainer does."""
        if self.membership_mask is None:
            return live
        occ = np.asarray(self.membership_mask, np.float32)[:num_sites, None]
        if live is None:
            return np.broadcast_to(occ, (num_sites, rounds)).copy()
        return live * occ

    def run_epoch(self, state, train_sites, epoch: int, batch_size=None, plan=None):
        """One training epoch. Device pipeline: ``plan`` (built by
        :meth:`_build_epoch_payload` when None) into the resident
        inventory, with the NaN gate of a plan that carries ``nan_at``.
        Host pipeline: the same plan's dense batches, copied a round at a
        time, NaN-poisoned on the host. Both take the window's liveness
        and attack masks. Returns ``(state, losses)`` with the losses in
        numpy; a noisy DP fit's accountant steps by the epoch's rounds."""
        bs = batch_size or self.cfg.batch_size
        L = max(self.cfg.local_iterations, 1)
        if self._pipeline == "device":
            plan = plan if plan is not None else self._build_epoch_payload(train_sites, epoch, bs)
            inv_x, inv_y = self._ensure_inventory(train_sites)
            live, nan_mask, attack = self._plan_masks(plan.num_sites, state.round, plan.steps // L)
            poison = (nan_mask.astype(np.float32)
                      if nan_mask is not None and self.fault_plan.nan_at else None)
            slice_live = self._slice_window(int(state.round), plan.steps // L)
            self._last_transfer_bytes = plan.nbytes + sum(
                a.nbytes for a in (live, poison, attack, slice_live) if a is not None)
            self._publish_slice_liveness(slice_live)
            state, losses = self.epoch_fn(state, inv_x, inv_y, plan.positions, live, poison,
                                          attack, slice_live)
        else:
            fb = plan_epoch(train_sites, bs, seed=self.cfg.seed * 100003 + epoch, pad_mode="wrap",
                            steps=self.fixed_steps)
            live, nan_mask, attack = self._plan_masks(fb.num_sites, state.round, fb.steps // L)
            inputs = (poison_inputs(fb.inputs, nan_mask, L) if nan_mask is not None
                      else fb.inputs)
            slice_live = self._slice_window(int(state.round), fb.steps // L)
            self._last_transfer_bytes = inputs.nbytes + fb.labels.nbytes + fb.weights.nbytes + sum(
                a.nbytes for a in (live, attack, slice_live) if a is not None)
            self._publish_slice_liveness(slice_live)
            state, losses = self.epoch_fn(state, inputs, fb.labels, fb.weights, live, attack,
                                          slice_live)
        losses = losses.cpu().numpy()
        if self._builds0 is None:
            self._builds0 = (_build.BUILDS, _build.LOADS)
        self._account_epoch(train_sites, losses, bs)
        return state, losses

    def _account_epoch(self, train_sites, losses, batch_size: int) -> None:
        """Step the RDP ledger by the epoch's rounds at the cohort's largest
        sampling fraction and at σ/2 (the clip-of-mean sensitivity is 2C,
        ``accounting.MEAN_CLIP_SENSITIVITY_FACTOR``), and note ε."""
        if self.dp_accountant is None:
            return
        q = sampling_fraction(batch_size, self.cfg.local_iterations,
                              [len(s) for s in train_sites])
        self.dp_accountant.step(effective_noise_multiplier(self.cfg.dp_noise_multiplier), q,
                                steps=len(losses))
        self._dp_epsilon = float(self.dp_accountant.epsilon(self.cfg.dp_delta)[0])
        self.bus.gauge("train_epsilon", self._dp_epsilon)

    @staticmethod
    def _new_metrics(num_class: int):
        """Binary: the positive class's probability is the score (AUC on
        prob[:, 1]); multiclass: argmax-based macro metrics."""
        return ClassificationMetrics() if num_class == 2 else MulticlassMetrics()

    @staticmethod
    def _add_probs(m, probs, labels, weights):
        if isinstance(m, ClassificationMetrics):
            m.add(probs[..., 1].reshape(-1), labels.reshape(-1), weights.reshape(-1))
        else:
            m.add(probs.reshape(-1, probs.shape[-1]), labels.reshape(-1), weights.reshape(-1))
        return m

    def _format_val_line(self, avg, metrics, monitor: str) -> str:
        """The per-epoch validation readout, columns by ``cfg.log_header``
        (e.g. ``"Loss|AUC"``); unknown names are skipped."""
        names = [h.strip().lower() for h in (self.cfg.log_header or "").split("|")]
        parts = []
        for nm in names:
            if nm == "loss":
                parts.append(f"val_loss={avg.avg:.4f}")
            elif nm:
                try:
                    parts.append(f"val_{nm}={metrics.value(nm):.4f}")
                except (KeyError, ValueError):
                    pass
        if not parts:
            score = metrics.value(monitor) if monitor != "loss" else avg.avg
            parts = [f"val_loss={avg.avg:.4f}", f"val_{monitor}={score:.4f}"]
        return " ".join(parts)

    def evaluate(self, state, sites, batch_size=None, per_site: bool = False):
        """Pooled metrics over every site's rows; with ``per_site=True`` also
        each site's own ``(Averages, metrics)``. Padding rows (weight 0)
        reach neither."""
        with self.tracer.span("eval"):
            fb = plan_eval(sites, batch_size or self.cfg.batch_size)
            probs, loss_sum, wsum = (t.cpu().numpy() for t in self.eval_fn(
                state, fb.inputs, fb.labels, fb.weights))
        loss = float(loss_sum.sum() / max(wsum.sum(), 1.0))
        m = self._add_probs(self._new_metrics(probs.shape[-1]), probs, fb.labels, fb.weights)
        avg = Averages().add(loss, wsum.sum())
        if not per_site:
            return avg, m
        site_results = []
        for s in range(probs.shape[0]):
            sm = self._add_probs(self._new_metrics(probs.shape[-1]), probs[s], fb.labels[s],
                                 fb.weights[s])
            site_results.append((Averages().add(float(loss_sum[s] / max(wsum[s], 1.0)), wsum[s]),
                                 sm))
        return avg, m, site_results

    # -- the full fit ----------------------------------------------------

    def fit(self, train_sites: list[SiteArrays], val_sites: list[SiteArrays],
            test_sites: list[SiteArrays], fold: int = 0, verbose: bool = True,
            resume: bool = False) -> dict:
        """Train one fold and test its best state (module docstring).
        ``cfg.mode == "test"`` trains nothing: it evaluates the fold's best
        checkpoint (:meth:`test_only`)."""
        if self.cfg.mode.lower() == "test":
            return self.test_only(test_sites, fold=fold)
        verbose = verbose and self._coordinator()
        # the telemetry envelope: the whole fit under one "fit" span, and the
        # fold's sink (opened in _fit_impl) finalizes on every exit
        self._fit_tel, self._fit_summary = None, {}
        self._fit_builds0, self._builds0 = _build.BUILDS + _build.LOADS, None
        try:
            with self.tracer.span("fit", fold=fold):
                return self._fit_impl(train_sites, val_sites, test_sites, fold=fold,
                                      verbose=verbose, resume=resume)
        finally:
            fit_tel = self._fit_tel
            if fit_tel is not None:
                self._fit_summary["epoch_compiles"] = (_build.BUILDS + _build.LOADS
                                                       - self._fit_builds0)
                fit_tel.append(self._fit_summary)
                fit_tel.close()
                self._fit_tel = None

    def compiles_after_first_epoch(self) -> dict:
        """Kernel libraries built and loaded since the end of the first
        epoch of the current (or last) fit, or of the trainer's life when it
        runs epochs without ``fit`` (``ops/_build.py``): the sanitizer's
        compile guard (checks/sanitize.py) holds it at 0."""
        b0, l0 = self._builds0 or (_build.BUILDS, _build.LOADS)
        return {"kernel_builds": _build.BUILDS - b0, "kernel_loads": _build.LOADS - l0}

    def _fit_impl(self, train_sites, val_sites, test_sites, fold: int = 0,
                  verbose: bool = True, resume: bool = False) -> dict:
        cfg = self.cfg
        t_start = time.perf_counter()
        self._num_sites = len(train_sites)
        self._inventory = None
        sizes = [(len(a), len(b), len(c)) for a, b, c in zip(train_sites, val_sites, test_sites)]
        for name, split_sites in (("train", train_sites), ("test", test_sites)):
            if not any(len(s) for s in split_sites):
                raise ValueError(
                    f"the {name} split is empty at every site (site train/val/test sizes: "
                    f"{sizes}; split_ratio={cfg.split_ratio}) — use more subjects per site or "
                    "a split_ratio that gives each split at least one sample somewhere")
        # an empty validation split everywhere is supported (k-fold with
        # k == 2): no selection by validation, the last state is kept
        has_val = any(len(s) for s in val_sites)
        min_site = min((len(s) for s in train_sites if len(s)), default=0)
        if 0 < min_site < cfg.batch_size:
            # drop_last batching would give that site no batch: clamp, in
            # this fold's config only (the caller's is shared by every fold)
            if verbose:
                log_warning(
                    f"[warn] batch_size={cfg.batch_size} exceeds the smallest site's train "
                    f"split ({min_site} samples); clamping batch_size to {min_site} for this "
                    f"fold (drop_last batching would starve that site). Pass a batch_size <= "
                    f"{min_site} to silence this.")
            cfg = cfg.replace(batch_size=min_site)
        if verbose:
            for i, s in enumerate(train_sites):
                if not len(s):
                    log_warning(f"[warn] site {i} has an empty train split (train/val/test "
                                f"sizes: {sizes[i]}) — it will contribute nothing to training "
                                "this fold")
        state = self.init_state()

        latest_path = best_path = None
        if self.out_dir:
            d = fold_dir(self.out_dir, "remote", cfg.task_id, fold)
            latest_path = os.path.join(d, "checkpoint_latest.msgpack")
            best_path = os.path.join(d, "checkpoint_best.msgpack")
        # a kill inside the rotate window leaves only the .prev generation,
        # still a valid resume point
        resuming = bool(resume and latest_path and (
            os.path.exists(latest_path) or os.path.exists(latest_path + ".prev")))
        # the fold's artifact sink: manifest.json, metrics.jsonl, traces
        if self._telemetry_on:
            tel_root = cfg.telemetry_dir or (
                os.path.join(self.out_dir, "telemetry") if self.out_dir else "")
            if tel_root:
                from ..telemetry.sink import FitTelemetry

                self._fit_tel = FitTelemetry.open(
                    os.path.join(tel_root, f"fold_{fold}"), cfg, fold=fold, tracer=self.tracer,
                    fault_plan=self.fault_plan, attack_plan=self.attack_plan,
                    device=self.device)
                self._fit_summary = {"kind": "summary", "fold": fold, "epochs_run": 0,
                                     "best_val_epoch": 0, "best_val_metric": None,
                                     "membership": None}
            elif verbose:
                log_warning("[warn] telemetry='on' but neither out_dir nor telemetry_dir is "
                            "set — spans and device metrics are collected but no artifacts "
                            "will be written")
        if not resuming:
            if cfg.pretrained_path:
                # params only: fresh optimizer and engine state
                state.params = load_params(cfg.pretrained_path, state.params)
            if cfg.pretrain and cfg.pretrain_args and cfg.pretrain_args.epochs > 0:
                state = self._pretrain(state, train_sites, verbose)

        best_metric, best_epoch, best_state = None, 0, state
        since_best, epoch_losses, iter_durations, start_epoch = 0, [], [], 1
        if resuming:
            state, meta = self._load(latest_path, state, with_meta=True)
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_metric = meta.get("best_val_metric")
            best_epoch = int(meta.get("best_val_epoch", 0))
            since_best = int(meta.get("since_best", 0))
            epoch_losses = list(meta.get("epoch_losses", []))
            iter_durations = list(meta.get("iter_durations", []))
            self._cache["time_spent_on_computation"] = list(
                meta.get("time_spent_on_computation", []))
            cum = list(meta.get("cumulative_total_duration", []))
            self._cache["cumulative_total_duration"] = cum
            if cum:  # continue the cumulative wall-clock line from its total
                t_start = time.perf_counter() - cum[-1]
            # the privacy ledger continues exactly: no double count, no reset
            if self.dp_accountant is not None and meta.get("dp_accountant"):
                self.dp_accountant = RdpAccountant.from_json(meta["dp_accountant"])
                self._dp_epsilon = float(self.dp_accountant.epsilon(cfg.dp_delta)[0])
            best_state = (self._load(best_path, state)
                          if os.path.exists(best_path) or os.path.exists(best_path + ".prev")
                          else state)

        monitor, direction = cfg.monitor_metric, cfg.metric_direction
        stop_epoch = cfg.epochs
        # the kill fires once, when training crosses the round: a resumed
        # run starts past it
        kill_round = self.fault_plan.kill_at_round if self.fault_plan is not None else None
        round_before = int(state.round)
        # the device traces: the whole fit (profile_dir) or an epoch window
        # (xprof_dir); a capture that fails fails the fit
        from ..telemetry.xprof import Trace, XprofWindow

        profile = Trace(os.path.join(cfg.profile_dir, f"fold_{fold}")) if cfg.profile_dir else None
        xprof = (XprofWindow(cfg.xprof_dir, cfg.xprof_window, label=f"fold_{fold}")
                 if cfg.xprof_dir else None)
        tel = self._fit_tel
        try:
            with PreemptionGuard() as guard:
                for epoch in range(start_epoch, cfg.epochs + 1):
                    e_start = time.perf_counter()
                    if xprof is not None:
                        xprof.epoch_begin(epoch)
                    with self.tracer.span("epoch", epoch=epoch):
                        state, losses = self.run_epoch(state, train_sites, epoch,
                                                       batch_size=cfg.batch_size)
                    if xprof is not None:
                        xprof.epoch_end(epoch)
                    # rounds with no live weight report NaN: average the others
                    lived = losses[np.isfinite(losses)]
                    epoch_loss = float(lived.mean()) if lived.size else float("nan")
                    epoch_losses.append(epoch_loss)
                    # the reference's per-round durations: the epoch's time
                    # spread over its rounds
                    rounds = max(len(losses), 1)
                    e_seconds = time.perf_counter() - e_start
                    iter_durations.extend([e_seconds / rounds] * rounds)
                    self._publish_epoch(epoch, epoch_loss, rounds, e_seconds, state)
                    if tel is not None:
                        self._epoch_row(fold, epoch, epoch_loss, e_start, state)
                        self._fit_summary["epochs_run"] = len(epoch_losses)
                    if epoch % cfg.validation_epochs == 0:
                        if has_val:
                            val_avg, val_metrics = self.evaluate(state, val_sites,
                                                                 batch_size=cfg.batch_size)
                            score = (val_metrics.value(monitor) if monitor != "loss"
                                     else val_avg.avg)
                            if is_improvement(score, best_metric,
                                              direction if monitor != "loss" else "minimize"):
                                best_metric, best_epoch, best_state = score, epoch, state
                                since_best = 0
                                if best_path:  # save on best
                                    with self.tracer.span("checkpoint"):
                                        self._save(
                                            best_path, best_state,
                                            meta={"best_val_epoch": best_epoch,
                                                  "best_val_metric": best_metric,
                                                  "fold": fold},
                                            rotate=True)
                                    if tel is not None:
                                        tel.event("checkpoint", epoch=epoch, which="best")
                            else:
                                since_best += cfg.validation_epochs
                            if verbose:
                                log_info(f"[fold {fold}] epoch {epoch}: train_loss="
                                         f"{epoch_loss:.4f} "
                                         + self._format_val_line(val_avg, val_metrics, monitor)
                                         + (" *" if best_epoch == epoch else ""))
                        else:
                            # no validation anywhere: the latest state is the
                            # selected one, and nothing stops early
                            best_epoch, best_state = epoch, state
                            if verbose:
                                log_info(f"[fold {fold}] epoch {epoch}: train_loss="
                                         f"{epoch_loss:.4f} (no validation split)")
                        stop = since_best >= cfg.patience
                    else:
                        stop = False
                    # durations before the save: the saved meta covers the
                    # same epochs as its epoch_losses, and the save's IO is
                    # not compute
                    duration(self._cache, e_start, "time_spent_on_computation")
                    duration(self._cache, t_start, "cumulative_total_duration")
                    if latest_path:  # the rotating resume point, every epoch
                        with self.tracer.span("checkpoint"):
                            self._save(
                                latest_path, state, rotate=True,
                                meta={"epoch": epoch, "best_val_epoch": best_epoch,
                                      "best_val_metric": best_metric,
                                      "since_best": since_best, "fold": fold,
                                      "epoch_losses": epoch_losses,
                                      "iter_durations": iter_durations,
                                      "time_spent_on_computation": self._cache.get(
                                          "time_spent_on_computation", []),
                                      "cumulative_total_duration": self._cache.get(
                                          "cumulative_total_duration", []),
                                      "dp_accountant": (self.dp_accountant.to_json()
                                                        if self.dp_accountant is not None
                                                        else None)})
                    # a signal that landed during the epoch, or a crossed
                    # kill round, exits here: after the rotating checkpoint,
                    # so that resume=True continues bit for bit from here
                    saved = latest_path or "(no out_dir)"
                    if guard.requested is not None:
                        if tel is not None:
                            tel.event("preempted", epoch=epoch, signum=int(guard.requested))
                        raise Preempted(f"signal {guard.requested} during epoch {epoch}; "
                                        f"state saved to {saved}", signum=guard.requested,
                                        epoch=epoch)
                    if kill_round is not None:
                        round_after = int(state.round)
                        if round_before <= kill_round < round_after:
                            if tel is not None:
                                tel.event("preempted", epoch=epoch,
                                          kill_at_round=int(kill_round))
                            raise Preempted(f"FaultPlan kill_at_round={kill_round} crossed "
                                            f"during epoch {epoch}; state saved to {saved}",
                                            epoch=epoch)
                        round_before = round_after
                    # an exhausted ε budget stops the fit after the epoch's
                    # rotating checkpoint, and the best state is tested
                    if (cfg.dp_epsilon_budget > 0.0 and self._dp_epsilon is not None
                            and self._dp_epsilon >= cfg.dp_epsilon_budget):
                        if tel is not None:
                            tel.event("dp-budget", epoch=epoch, epsilon=self._dp_epsilon,
                                      budget=cfg.dp_epsilon_budget)
                        if verbose:
                            log_info(f"[fold {fold}] epoch {epoch}: privacy budget exhausted "
                                     f"(ε={self._dp_epsilon:.3f} ≥ {cfg.dp_epsilon_budget}); "
                                     "stopping")
                        stop_epoch = epoch
                        break
                    if stop:
                        stop_epoch = epoch
                        break
        finally:
            if xprof is not None:
                xprof.close()
            if profile is not None:
                profile.stop()

        # below the validation cadence no epoch was validated: validate the
        # trained state once so that it, not the init, is selected
        if best_metric is None and cfg.epochs > 0:
            if has_val:
                val_avg, val_metrics = self.evaluate(state, val_sites, batch_size=cfg.batch_size)
                score = val_metrics.value(monitor) if monitor != "loss" else val_avg.avg
                best_metric, best_epoch, best_state = score, stop_epoch, state
            else:
                best_epoch, best_state = stop_epoch, state

        with self.tracer.span("test"):
            results = self._test_results(best_state, test_sites, best_epoch, best_metric,
                                         stop_epoch, epoch_losses, batch_size=cfg.batch_size)
        # per-site counters and round metrics of the final state (the best
        # may predate a quarantine)
        results["site_health"] = health_summary(gather_site_state(state, self.mesh).health)
        if state.telemetry is not None:
            from ..telemetry.metrics import telemetry_summary

            results["site_telemetry"] = telemetry_summary(state.telemetry)
        if self._dp_epsilon is not None:
            results["dp_epsilon"] = self._dp_epsilon
            results["dp_delta"] = cfg.dp_delta
        if tel is not None:
            self._fit_summary.update(best_val_epoch=int(best_epoch),
                                     best_val_metric=best_metric, dp_epsilon=self._dp_epsilon)
            for key in ("site_skipped_rounds", "site_quarantined"):
                if results.get("site_health"):
                    self._fit_summary[key] = results["site_health"][key]
        if self.out_dir:
            with self.tracer.span("write-outputs"):
                # every rank gathers the best state; rank 0 writes
                full_best = gather_site_state(best_state, self.mesh)
                if self._coordinator():
                    self._write_outputs(results, iter_durations, full_best, fold)
        results["state"] = best_state
        return results

    def _publish_epoch(self, epoch: int, epoch_loss: float, rounds: int, e_seconds: float,
                       state) -> None:
        """The epoch's gauges and counters on the bus, from values on the
        host; with telemetry on also the reputation layer's largest anomaly
        and quarantined sites (two ``[S]`` reads after the epoch's losses
        have synchronized it)."""
        self.bus.gauge("train_epoch", epoch)
        self.bus.gauge("train_loss", epoch_loss)
        self.bus.counter("train_epochs_total")
        self.bus.counter("train_rounds_total", rounds)
        self.bus.observe("epoch_ms", e_seconds * 1e3)
        if self._dcn_bytes_round > 0:
            # the modeled inter-slice bytes this epoch shipped (a static
            # figure a round: no device sync)
            self.bus.counter("train_dcn_bytes_total", self._dcn_bytes_round * rounds)
        if self._telemetry_on and state.health is not None and "anomaly" in state.health:
            self.bus.gauge("train_anomaly_max", float(state.health["anomaly"].max()))
            self.bus.gauge("train_quarantined_sites",
                           int((state.health["quarantined"] > 0).sum()))

    def _epoch_row(self, fold, epoch, epoch_loss, e_start, state) -> None:
        """One metrics.jsonl epoch row: loss, time, transfer, ε and the
        per-site accumulators (a few ``[S]`` reads after the epoch's losses
        have synchronized it)."""
        row = {"kind": "epoch", "fold": fold, "epoch": epoch, "train_loss": epoch_loss,
               "epoch_seconds": round(time.perf_counter() - e_start, 6),
               "transfer_bytes": self._last_transfer_bytes, "dp_epsilon": self._dp_epsilon}
        if state.telemetry is not None:
            t = {k: v.cpu().numpy() for k, v in state.telemetry.items()}
            row.update(
                site_grad_sq_last=[float(v) for v in t["grad_sq_last"]],
                site_grad_sq_sum=[float(v) for v in t["grad_sq_sum"]],
                site_grad_sq_max=[float(v) for v in t["grad_sq_max"]],
                site_residual_sq_sum=[float(v) for v in t["residual_sq_sum"]],
                update_sq_last=float(t["update_sq_last"][0]),
                payload_bytes=float(t["payload_bytes"][0]),
                dcn_bytes=float(t["dcn_bytes"][0]), rounds=int(t["rounds"][0]),
                held_rounds=int(t["held_rounds"][0]))
        else:  # one schema for every epoch row
            row.update(site_grad_sq_last=[], site_grad_sq_sum=[], site_grad_sq_max=[],
                       site_residual_sq_sum=[], update_sq_last=0.0, payload_bytes=0.0,
                       dcn_bytes=0.0, rounds=0, held_rounds=0)
        self._fit_tel.append(row)

    def _pretrain(self, state: TrainState, train_sites, verbose: bool) -> TrainState:
        """The warm start of ``cfg.pretrain``: ``pretrain_args.epochs``
        epochs on the largest training site by rows, every other site cut
        to zero rows (its weight is 0 in the aggregate and the BatchNorm
        statistics), through a dSGD engine whatever ``agg_engine`` says, a
        fresh optimizer at ``pretrain_args.learning_rate`` and
        ``pretrain_args.local_iterations``, on the host pipeline. Returns
        the warm params and running statistics with the fit's optimizer
        fresh, the fit's engine state and health kept and the round
        counter carried on."""
        cfg, pa = self.cfg, self.cfg.pretrain_args
        largest = int(np.argmax([len(s) for s in train_sites]))
        masked = [s if i == largest else SiteArrays(s.inputs[:0], s.labels[:0], s.indices[:0])
                  for i, s in enumerate(train_sites)]
        pre_opt = make_optimizer(cfg.optimizer, pa.learning_rate)
        pre_engine = make_dsgd(cfg.precision_bits)
        pre_epoch_fn = make_train_epoch_fn(self.task, pre_engine, pre_opt, pa.local_iterations,
                                           device=self.device, pipeline="host")
        pre = TrainState(params=state.params, batch_stats=state.batch_stats,
                         opt_state=pre_opt.init(state.params), engine_state={}, rng=state.rng,
                         round=state.round, health=state.health)
        with self.tracer.span("pretrain"):
            for epoch in range(1, pa.epochs + 1):
                fb = plan_epoch(masked, pa.batch_size, seed=cfg.seed * 7 + epoch,
                                pad_mode="mask")
                pre, losses = pre_epoch_fn(pre, fb.inputs, fb.labels, fb.weights)
                if verbose:
                    log_info(f"[pretrain site {largest}] epoch {epoch}: "
                             f"loss={losses.cpu().numpy().mean():.4f}")
        # the pretraining epochs run without round metrics: the fit's own
        # accumulators carry on untouched
        return TrainState(params=pre.params, batch_stats=pre.batch_stats,
                          opt_state=self.optimizer.init(pre.params),
                          engine_state=state.engine_state, rng=state.rng, round=pre.round,
                          health=state.health, buffers=state.buffers, overlap=state.overlap,
                          personal=state.personal, telemetry=state.telemetry)

    def test_only(self, test_sites: list[SiteArrays], fold: int = 0) -> dict:
        """``mode="test"``: evaluate the fold's best checkpoint, which
        reproduces the stored test metrics without training."""
        cfg = self.cfg
        if not self.out_dir:
            raise ValueError('mode="test" needs out_dir (to find the checkpoint)')
        d = fold_dir(self.out_dir, "remote", cfg.task_id, fold)
        ckpt = os.path.join(d, "checkpoint_best.msgpack")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f'mode="test" but no trained checkpoint at {ckpt}')
        self._num_sites = len(test_sites)
        state = self.init_state()
        # params and running statistics only: a full restore would tie the
        # test to the training run's site count through the engine state
        params, stats, meta = load_inference_state(ckpt)
        sd = params_from_jax(cfg, params, stats)
        state.params = {k: sd[k].to(self.device) for k in state.params}
        state.batch_stats = {k: sd[k].to(self.device) for k in state.batch_stats}
        # no head rows in a params-only restore: a personalized build
        # evaluates the global heads, as JAX's does
        state.personal = None
        results = self._test_results(state, test_sites, int(meta.get("best_val_epoch", 0)),
                                     meta.get("best_val_metric"), stop_epoch=0, epoch_losses=[])
        results["state"] = state
        return results

    def _test_results(self, state, test_sites, best_epoch, best_metric, stop_epoch,
                      epoch_losses, batch_size=None) -> dict:
        monitor = self.cfg.monitor_metric
        test_avg, test_metrics, site_results = self.evaluate(
            state, test_sites, batch_size=batch_size, per_site=True)
        monitored = test_metrics.value(monitor) if monitor != "loss" else test_avg.avg
        return {
            "agg_engine": self.cfg.agg_engine,
            "best_val_epoch": best_epoch,
            "best_val_metric": best_metric,
            "stopped_epoch": stop_epoch,
            "test_metrics": [[round(test_avg.avg, 5), round(monitored, 5)]],
            "test_scores": {n: test_metrics.value(n)
                            for n in ("accuracy", "f1", "precision", "recall", "auc")},
            "site_test_metrics": [
                [[round(a.avg, 5), round(m.value(monitor) if monitor != "loss" else a.avg, 5)]]
                for a, m in site_results],
            "epoch_losses": epoch_losses,
        }

    def _write_outputs(self, results, iter_durations, best_state, fold):
        cfg = self.cfg
        comp = self._cache.get("time_spent_on_computation", [])
        cum = self._cache.get("cumulative_total_duration", [])
        site_tm = results.get("site_test_metrics") or []
        for i in range(self._num_sites):
            d = fold_dir(self.out_dir, f"local{i}", cfg.task_id, fold)
            # each site's log carries its own test metrics; the durations
            # are shared, since every site runs in the one program
            write_logs_json(
                d, cfg.agg_engine, site_tm[i] if i < len(site_tm) else results["test_metrics"],
                results["best_val_epoch"], cum, comp, iter_durations, side="local",
                extra={"site_index": i, "pooled_test_metrics": results["test_metrics"],
                       "durations_shared_across_sites": True,
                       **health_log_fields(results.get("site_health"), i),
                       **telemetry_log_fields(results.get("site_telemetry"), i),
                       **privacy_log_fields(results)})
        d = fold_dir(self.out_dir, "remote", cfg.task_id, fold)
        write_logs_json(d, cfg.agg_engine, results["test_metrics"], results["best_val_epoch"],
                        cum, comp, iter_durations, side="remote",
                        extra={**health_log_fields(results.get("site_health")),
                               **telemetry_log_fields(results.get("site_telemetry")),
                               **privacy_log_fields(results)})
        write_test_metrics_csv(d, fold, results["test_scores"])
        save_checkpoint(os.path.join(d, "checkpoint_best.msgpack"), best_state,
                        meta={"best_val_epoch": results["best_val_epoch"],
                              "best_val_metric": results["best_val_metric"], "fold": fold})
        zip_global_results(self.out_dir, num_sites=self._num_sites, task_id=cfg.task_id)
