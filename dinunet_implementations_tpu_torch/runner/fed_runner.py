"""The runners over a dataset tree: the port's counterpart of the JAX
package's ``runner/fed_runner.py``.

- :class:`FedRunner`, the COINSTAC simulator's replacement, finds the
  ``input/local*/simulatorRun`` site directories, resolves each site's
  config from the tree's ``inputspec.json``, reads and splits each site,
  and fits every fold with all sites on one device.
- :class:`SiteRunner`, the reference's one-site harness
  (``comps/*/site_run.py``), fits one site of the tree alone, a federation
  of one, fold by fold.

- :class:`FedDaemon`, the long-running service form (elastic rounds): a
  loop over one fixed ``[capacity]`` slot axis that takes site joins,
  leaves and rejoins from a spool directory of JSON events
  (``robustness.MembershipTable``), holds rounds below a quorum,
  checkpoints with the membership table in the meta and announces each
  checkpoint in ``publish.json`` for the serving plane's
  ``CheckpointWatcher``; with ``TrainConfig.staleness_bound > 0`` it
  aggregates buffered-async, so stragglers fade instead of stalling. Its
  epochs step the trainer's privacy accountant, and an exhausted
  ``dp_epsilon_budget`` checkpoints and stops the service (counted in
  ``serve_dp_budget_stops_total``).

Every runner takes the privacy plane's config fields (DP-SGD, secure
aggregation, personalized heads); a personalized fit's per-site scores
(each site on its own head) land in each ``local{i}/logs.json``.

``FedRunner`` and ``SiteRunner`` wrap each fold in the sanitizer
(checks/sanitize.py ``sanitized_fit``, on under ``DINUNET_SANITIZE``), and
their fits take the telemetry options of the config (``telemetry``,
``telemetry_dir``, ``profile_dir``, ``xprof_dir``, ``compile_cache_dir``).
The daemon keeps a flight recorder (telemetry/flight.py) over its
trainer's tracer, which it dumps when a signal stops it, and with telemetry
on writes its epochs and membership events under
``<out_dir>/telemetry/serve``; :meth:`FedDaemon.health_probes` and
:meth:`FedDaemon.status` are what the ``/healthz`` and ``/statusz``
exporter serves (runner/cli.py ``--statusz-port``).
"""

from __future__ import annotations

import glob
import json
import os
import re
import time

import numpy as np

from ..core.config import TrainConfig, resolve_site_configs
from ..core.device import resolve_device
from ..data.api import SiteArrays, build_site_dataset
from ..data.splits import resolve_splits
from ..ops import _build
from ..trainer.loop import FederatedTrainer
from .registry import build_model, get_task, task_cache


def _site_dir_key(path: str):
    """Numeric-then-lexicographic sort key of a ``local*`` site directory:
    the number comes from the ``local*`` segment only, a segment without
    digits sorts first, and the full path breaks ties."""
    segment = os.path.basename(os.path.dirname(path))
    m = re.search(r"([0-9]+)", segment)
    return (int(m.group(1)) if m else -1, path)


def discover_site_dirs(dataset_dir: str) -> list[str]:
    """The reference fixture's layout, ``<dataset_dir>/input/local{i}/
    simulatorRun``; ``dataset_dir`` itself is the one site when there are
    no ``local*`` directories."""
    pattern = os.path.join(dataset_dir, "input", "local*", "simulatorRun")
    return sorted(glob.glob(pattern), key=_site_dir_key) or [dataset_dir]


def load_site_splits(cfg: TrainConfig, site_dirs: list[str],
                     site_cfgs: list[TrainConfig] | None = None) -> list[dict]:
    """Each site's arrays split into folds: a list (one entry a fold) of
    ``{"train", "validation", "test"}`` lists of ``SiteArrays``, one a
    site. Site ``i`` splits with seed ``site_cfg.seed + i``; the fold count
    is the smallest of any site's."""
    site_cfgs = site_cfgs or [cfg] * len(site_dirs)
    spec = get_task(cfg.task_id)
    site_arrays, site_splits = [], []
    for i, (d, scfg) in enumerate(zip(site_dirs, site_cfgs)):
        ds = build_site_dataset(spec.dataset_cls, spec.handle_cls, task_cache(scfg),
                                {"baseDirectory": d}, mode=scfg.mode)
        arrs = ds.as_arrays()
        site_arrays.append(arrs)
        args = scfg.task_args()
        site_splits.append(resolve_splits(
            len(arrs), split_ratio=scfg.split_ratio, num_folds=scfg.num_folds,
            split_files=tuple(getattr(args, "split_files", ()) or ()), base_dir=d,
            seed=scfg.seed + i))
    folds = []
    for k in range(min(len(s) for s in site_splits)):
        fold = {"train": [], "validation": [], "test": []}
        for arrs, splits in zip(site_arrays, site_splits):
            for key in fold:
                fold[key].append(arrs.take(splits[k][key]))
        folds.append(fold)
    return folds


class FedRunner:
    """Federated training over a reference-style dataset tree, on
    ``device`` (the card unless the caller asks for ``"cpu"``).
    ``overrides`` are config fields (``epochs=3``, ``pipeline="host"``, …)
    applied before the tree's inputspec. ``mesh="auto"`` resolves to one
    device; any other mesh is multi-GPU (ROADMAP A11) and raises. ``bus``
    (a ``telemetry.MetricsBus``) takes every fold's gauges and counters."""

    def __init__(self, cfg: TrainConfig | None = None, data_path: str = ".",
                 out_dir: str | None = None, mesh="auto", fault_plan=None, attack_plan=None,
                 device=None, bus=None, **overrides):
        if mesh not in ("auto", None):
            raise NotImplementedError("FedRunner(mesh=...) is not ported: ROADMAP A11 "
                                      "(multi-GPU); the port runs every site on one device")
        cfg = (cfg or TrainConfig()).with_overrides(overrides)
        self.data_path = data_path
        self.fault_plan, self.attack_plan = fault_plan, attack_plan
        self.site_dirs = discover_site_dirs(data_path)
        self.site_cfgs = resolve_site_configs(cfg, data_path, num_sites=len(self.site_dirs))
        # owner-scoped fields come from site 0 (one owner config; the
        # per-site inputspecs override member fields)
        self.cfg = self.site_cfgs[0].replace(num_sites=len(self.site_dirs))
        self.out_dir = out_dir or os.path.join(data_path, "output")
        self.mesh = None
        self.bus = bus
        self.device = resolve_device(device)

    def run(self, folds=None, verbose: bool = True, resume: bool = False) -> list[dict]:
        """Fit every fold (or those listed in ``folds``); ``resume=True``
        continues each from its last checkpoint; ``cfg.mode == "test"``
        evaluates each fold's best checkpoint instead of training."""
        all_folds = load_site_splits(self.cfg, self.site_dirs, self.site_cfgs)
        fold_ids = list(range(len(all_folds)))
        if folds is not None:
            all_folds = [all_folds[k] for k in folds]
            fold_ids = list(folds)
        from ..checks.sanitize import sanitized_fit

        results = []
        for k, fold in zip(fold_ids, all_folds):
            trainer = FederatedTrainer(
                self.cfg, build_model(self.cfg, device=self.device), self.mesh,
                out_dir=self.out_dir, fault_plan=self.fault_plan, attack_plan=self.attack_plan,
                bus=self.bus, device=self.device)
            # DINUNET_SANITIZE: the compile guard (no kernel library built or
            # loaded after the first epoch) and the anomaly mode around the
            # fold; nothing when off
            with sanitized_fit(trainer, label=f"{self.cfg.agg_engine}/fold{k}") as report:
                res = trainer.fit(fold["train"], fold["validation"], fold["test"], fold=k,
                                  verbose=verbose, resume=resume)
                if report is not None:
                    report.note_result(res)
            results.append(res)
        return results


#: the reference's short task names (its ``taks_id`` kwarg)
_SHORT_TASK_IDS = {"FSL": "FS-Classification", "ICA": "ICA-Classification"}


class SiteRunner:
    """One site of a dataset tree fitted alone, on ``device`` (the card
    unless the caller asks for ``"cpu"``). ``taks_id`` is the reference's
    kwarg, spelled as it spells it, and takes its short names ("FSL",
    "ICA") or a task id; ``task_id`` wins when both are given.
    ``site_index`` is clamped to the sites present. ``bus`` takes the fits'
    gauges and counters. Other keyword arguments are config overrides,
    applied before the tree's inputspec."""

    def __init__(self, taks_id: str | None = None, task_id: str | None = None,
                 data_path: str = ".", mode: str = "train", seed: int = 0, site_index: int = 0,
                 split_ratio=(0.8, 0.1, 0.1), monitor_metric: str = "auc",
                 metric_direction: str = "maximize", log_header: str = "Loss|AUC",
                 batch_size: int = 16, out_dir: str | None = None, device=None, bus=None,
                 **kw):
        tid = task_id or _SHORT_TASK_IDS.get(taks_id, taks_id)
        self.site_index = site_index
        self.cfg = TrainConfig(task_id=tid, mode=mode, seed=seed, split_ratio=tuple(split_ratio),
                               monitor_metric=monitor_metric, metric_direction=metric_direction,
                               log_header=log_header, batch_size=batch_size).with_overrides(kw)
        self.data_path = data_path
        self.out_dir = out_dir
        self.bus = bus
        self.device = resolve_device(device)

    def run(self, trainer_cls=None, dataset_cls=None, handle_cls=None,
            verbose: bool = True) -> list[dict]:
        """Fit every fold of the site's own split (seed ``cfg.seed``), each
        with ``mesh=None``. The reference's positional (trainer, dataset,
        handle) are taken; the registry supplies the defaults and the
        trainer is always :class:`FederatedTrainer`."""
        site_dirs = discover_site_dirs(self.data_path)
        site_cfgs = resolve_site_configs(self.cfg, self.data_path, num_sites=len(site_dirs))
        ix = min(self.site_index, len(site_dirs) - 1)
        cfg = site_cfgs[ix]
        spec = get_task(cfg.task_id)
        ds = build_site_dataset(dataset_cls or spec.dataset_cls, handle_cls or spec.handle_cls,
                                task_cache(cfg), {"baseDirectory": site_dirs[ix]}, mode=cfg.mode)
        arrs = ds.as_arrays()
        args = cfg.task_args()
        splits = resolve_splits(
            len(arrs), split_ratio=cfg.split_ratio, num_folds=cfg.num_folds,
            split_files=tuple(getattr(args, "split_files", ()) or ()), base_dir=site_dirs[ix],
            seed=cfg.seed)
        from ..checks.sanitize import sanitized_fit

        results = []
        for k, split in enumerate(splits):
            trainer = FederatedTrainer(cfg, build_model(cfg, device=self.device), mesh=None,
                                       out_dir=self.out_dir, bus=self.bus, device=self.device)
            with sanitized_fit(trainer, label=f"{cfg.agg_engine}/site{ix}/fold{k}") as report:
                res = trainer.fit([arrs.take(split["train"])], [arrs.take(split["validation"])],
                                  [arrs.take(split["test"])], fold=k, verbose=verbose)
                if report is not None:
                    report.note_result(res)
            results.append(res)
        return results


#: spool event files are JSON objects with an "event" key:
#:   {"event": "join", "site": "<id>", "data_dir": "<path>"}
#:   {"event": "leave", "site": "<id>"}
#:   {"event": "shutdown"}
#: plus an optional "after_epoch": N, which holds the event in the spool
#: until the daemon has trained N epochs (churn on a schedule). Files are
#: taken in sorted-filename order and removed once applied.
SPOOL_EVENTS = ("join", "leave", "shutdown")


class FedDaemon:
    """Daemon-mode federated training, the JAX package's ``FedDaemon`` on
    one device (the card unless the caller asks for ``"cpu"``).

    The slot axis is pinned at ``capacity`` for the life of the service and
    sites float over it through a ``MembershipTable``. Events arrive as
    JSON files in ``spool_dir`` (:data:`SPOOL_EVENTS`); a join loads the
    site's data under a deadline (``robustness.with_retry``), so a
    half-written directory is rejected instead of wedging the service.
    Every shape (the ``[capacity, rows, ...]`` inventory, the ``[capacity,
    steps, B]`` plan, the liveness mask) is pinned at the first admission,
    so churn builds and loads no kernel library after the first epoch
    (:meth:`compiles_after_first_epoch`) and launches the same kernels
    every epoch. Below ``quorum`` occupied slots the service holds.
    Checkpoints rotate every epoch and every membership change, with the
    table, each member's data directory and config overrides in the meta,
    so ``resume=True`` restores the slot map and re-admits the members'
    data; each rotation drops ``publish.json`` beside the checkpoint.

    The daemon and its trainer publish their gauges and counters to
    ``bus``, the process's ``telemetry.global_bus()`` unless one is
    passed. ``flight`` is the flight recorder (a ``FlightRecorder`` over
    ``out_dir`` and the trainer's tracer unless one is passed): the daemon
    notes joins, leaves, epochs, holds and checkpoints there, and dumps it
    when a signal stops the service. With ``cfg.telemetry == "on"`` the
    trainer's spans, an epoch row an epoch, the membership events and a
    summary row go to a ``FitTelemetry`` under ``<telemetry_dir or
    out_dir/telemetry>/serve``, its manifest tagged with ``sink_tags``. A
    mesh is multi-GPU (ROADMAP A11); the scheduler's ``set_slice_grant``
    and ``reload_checkpoint`` are A19."""

    def __init__(self, cfg: TrainConfig | None = None, capacity: int = 8,
                 spool_dir: str | None = None, out_dir: str | None = None,
                 data_path: str | None = None, quorum: int = 1, poll_s: float = 0.5,
                 mesh="auto", fault_plan=None, attack_plan=None,
                 admission_deadline_s: float = 10.0, inventory_rows: int | None = None,
                 steps: int | None = None, resume: bool = False, verbose: bool = True,
                 bus=None, flight=None, sink_tags: dict | None = None, device=None,
                 **overrides):
        from ..robustness.membership import MembershipTable
        from ..telemetry.bus import global_bus
        from ..telemetry.flight import FlightRecorder

        if mesh not in ("auto", None):
            raise NotImplementedError("FedDaemon(mesh=...) is not ported: ROADMAP A11 "
                                      "(multi-GPU); the port runs every slot on one device")
        cfg = (cfg or TrainConfig()).with_overrides(overrides)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 1 <= quorum <= capacity:
            raise ValueError(f"quorum must be in [1, capacity={capacity}], got {quorum}")
        self.cfg = cfg.replace(num_sites=capacity)
        self.capacity, self.quorum, self.poll_s = capacity, quorum, poll_s
        self.fault_plan, self.attack_plan = fault_plan, attack_plan
        self.admission_deadline_s = admission_deadline_s
        self.verbose = verbose
        self.spool_dir = spool_dir or (os.path.join(data_path, "spool") if data_path else "spool")
        self.out_dir = out_dir or (os.path.join(data_path, "output") if data_path else "output")
        os.makedirs(self.spool_dir, exist_ok=True)
        # the daemon always publishes into a bus (the process's unless one
        # is passed), and so does its trainer: host-side bookkeeping that
        # the /statusz exporter reads
        self.bus = bus if bus is not None else global_bus()
        self.device = resolve_device(device)
        self.num_slices = 1
        self.trainer = FederatedTrainer(self.cfg, build_model(self.cfg, device=self.device),
                                        None, out_dir=self.out_dir, fault_plan=fault_plan,
                                        bus=self.bus, attack_plan=attack_plan,
                                        device=self.device)
        # the ring a crash or a signal dumps, kept with telemetry off too
        self.flight = flight if flight is not None else FlightRecorder(
            self.out_dir, bus=self.bus, tracer=self.trainer.tracer)
        self.table = MembershipTable(capacity)
        self.state = None  # built at the first admission (it needs the shapes)
        self.epochs_run = 0
        self.held_rounds = 0
        self._stop = False
        self._preempted = False
        self._idle = False  # the hold latch of the serve loop and the ingest release
        self._pending_ckpt_load = False
        self._data: dict = {}  # site id -> SiteArrays
        self._dirs: dict = {}  # site id -> data dir, for re-admission on resume
        self._overrides: dict = {}  # site id -> its flat config overrides
        self._traces: dict = {}  # site id -> the trace id of its join event
        # one zero-row placeholder for every free slot: the trainer keys
        # its resident inventory by the arrays' identities
        self._empty_site = None
        self._feat = None  # the feature shape, fixed at the first admission
        self._rows = inventory_rows  # the pinned inventory height
        self._steps = steps  # the pinned plan height
        self._compiles0 = None  # kernel libraries built plus loaded when the state was built
        self.ckpt_path = os.path.join(self.out_dir, "serve", "checkpoint_latest.msgpack")
        self._sink = None
        if self.cfg.telemetry == "on":
            from ..telemetry.sink import FitTelemetry

            self._sink = FitTelemetry.open(
                os.path.join(self.cfg.telemetry_dir or os.path.join(self.out_dir, "telemetry"),
                             "serve"),
                self.cfg, fold=0, tracer=self.trainer.tracer, fault_plan=fault_plan,
                attack_plan=attack_plan, tags=sink_tags, device=self.device)
        resumed = self._resume() if resume else False
        if not resumed and data_path:
            # pre-join the tree's local* sites with their inputspec entries,
            # so that a tree starts training at once and the spool carries
            # only the churn
            from ..core.config import load_inputspec

            spec_path = os.path.join(data_path, "inputspec.json")
            per_site = load_inputspec(spec_path) if os.path.exists(spec_path) else [{}]
            for i, d in enumerate(discover_site_dirs(data_path)):
                self.apply_event({"event": "join", "site": f"local{i}", "data_dir": d,
                                  "config": per_site[i % len(per_site)]})
            if self.table.occupied:
                self._on_membership_change()

    def _log(self, msg: str) -> None:
        if self.verbose:
            from ..trainer.logs import log_info

            log_info(msg)

    def _event(self, name: str, **attrs) -> None:
        """An instant event in the telemetry's trace and metrics.jsonl
        (nothing with telemetry off)."""
        if self._sink is not None:
            self._sink.event(name, **attrs)

    # -- admission ---------------------------------------------------------

    def _load_site(self, data_dir: str, overrides: dict | None = None):
        """One joining site's arrays, loaded under the admission deadline
        (tries and each try bounded), with its own config overrides."""
        from ..robustness.retry import with_retry

        scfg = self.cfg.with_overrides(overrides or {})
        spec = get_task(scfg.task_id)

        def load():
            return build_site_dataset(spec.dataset_cls, spec.handle_cls, task_cache(scfg),
                                      {"baseDirectory": data_dir}, mode=scfg.mode).as_arrays()

        return with_retry(load, attempts=3, base_delay=0.2,
                          retry_on=(OSError, ValueError, KeyError, RuntimeError),
                          deadline_s=self.admission_deadline_s,
                          timeout_s=self.admission_deadline_s,
                          describe=f"site admission {data_dir}")()

    def _admit(self, site: str, data_dir: str, overrides: dict | None = None):
        """A joining site's ``SiteArrays`` after the shape gate, or None
        (rejected, with the reason logged)."""
        from ..trainer.logs import log_warning

        try:
            arrays = self._load_site(data_dir, overrides)
        except (OSError, ValueError, KeyError, RuntimeError, TimeoutError) as e:
            log_warning(f"[serve] join rejected for {site!r}: admission failed within "
                        f"deadline_s={self.admission_deadline_s} ({e})")
            self._event("join-rejected", site=site, reason=str(e))
            return None
        if not len(arrays):
            log_warning(f"[serve] join rejected for {site!r}: empty dataset")
            self._event("join-rejected", site=site, reason="empty dataset")
            return None
        feat = arrays.inputs.shape[1:]
        if self._feat is None:
            self._feat = feat
        elif feat != self._feat:
            log_warning(f"[serve] join rejected for {site!r}: feature shape {feat} != the "
                        f"service's {self._feat}")
            self._event("join-rejected", site=site, reason="shape mismatch")
            return None
        if self._rows is None:
            # the inventory height, pinned at the first site's size (headroom
            # is the operator's inventory_rows)
            self._rows = max(len(arrays), self.cfg.batch_size)
        if len(arrays) > self._rows:
            log_warning(f"[serve] site {site!r} has {len(arrays)} samples; the service's "
                        f"inventory grid is pinned at {self._rows} rows — truncating (start the "
                        "daemon with a larger inventory_rows for headroom)")
            arrays = arrays.take(np.arange(self._rows))
        if len(arrays) < self.cfg.batch_size:
            log_warning(f"[serve] site {site!r} has {len(arrays)} samples < batch_size="
                        f"{self.cfg.batch_size}: with drop_last batching it will yield no "
                        "batches and contribute nothing")
        return arrays

    # -- membership --------------------------------------------------------

    def apply_event(self, ev: dict) -> bool:
        """Apply one spool event; True when membership changed. An invalid
        event is logged and skipped."""
        from ..robustness.membership import MembershipError
        from ..trainer.logs import log_warning

        kind = ev.get("event")
        if kind == "shutdown":
            self._stop = True
            self._log("[serve] shutdown event received")
            return False
        trace_id = str(ev.get("trace_id") or "") or None
        try:
            if kind == "join":
                site = str(ev["site"])
                data_dir = str(ev.get("data_dir", ""))
                overrides = ev.get("config") or {}
                arrays = self._admit(site, data_dir, overrides)
                if arrays is None:
                    self.bus.counter("serve_spool_events_total", result="rejected")
                    return False
                self.table, slot, gen = self.table.join(site)
                sl = self.table.slice_of(slot, self.num_slices)
                self._data[site], self._dirs[site] = arrays, data_dir
                self._overrides[site] = overrides
                if trace_id:
                    self._traces[site] = trace_id
                self._ensure_state()
                self._reset_slot(slot, site=site, generation=gen)
                self._log(f"[serve] join {site!r} → slot {slot} (generation {gen})")
                self._event("membership-join", site=site, slot=slot, slice=sl, generation=gen,
                            trace=trace_id)
                self.flight.note("membership-join", site=site, slot=slot, slice=sl,
                                 trace=trace_id)
                self.bus.counter("serve_spool_events_total", result="applied")
                self.bus.gauge("serve_member_generation", gen, site=site)
                self._publish_slice_gauges()
                return True
            if kind == "leave":
                site = str(ev["site"])
                self.table, slot = self.table.leave(site)
                sl = self.table.slice_of(slot, self.num_slices)
                for d in (self._data, self._dirs, self._overrides, self._traces):
                    d.pop(site, None)
                self._log(f"[serve] leave {site!r} (slot {slot} freed)")
                self._event("membership-leave", site=site, slot=slot, slice=sl, trace=trace_id)
                self.flight.note("membership-leave", site=site, slot=slot, slice=sl)
                self.bus.counter("serve_spool_events_total", result="applied")
                self.bus.clear_gauge("serve_member_generation", site=site)
                self._publish_slice_gauges()
                return True
        except (MembershipError, KeyError) as e:
            log_warning(f"[serve] bad membership event {ev!r}: {e}")
            self._event("membership-error", reason=str(e))
            self.bus.counter("serve_spool_events_total", result="rejected")
            return False
        log_warning(f"[serve] unknown spool event {ev!r} — ignored")
        self.bus.counter("serve_spool_events_total", result="rejected")
        return False

    def _publish_slice_gauges(self) -> None:
        for sl, n in enumerate(self.table.slice_occupancy(self.num_slices)):
            self.bus.gauge("serve_slice_members", n, slice=str(sl))

    def _reset_slot(self, slot: int, site: str = "", generation: int = 0):
        """Fresh state rows for a newly assigned slot: a rejoining site never
        resurrects its previous incarnation's engine, health, buffer or
        stash rows."""
        from ..robustness.membership import reset_slot_state

        if self.state is None:
            return
        if int(self.state.health["quarantined"][slot]):
            self._log(f"[serve] slot {slot} was quarantined — lifted for {site!r} generation "
                      f"{generation}")
            self._event("quarantine-lift", site=site, slot=slot)
        self.state = reset_slot_state(self.state, slot, engine=self.trainer.engine)

    def _ensure_state(self):
        if self.state is not None or self._feat is None:
            return
        self.state = self.trainer.init_state(num_sites=self.capacity)
        if self._pending_ckpt_load:
            # a resume with no member: the first join shaped the template
            from ..trainer.checkpoint import load_checkpoint

            self._pending_ckpt_load = False
            self.state = load_checkpoint(self.ckpt_path, self.state)
        self._compiles0 = _build.BUILDS + _build.LOADS

    def _on_membership_change(self):
        """After a transition: rebalance (one block on one device: no move),
        refresh the occupancy mask, checkpoint the membership epoch."""
        from ..robustness.membership import move_slot_state

        self.table, moves = self.table.rebalance(1)
        for site, src, dst in moves:
            self._log(f"[serve] rebalance: {site!r} slot {src} → {dst}")
            if self.state is not None:
                self.state = move_slot_state(self.state, src, dst, engine=self.trainer.engine)
            self._event("membership-rebalance", site=site, src=src, dst=dst)
        self.trainer.membership_mask = self.table.occupancy()
        self._event("membership-epoch", epoch=self.table.epoch, occupied=self.table.occupied)
        self.checkpoint()

    # -- the spool ---------------------------------------------------------

    def ingest(self) -> bool:
        """Apply the spool's events in sorted-filename order; an event whose
        ``after_epoch`` is past the epochs trained stays queued (while held,
        queued events are released up to the first applied one). True when
        membership changed."""
        from ..trainer.logs import log_warning

        changed = False
        release = self._idle
        for name in sorted(os.listdir(self.spool_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.spool_dir, name)
            try:
                with open(path) as fh:
                    ev = json.load(fh)
            except (OSError, json.JSONDecodeError) as e:
                log_warning(f"[serve] unreadable spool file {path}: {e}")
                try:
                    os.replace(path, path + ".rejected")
                except OSError:
                    pass
                continue
            if not isinstance(ev, dict):
                log_warning(f"[serve] spool file {path} is not an object")
                os.remove(path)
                continue
            try:
                after = int(ev.get("after_epoch", 0) or 0)
            except (TypeError, ValueError):
                log_warning(f"[serve] spool file {path}: bad after_epoch "
                            f"{ev.get('after_epoch')!r}")
                try:
                    os.replace(path, path + ".rejected")
                except OSError:
                    pass
                continue
            if after > self.epochs_run and not release:
                continue  # scheduled for later
            os.remove(path)
            applied = self.apply_event(ev)
            changed |= applied
            if applied:
                release = False  # the hold may have lifted: strict again
            if self._stop:
                break
        self.bus.gauge("serve_spool_ingest_lag_s", self._spool_lag())
        return changed

    def _spool_lag(self) -> float:
        """Seconds since the oldest spool file still pending was written; 0.0
        with an empty spool."""
        oldest = None
        try:
            for name in os.listdir(self.spool_dir):
                if not name.endswith(".json"):
                    continue
                try:
                    mtime = os.path.getmtime(os.path.join(self.spool_dir, name))
                except OSError:
                    continue
                oldest = mtime if oldest is None else min(oldest, mtime)
        except OSError:
            return 0.0
        return 0.0 if oldest is None else round(max(time.time() - oldest, 0.0), 3)

    # -- training ----------------------------------------------------------

    def trainable(self) -> bool:
        """Whether :meth:`train_epoch` would train now rather than hold."""
        if self.table.occupied < self.quorum or self.state is None:
            return False
        return any(len(self._data[s]) >= self.cfg.batch_size for s in self.table.members())

    def _slot_sites(self) -> list:
        """The per-slot site list an epoch trains on: each occupant's arrays
        at its slot, the shared empty placeholder elsewhere."""
        if self._empty_site is None:
            self._empty_site = SiteArrays(np.zeros((0,) + self._feat, np.float32),
                                          np.zeros((0,), np.int32), np.zeros((0,), np.int32))
        return [self._data[s] if s is not None else self._empty_site for s in self.table.slots]

    def train_epoch(self):
        """One epoch over the current membership; the epoch loss, or None
        when the service held (below quorum, no state yet, no member large
        enough for a batch), which counts one epoch's rounds into
        ``held_rounds``."""
        if not self.trainable():
            rounds = max((self._steps or 1) // max(self.cfg.local_iterations, 1), 1)
            self.held_rounds += rounds
            hold = {} if self.table.occupied < self.quorum or self.state is None else {
                "reason": "no trainable batch"}
            self._event("round-hold", occupied=self.table.occupied, quorum=self.quorum, **hold)
            self.bus.counter("serve_held_rounds_total", rounds)
            self.bus.gauge("serve_members", self.table.occupied)
            self.flight.note("round-hold", occupied=self.table.occupied, quorum=self.quorum)
            return None
        if self._steps is None:
            # pin the plan height at the first contact with data
            from ..data.batching import epoch_steps

            self._steps = epoch_steps([s for s in self._slot_sites() if len(s)],
                                      self.cfg.batch_size)
        self.trainer.fixed_steps = self._steps
        self.trainer.fixed_inventory_rows = self._rows
        self.epochs_run += 1
        t0 = time.perf_counter()  # the tracer's clock
        with self.trainer.tracer.span("epoch", epoch=self.epochs_run):
            self.state, losses = self.trainer.run_epoch(self.state, self._slot_sites(),
                                                        self.epochs_run,
                                                        batch_size=self.cfg.batch_size)
        lived = losses[np.isfinite(losses)]
        loss = float(lived.mean()) if lived.size else float("nan")
        if self._sink is not None:
            self.trainer._fit_tel = self._sink
            self.trainer._epoch_row(0, self.epochs_run, loss, t0, self.state)
        self.bus.gauge("serve_epoch", self.epochs_run)
        self.bus.gauge("serve_train_loss", loss)
        self.bus.gauge("serve_members", self.table.occupied)
        self.bus.counter("serve_epochs_total")
        self.bus.observe("serve_epoch_ms", (time.perf_counter() - t0) * 1e3)
        self.flight.note("serve-epoch", epoch=self.epochs_run, loss=loss,
                         occupied=self.table.occupied)
        self._log(f"[serve] epoch {self.epochs_run}: train_loss={loss:.4f} "
                  f"({self.table.occupied}/{self.capacity} slots)")
        # an exhausted ε budget (the trainer's accountant, stepped in
        # run_epoch) is a clean stop of this daemon: checkpoint, latch
        if self._budget_spent():
            self._event("dp-budget", epsilon=self.trainer._dp_epsilon,
                        budget=float(self.cfg.dp_epsilon_budget))
            self.bus.counter("serve_dp_budget_stops_total")
            self._log(f"[serve] dp ε-budget exhausted: ε={self.trainer._dp_epsilon:.3f} ≥ "
                      f"{self.cfg.dp_epsilon_budget} — checkpointing and stopping")
            self.checkpoint()
            self._stop = True
        return loss

    def _budget_spent(self) -> bool:
        """Whether the trainer's ε has reached ``dp_epsilon_budget``."""
        budget = float(self.cfg.dp_epsilon_budget or 0.0)
        eps = self.trainer._dp_epsilon
        return budget > 0 and eps is not None and eps >= budget

    def compiles_after_first_epoch(self) -> dict:
        """Kernel libraries built and loaded since the first trained epoch
        (``ops/_build.py``): 0 across any churn, the port's counterpart of
        JAX's one epoch compile."""
        return self.trainer.compiles_after_first_epoch()

    # -- checkpoints -------------------------------------------------------

    def checkpoint(self):
        """The rotating checkpoint, with the membership table, the members'
        data directories and overrides and the privacy ledger in its meta,
        then ``publish.json``."""
        from ..trainer.checkpoint import save_checkpoint

        if self.state is None:
            return
        with self.trainer.tracer.span("checkpoint"):
            save_checkpoint(self.ckpt_path, self.state, rotate=True, meta={
                "epoch": self.epochs_run, "held_rounds": self.held_rounds,
                "steps": self._steps, "rows": self._rows, "membership": self.table.to_json(),
                "data_dirs": dict(self._dirs), "site_overrides": dict(self._overrides),
                # the joins whose data trained the published model: a serving
                # engine that loads it names them (its status's
                # checkpoint_traces)
                "traces": dict(self._traces),
                "dp_accountant": (self.trainer.dp_accountant.to_json()
                                  if self.trainer.dp_accountant is not None else None)})
        self._event("checkpoint-publish", epoch=self.epochs_run, traces=dict(self._traces))
        self.flight.note("checkpoint-publish", epoch=self.epochs_run)
        self.bus.counter("serve_checkpoints_total")
        self._announce_publish()

    def _announce_publish(self) -> None:
        """Drop ``publish.json`` beside the checkpoint, atomically: the path,
        the epoch, the weights' ``params_digest`` (a watcher skips a load
        when the weights did not change) and the membership epoch."""
        from ..trainer.checkpoint import params_digest

        note = {"path": self.ckpt_path, "epoch": self.epochs_run,
                "digest": params_digest(self.state.params, self.state.batch_stats),
                "membership_epoch": self.table.epoch}
        tmp = self.ckpt_path + ".publish.tmp"
        with open(tmp, "w") as fh:
            json.dump(note, fh)
        os.replace(tmp, os.path.join(os.path.dirname(self.ckpt_path), "publish.json"))

    def _resume(self) -> bool:
        """Restore the table, re-admit the members from their recorded
        directories and restore the state and the privacy ledger (ε goes on
        from where it stood, and a spent budget keeps the stop latched);
        False when there is no checkpoint (the caller then starts fresh)."""
        from ..privacy.accounting import RdpAccountant
        from ..robustness.membership import MembershipTable
        from ..trainer.checkpoint import load_checkpoint, load_meta

        if not (os.path.exists(self.ckpt_path) or os.path.exists(self.ckpt_path + ".prev")):
            self._log("[serve] resume requested but no checkpoint — starting fresh")
            return False
        meta = load_meta(self.ckpt_path)
        self.table = MembershipTable.from_json(meta["membership"])
        if self.table.capacity != self.capacity:
            raise ValueError(f"checkpointed capacity {self.table.capacity} != daemon capacity "
                             f"{self.capacity} — the slot axis is pinned for the life of the "
                             "service")
        self.epochs_run = int(meta.get("epoch", 0))
        self.held_rounds = int(meta.get("held_rounds", 0))
        self._steps = meta.get("steps") or self._steps
        self._rows = meta.get("rows") or self._rows
        self._dirs = dict(meta.get("data_dirs", {}))
        self._overrides = dict(meta.get("site_overrides", {}))
        self._traces = dict(meta.get("traces", {}))
        if self.trainer.dp_accountant is not None and meta.get("dp_accountant"):
            self.trainer.dp_accountant = RdpAccountant.from_json(meta["dp_accountant"])
            self.trainer._dp_epsilon = float(
                self.trainer.dp_accountant.epsilon(self.cfg.dp_delta)[0])
            if self._budget_spent():
                self._log(f"[serve] dp ε-budget already spent (ε={self.trainer._dp_epsilon:.3f})"
                          " — staying stopped")
                self._stop = True
        for site, _ in sorted(self.table.members().items(), key=lambda kv: kv[1]):
            arrays = self._admit(site, self._dirs.get(site, ""), self._overrides.get(site))
            if arrays is None:
                raise RuntimeError(f"resume: cannot re-admit member {site!r} from "
                                   f"{self._dirs.get(site)!r}")
            self._data[site] = arrays
        self._ensure_state()
        if self.state is not None:
            self.state = load_checkpoint(self.ckpt_path, self.state)
        else:
            # every member had left: the first join builds the template,
            # then the checkpointed state is restored
            self._pending_ckpt_load = True
            self._log("[serve] resumed with an empty membership table — idling until a site "
                      "joins")
        self.trainer.membership_mask = self.table.occupancy()
        self.trainer.fixed_steps = self._steps
        self.trainer.fixed_inventory_rows = self._rows
        self._log(f"[serve] resumed at epoch {self.epochs_run} with {self.table.occupied}/"
                  f"{self.capacity} slots (membership epoch {self.table.epoch})")
        return True

    # -- the service loop --------------------------------------------------

    def serve(self, max_epochs: int | None = None, max_wall_s: float | None = None) -> dict:
        """Drain the spool, hold below quorum, train, checkpoint, until a
        shutdown event, SIGTERM or SIGINT (a checkpointed exit),
        ``max_epochs`` trained epochs or ``max_wall_s`` seconds; returns
        :meth:`close`'s summary."""
        from ..robustness.preemption import PreemptionGuard

        t0 = time.monotonic()
        trained_here = 0
        # after a hold the loop idles on the spool: only a membership change
        # lifts it, and held_rounds counts declined epochs
        self._idle = False
        with PreemptionGuard() as guard:
            while not self._stop:
                changed = self.ingest()
                if changed:
                    self._on_membership_change()
                    self._idle = False
                if self._stop:
                    break
                loss = None
                if not self._idle:
                    loss = self.train_epoch()
                    if loss is None:
                        self._idle = True
                    else:
                        trained_here += 1
                        self.checkpoint()
                if guard.requested is not None:
                    self._preempted = True
                    self._log(f"[serve] signal {guard.requested} — checkpointed, shutting down")
                    self.checkpoint()
                    # the guard owns the signal handlers here, so the flight
                    # recorder dumps cooperatively: the final spans and the
                    # bus snapshot land in flight_<pid>.json before the exit
                    self.flight.note("signal", signum=guard.requested)
                    self.flight.dump(f"signal:{guard.requested}")
                    break
                if max_epochs is not None and trained_here >= max_epochs:
                    break
                if max_wall_s is not None and time.monotonic() - t0 >= max_wall_s:
                    break
                if loss is None and not changed:
                    time.sleep(self.poll_s)
        return self.close()

    def health_probes(self) -> dict:
        """Readiness by subsystem for ``/healthz``: the service is ready
        when it has a state, meets its quorum and can reach its spool."""
        return {"state": lambda: self.state is not None,
                "quorum": lambda: self.table.occupied >= self.quorum,
                "spool": lambda: os.path.isdir(self.spool_dir)}

    def status(self) -> dict:
        """The service's live status, JAX's ``status()`` keys on one device
        (one slice, no slice grant), with the kernel libraries built or
        loaded since the first epoch."""
        return {
            "mode": "daemon",
            "task_id": self.cfg.task_id,
            "epoch": self.epochs_run,
            "held_rounds": self.held_rounds,
            "capacity": self.capacity,
            "quorum": self.quorum,
            "occupied": self.table.occupied,
            "holding": self._idle,
            "members": {
                site: {"slot": slot, "slice": self.table.slice_of(slot, self.num_slices),
                       "generation": self.table.generation_of(site),
                       "samples": len(self._data.get(site, ())),
                       "trace_id": self._traces.get(site)}
                for site, slot in sorted(self.table.members().items())},
            "num_slices": self.num_slices,
            "min_slices": self.cfg.min_slices,
            "slice_grant": None,
            "slice_occupancy": self.table.slice_occupancy(self.num_slices),
            "membership_epoch": self.table.epoch,
            "steps": self._steps,
            "inventory_rows": self._rows,
            "spool_dir": self.spool_dir,
            "spool_lag_s": self._spool_lag(),
            "preempted": self._preempted,
            "compiles_after_first_epoch": self.compiles_after_first_epoch(),
        }

    def close(self) -> dict:
        """The final checkpoint, and with telemetry on the summary row and
        the trace files; returns the service summary."""
        from ..robustness.membership import membership_rollup

        self.checkpoint()
        rollup = membership_rollup(self.table, self.state, held_rounds=self.held_rounds)
        summary = {
            "epochs_run": self.epochs_run,
            "held_rounds": self.held_rounds,
            "membership": rollup,
            "table": self.table.to_json(),
            "preempted": self._preempted,
            "compiles_after_first_epoch": self.compiles_after_first_epoch(),
        }
        if self._sink is not None:
            # kernel libraries built or loaded since the state was built:
            # the counterpart of JAX's epoch compiles
            compiles = _build.BUILDS + _build.LOADS - (self._compiles0 or 0)
            self._sink.append({"kind": "summary", "fold": 0, "epochs_run": self.epochs_run,
                               "epoch_compiles": compiles, "best_val_epoch": 0,
                               "membership": rollup})
            self._sink.close()
            self._sink = None
        return summary
