"""The fleet scheduler: one pool of slices, many tenants; the port's
counterpart of the JAX package's ``runner/scheduler.py``.

A card that runs one study at a time idles through quorum holds, spool gaps
between cohorts and admission waits. The scheduler packs concurrent
studies (*tenants*) and a serving lane onto a shared pool of slices, so
the pool's slice-seconds go to whoever can use them.

- **Tenants.** Each is a :class:`TenantSpec`, a ``FedDaemon``-shaped fit
  (config, data tree, capacity and quorum) with its scheduling attributes
  (priority band, weight, slice quota). Tenants arrive through the
  scheduler's own spool of JSON events (``register``, ``deregister``,
  ``shutdown``: sorted filenames, removed when applied, a malformed file
  quarantined as ``.rejected``) or through :meth:`FleetScheduler.register`.
  Each gets its own spool, checkpoint, telemetry sink (its manifest tagged
  ``{"tenant": id}``) and ε ledger under ``<root>/tenants/<id>/``, and
  publishes through a ``LabeledBusView`` of the one bus.
- **Fair share.** :func:`fair_share` allocates integer slices in strictly
  descending priority bands, weighted max-min inside a band, capped by
  each tenant's quota and demand (a holding tenant demands 0). What no
  band uses is the backfill's.
- **Checkpoint, then yield.** A shrink of a tenant's grant writes its
  rotating checkpoint first, then lowers its slice-grant mask; a tenant
  shrunk to 0 is preempted. Its resume reloads that checkpoint through the
  CRC-framed msgpack path into the existing state, then raises the mask, so
  the resumed tenant goes on bit for bit. A per-tenant compile guard holds
  each tenant to no kernel library built or loaded after its first epoch.
- **Backfill.** Slices no tenant uses this tick host a
  :class:`BackfillLane`, a serving ``ReplicaSet`` warmed on its first
  grant.
- **Goodput.** Busy slice-seconds over wall time and every preemption
  pause.

One card: every slice of the pool is the one device (JAX splits its
devices into ``pod_slices`` bands); ``pod_slices`` stays the width of the
pool that the fair share allocates, and tenants take turns on the card
tick by tick. A tenant of more than one slice is multi-GPU (ROADMAP A11 (b))
and is refused. At one slice the grant mask gates nothing inside an epoch,
as in JAX, whose trainer skips the slice window at one slice: a tenant
trains only while it holds a grant.

The scheduler is single-threaded and deterministic: tenants train in
(priority descending, tenant id) order, one epoch each a tick.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..ops import _build
from .fed_runner import FedDaemon

#: event kinds the scheduler spool accepts
SCHED_SPOOL_EVENTS = ("register", "deregister", "shutdown")

#: the append-only grant-decision log under the scheduler root (the
#: postmortem's input)
GRANTS_FILE = "grants.jsonl"


class SchedulerError(ValueError):
    """A tenant spec or scheduler-spool event that cannot be honored."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One study's admission ticket: the fit's shape and how it shares.

    ``config`` is a flat override dict (the spool event's form, applied by
    ``TrainConfig.with_overrides`` as a join event's ``config`` is) or a
    ``TrainConfig``. ``slice_quota`` caps the slices the tenant holds at
    once (default its own width, one), ``priority`` picks the band (higher
    preempts lower), ``weight`` the share inside the band, ``max_epochs``
    ends the study (None: until a ``deregister`` or ``shutdown``).
    """

    tenant: str
    data_path: str | None = None
    config: object = None  # flat override dict | TrainConfig | None
    capacity: int = 4
    quorum: int = 1
    priority: float = 1.0
    weight: float = 1.0
    slice_quota: int | None = None
    max_epochs: int | None = None
    inventory_rows: int | None = None
    steps: int | None = None
    resume: bool = False
    fault_plan: object = None
    attack_plan: object = None

    @classmethod
    def from_event(cls, ev: dict) -> "TenantSpec":
        """A spec from a spool ``register`` event; fault and attack plans
        in the JSON forms the CLI takes."""
        from ..robustness.attacks import parse_attack_plan
        from ..robustness.faults import parse_fault_plan

        tenant = str(ev.get("tenant") or "")
        if not tenant or "/" in tenant or tenant.startswith("."):
            raise SchedulerError(f"bad tenant id {tenant!r}")
        faults, attacks = ev.get("faults"), ev.get("attacks")

        def opt_int(key):
            return None if ev.get(key) is None else int(ev[key])

        return cls(
            tenant=tenant, data_path=ev.get("data_path"), config=ev.get("config") or {},
            capacity=int(ev.get("capacity", 4)), quorum=int(ev.get("quorum", 1)),
            priority=float(ev.get("priority", 1.0)), weight=float(ev.get("weight", 1.0)),
            slice_quota=opt_int("slice_quota"), max_epochs=opt_int("max_epochs"),
            inventory_rows=opt_int("inventory_rows"), steps=opt_int("steps"),
            resume=bool(ev.get("resume", False)),
            fault_plan=parse_fault_plan(json.dumps(faults)) if faults else None,
            attack_plan=parse_attack_plan(json.dumps(attacks)) if attacks else None)


def fair_share(pool: int, requests: list[dict]) -> dict[str, int]:
    """Integer slices in strictly descending priority bands, weighted
    max-min inside a band.

    ``requests`` rows carry ``tenant``, ``priority``, ``weight`` and
    ``demand`` (the most slices of use, 0 while the tenant would hold).
    Inside a band, slices go one at a time to the tenant with the fewest
    grants per unit weight (ties to the lower tenant id), up to each
    demand. A higher band drains the pool before a lower one sees it: that
    asymmetry is preemption. What no band can use is the backfill's.
    """
    grants = {str(r["tenant"]): 0 for r in requests}
    remaining = int(pool)
    for prio in sorted({float(r["priority"]) for r in requests}, reverse=True):
        band = [r for r in requests if float(r["priority"]) == prio and int(r["demand"]) > 0]
        while remaining > 0:
            open_ = [r for r in band if grants[str(r["tenant"])] < int(r["demand"])]
            if not open_:
                break
            pick = min(open_, key=lambda r: (
                grants[str(r["tenant"])] / max(float(r.get("weight", 1.0)), 1e-9),
                str(r["tenant"])))
            grants[str(pick["tenant"])] += 1
            remaining -= 1
    return grants


class Tenant:
    """One scheduled study: a port ``FedDaemon`` and its scheduling state.

    The daemon lives under ``<root>/tenants/<id>/`` (spool, output,
    telemetry) and publishes through a ``LabeledBusView`` of the one bus
    (every series carries ``tenant="<id>"``; the fixed label wins). Its
    slice-grant mask is installed as zeros before the first epoch, as in
    JAX. :meth:`compiles_after_first_epoch` counts the kernel libraries
    built or loaded during this tenant's own epochs after its first, so
    another tenant's first epoch is not charged to it; the tenant's
    ``CompileGuard`` holds it at 0, checked at :meth:`close`.
    """

    def __init__(self, spec: TenantSpec, root: str, bus, verbose: bool = False, device=None):
        from ..checks.sanitize import CompileGuard
        from ..telemetry.bus import LabeledBusView

        self.spec = spec
        base = os.path.join(root, "tenants", spec.tenant)
        self.spool_dir = os.path.join(base, "spool")
        self.out_dir = os.path.join(base, "output")
        self.bus = LabeledBusView(bus, tenant=spec.tenant)
        if isinstance(spec.config, TrainConfig):
            cfg, overrides = spec.config, {}
        else:
            cfg, overrides = None, dict(spec.config or {})
        slices = int(overrides.get("num_slices", 1) or 1)
        if slices > 1:
            raise SchedulerError(
                f"tenant {spec.tenant!r} asks for num_slices={slices}: a tenant of more than "
                "one slice is multi-GPU, not ported (ROADMAP A11 (b)); the port's tenants take "
                "one slice on one card")
        self.daemon = FedDaemon(
            cfg, capacity=spec.capacity, spool_dir=self.spool_dir, out_dir=self.out_dir,
            data_path=spec.data_path, quorum=spec.quorum, poll_s=0.0,
            fault_plan=spec.fault_plan, attack_plan=spec.attack_plan,
            inventory_rows=spec.inventory_rows, steps=spec.steps, resume=spec.resume,
            verbose=verbose, bus=self.bus, sink_tags={"tenant": spec.tenant}, device=device,
            **overrides)
        self.daemon.set_slice_grant(np.zeros(self.daemon.num_slices, np.float32))
        self._epochs_here = 0  # epochs this tenant trained in this process
        self._late = {"kernel_builds": 0, "kernel_loads": 0}
        self.guard = CompileGuard({"epoch_fn": self}, max_compiles=0,
                                  label=f"tenant:{spec.tenant}")
        self.granted = 0
        self.status = "active"  # active | done | stopped
        self.preempted = False
        self.preempt_count = 0
        self.pauses_ms: list[float] = []
        self.busy_slice_s = 0.0  # granted x trained time (fairness)

    # -- scheduling predicates --------------------------------------------

    @property
    def num_slices(self) -> int:
        return self.daemon.num_slices

    @property
    def quota(self) -> int:
        q = self.spec.slice_quota
        return self.num_slices if q is None else max(int(q), 0)

    @property
    def finished(self) -> bool:
        return self.spec.max_epochs is not None and self.daemon.epochs_run >= self.spec.max_epochs

    def runnable(self) -> bool:
        return self.status == "active" and not self.finished and self.daemon.trainable()

    def demand(self) -> int:
        """The most slices of use this tick: 0 while the fit would hold,
        else its quota and width, at least one."""
        if not self.runnable():
            return 0
        return max(min(self.quota, self.num_slices), 1)

    # -- spool / membership ------------------------------------------------

    def pump_spool(self) -> bool:
        """Drain the tenant's own membership spool (joins, leaves,
        shutdown)."""
        changed = self.daemon.ingest()
        if changed:
            self.daemon._on_membership_change()
        if self.daemon._stop and self.status == "active":
            self.status = "stopped"
        return changed

    # -- the yield protocol ------------------------------------------------

    def apply_grant(self, n: int) -> float:
        """Move this tenant to ``n`` granted slices; the pause in ms (0.0
        when nothing changed).

        A shrink writes the rotating checkpoint, then lowers the mask; a
        shrink to zero marks the tenant preempted. A grow out of preemption
        reloads that checkpoint into the existing state before the mask
        rises, so the resumed trajectory is the never-preempted one.
        """
        n = max(int(n), 0)
        if n == self.granted:
            return 0.0
        t0 = time.perf_counter()
        phase = "yield" if n < self.granted else "resume"
        if n < self.granted:
            self.daemon.checkpoint()
            if n == 0 and self.status == "active" and self.daemon.state is not None:
                self.preempted = True
                self.preempt_count += 1
        elif self.granted == 0 and self.preempted:
            self.daemon.reload_checkpoint()
            self.preempted = False
        mask = np.zeros(self.num_slices, np.float32)
        mask[:min(n, self.num_slices)] = 1.0
        self.daemon.set_slice_grant(mask)
        self.granted = n
        pause_ms = (time.perf_counter() - t0) * 1e3
        self.pauses_ms.append(pause_ms)
        self.bus.observe("sched_preempt_pause_ms", pause_ms, phase=phase)
        return pause_ms

    # -- training / lifecycle ----------------------------------------------

    def train_epoch(self):
        before = (_build.BUILDS, _build.LOADS)
        loss = self.daemon.train_epoch()
        if loss is not None:
            if self._epochs_here:
                self._late["kernel_builds"] += _build.BUILDS - before[0]
                self._late["kernel_loads"] += _build.LOADS - before[1]
            self._epochs_here += 1
        return loss

    def compiles_after_first_epoch(self) -> dict:
        """Kernel libraries built and loaded during this tenant's epochs
        after its first (the compile guard's count)."""
        return dict(self._late)

    def params_digest(self):
        from ..trainer.checkpoint import params_digest

        if self.daemon.state is None:
            return None
        return params_digest(self.daemon.state.params, self.daemon.state.batch_stats)

    def status_view(self) -> dict:
        return {
            "tenant": self.spec.tenant,
            "status": self.status,
            "priority": self.spec.priority,
            "weight": self.spec.weight,
            "quota": self.quota,
            "granted": self.granted,
            "preempted": self.preempted,
            "preempt_count": self.preempt_count,
            "epochs_run": self.daemon.epochs_run,
            "held_rounds": self.daemon.held_rounds,
            "trainable": self.daemon.trainable(),
            "daemon": self.daemon.status(),
        }

    def close(self) -> dict:
        """The daemon's summary, with this tenant's own compile count
        (raises ``SanitizerViolation`` when a library was built or loaded
        after its first epoch)."""
        summary = self.daemon.close()
        summary["tenant"] = self.spec.tenant
        summary["preempt_count"] = self.preempt_count
        self.guard.check(f"tenant {self.spec.tenant!r} close "
                         f"(preemptions={self.preempt_count})")
        summary["compiles_after_first_epoch"] = self.compiles_after_first_epoch()
        return summary


class BackfillLane:
    """A serving lane that takes the tick's leftover slices: a
    ``ReplicaSet`` built and warmed on its first grant, on the scheduler's
    device. Each :meth:`run_quantum` serves a bounded burst from ``feed``
    (a callable returning one request's rows); draining it is not granting
    the next quantum (the lane keeps no training state)."""

    def __init__(self, cfg: TrainConfig, feed, *, params=None, batch_stats=None,
                 checkpoint: str | None = None, replicas: int = 1,
                 requests_per_quantum: int = 4, name: str = "backfill",
                 engine_kwargs: dict | None = None):
        if feed is None:
            raise SchedulerError("BackfillLane needs a feed() callable returning one request's "
                                 "rows")
        self.cfg = cfg
        self.feed = feed
        self.params = params
        self.batch_stats = batch_stats
        self.checkpoint = checkpoint
        self.replicas = int(replicas)
        self.requests_per_quantum = int(requests_per_quantum)
        self.name = name
        self.engine_kwargs = dict(engine_kwargs or {})
        self.requests_served = 0
        self.samples_served = 0
        self.quanta = 0
        self._set = None

    def _ensure(self, bus, devices) -> None:
        if self._set is not None:
            return
        from ..serving.fleet import ReplicaSet
        from ..telemetry.bus import LabeledBusView

        self._set = ReplicaSet(
            self.cfg, replicas=self.replicas, params=self.params, batch_stats=self.batch_stats,
            checkpoint=self.checkpoint,
            bus=LabeledBusView(bus, lane=self.name) if bus is not None else None,
            devices=list(devices) if devices else None, **self.engine_kwargs)
        self._set.warmup()

    def run_quantum(self, bus=None, devices=None) -> dict:
        """One bounded serving burst; ``{"requests": n, "samples": m}``."""
        self._ensure(bus, devices)
        bursts = []
        for _ in range(self.requests_per_quantum):
            rows = self.feed()
            bursts.append((self._set.submit(rows), len(rows)))
        requests = samples = 0
        for fut, n in bursts:
            fut.result()
            requests += 1
            samples += n
        self.requests_served += requests
        self.samples_served += samples
        self.quanta += 1
        return {"requests": requests, "samples": samples}

    def status(self) -> dict:
        return {
            "name": self.name,
            "started": self._set is not None,
            "replicas": self.replicas,
            "requests_served": self.requests_served,
            "samples_served": self.samples_served,
            "quanta": self.quanta,
            "fleet": None if self._set is None else self._set.status(),
        }

    def close(self) -> dict:
        """Close the fleet (it raises when a replica built or loaded a
        kernel library after its warmup); the lane's counts."""
        out = {"name": self.name, "requests_served": self.requests_served,
               "samples_served": self.samples_served, "quanta": self.quanta}
        if self._set is not None:
            self._set.assert_no_compiles()
            out["fleet"] = self._set.close()
            self._set = None
        return out


class FleetScheduler:
    """The tick loop: drain the spools, allocate, yield and resume, train
    one epoch a granted tenant, backfill the residue, account.

    ``pod_slices`` is the pool's width in slices, every slice the one
    ``device`` (the card unless the caller asks for ``"cpu"``). Goodput
    integrals (busy slice-seconds over wall) and every preemption pause are
    kept; gauges go tenant-labeled into the one ``bus`` (the process's
    unless one is passed).
    """

    def __init__(self, root: str, pod_slices: int = 1, bus=None, poll_s: float = 0.05,
                 verbose: bool = True, backfill: BackfillLane | None = None, device=None):
        from ..telemetry.bus import global_bus

        if pod_slices < 1:
            raise SchedulerError(f"pod_slices must be >= 1, got {pod_slices}")
        self.root = root
        self.spool_dir = os.path.join(root, "spool")
        os.makedirs(self.spool_dir, exist_ok=True)
        self.pod_slices = int(pod_slices)
        self.bus = bus if bus is not None else global_bus()
        self.poll_s = poll_s
        self.verbose = verbose
        self.backfill = backfill
        self.device = resolve_device(device)
        self.tenants: dict[str, Tenant] = {}
        self._stop = False
        self._preempted = False
        self._last_grants: dict | None = None
        self.ticks = 0
        self._wall_s = 0.0
        self._busy_slice_s = 0.0
        # every slice's band is the one card (JAX: a band of its devices a
        # slice; the backfill takes the tail band)
        self._slice_devices = [[self.device] for _ in range(self.pod_slices)]
        self.bus.gauge("sched_pod_slices", self.pod_slices)

    def _log(self, msg: str) -> None:
        if self.verbose:
            from ..trainer.logs import log_info

            log_info(msg)

    # -- tenant admission --------------------------------------------------

    def register(self, spec: TenantSpec) -> Tenant:
        if spec.tenant in self.tenants:
            raise SchedulerError(f"tenant {spec.tenant!r} already registered")
        t = Tenant(spec, self.root, self.bus, verbose=self.verbose, device=self.device)
        self.tenants[spec.tenant] = t
        self.bus.counter("sched_events_total", kind="register")
        self.bus.gauge("sched_tenants", len(self.tenants))
        self._log(f"[sched] register tenant {spec.tenant!r} (priority {spec.priority}, quota "
                  f"{t.quota}, mesh slices {t.num_slices})")
        return t

    def deregister(self, tenant: str) -> None:
        t = self.tenants.get(tenant)
        if t is None or t.status != "active":
            return
        t.status = "stopped"  # before the grant drop: not a preemption
        t.apply_grant(0)
        self.bus.counter("sched_events_total", kind="deregister")
        self._log(f"[sched] deregister tenant {tenant!r}")

    def ingest(self) -> bool:
        """Drain the scheduler spool: sorted-filename order, each file
        removed when applied, a malformed one quarantined as
        ``.rejected``."""
        from ..trainer.logs import log_warning

        changed = False
        for name in sorted(os.listdir(self.spool_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.spool_dir, name)
            try:
                with open(path) as fh:
                    ev = json.load(fh)
            except (OSError, json.JSONDecodeError) as e:
                log_warning(f"[sched] unreadable spool file {path}: {e}")
                try:
                    os.replace(path, path + ".rejected")
                except OSError:
                    pass
                continue
            os.remove(path)
            if not isinstance(ev, dict):
                log_warning(f"[sched] spool file {path} is not an object")
                continue
            kind = ev.get("event")
            try:
                if kind == "register":
                    self.register(TenantSpec.from_event(ev))
                    changed = True
                elif kind == "deregister":
                    self.deregister(str(ev.get("tenant") or ""))
                    changed = True
                elif kind == "shutdown":
                    self._stop = True
                    self._log("[sched] shutdown event received")
                    break
                else:
                    log_warning(f"[sched] unknown spool event {ev!r} — ignored")
                    self.bus.counter("sched_events_total", kind="rejected")
            except (SchedulerError, ValueError, TypeError, NotImplementedError) as e:
                log_warning(f"[sched] bad spool event {ev!r}: {e}")
                self.bus.counter("sched_events_total", kind="rejected")
        return changed

    def _log_grants(self, grants: dict, preempt_pause_ms: float) -> None:
        """Append one grant decision to ``<root>/grants.jsonl``, only when
        the allocation changes: a decision history, not a heartbeat."""
        try:
            with open(os.path.join(self.root, GRANTS_FILE), "a") as fh:
                fh.write(json.dumps({"time_unix": time.time(), "tick": self.ticks,
                                     "grants": grants,
                                     "preempt_pause_ms": round(preempt_pause_ms, 3)}) + "\n")
        except OSError as e:
            # a full disk must not take the scheduler down
            from ..trainer.logs import log_warning

            log_warning(f"[sched] grant log not written: {e}")

    # -- the tick ----------------------------------------------------------

    def _order(self) -> list[Tenant]:
        return sorted(self.tenants.values(), key=lambda t: (-t.spec.priority, t.spec.tenant))

    def tick(self, sleep_when_idle: bool = True) -> dict:
        """One scheduling round: spools, allocation, shrinks before grows
        (every yield's checkpoint lands before any resume's reload, so the
        pool is never oversubscribed mid-tick), one epoch a granted tenant,
        the backfill on the residue, the accounts."""
        t0 = time.perf_counter()
        changed = self.ingest()
        for t in self._order():
            changed |= t.pump_spool()
            if t.finished and t.status == "active":
                t.status = "done"  # before the grant drop: a finish is not a preemption
                t.apply_grant(0)
                self._log(f"[sched] tenant {t.spec.tenant!r} done ({t.daemon.epochs_run} epochs)")
                changed = True
        requests = [{"tenant": t.spec.tenant, "priority": t.spec.priority,
                     "weight": t.spec.weight, "demand": t.demand()} for t in self._order()]
        grants = fair_share(self.pod_slices, requests)
        # a grant below the tenant's slice quorum would only buy held rounds:
        # it goes back to the residue
        for t in self._order():
            g = grants.get(t.spec.tenant, 0)
            if 0 < g < int(getattr(t.daemon.cfg, "min_slices", 1) or 1):
                grants[t.spec.tenant] = 0
        preempt_pause_ms = 0.0
        for t in self._order():  # shrinks first: free before granting
            g = grants.get(t.spec.tenant, 0)
            if g < t.granted:
                preempt_pause_ms += t.apply_grant(g)
        for t in self._order():
            g = grants.get(t.spec.tenant, 0)
            if g > t.granted:
                preempt_pause_ms += t.apply_grant(g)
        if grants != self._last_grants:
            self._log_grants(grants, preempt_pause_ms)
            self._last_grants = dict(grants)
        trained = busy = 0
        trained_tenants = []
        for t in self._order():
            if t.granted > 0 and t.status == "active":
                if t.train_epoch() is not None:
                    trained += 1
                    busy += t.granted
                    trained_tenants.append(t)
        leftover = self.pod_slices - sum(t.granted for t in self.tenants.values())
        served = {"requests": 0, "samples": 0}
        if self.backfill is not None and leftover > 0:
            served = self.backfill.run_quantum(bus=self.bus, devices=self._slice_devices[-1])
            if served["requests"]:
                busy += leftover
        dt = time.perf_counter() - t0
        idle_tick = trained == 0 and not served["requests"] and not changed
        if sleep_when_idle and idle_tick and not self._stop:
            time.sleep(self.poll_s)
            dt += self.poll_s
        self._wall_s += dt
        self._busy_slice_s += min(busy, self.pod_slices) * dt
        for t in trained_tenants:  # the fairness ledger: who got the pool
            t.busy_slice_s += t.granted * dt
        self.ticks += 1
        for t in self.tenants.values():
            self.bus.gauge("sched_granted_slices", t.granted, tenant=t.spec.tenant)
        self.bus.counter("sched_ticks_total")
        self.bus.gauge("sched_idle_fraction", self.idle_fraction())
        self.bus.gauge("sched_backfill_requests",
                       0 if self.backfill is None else self.backfill.requests_served)
        return {"trained": trained, "grants": grants, "busy_slices": busy, "leftover": leftover,
                "served": served, "changed": changed,
                "preempt_pause_ms": round(preempt_pause_ms, 3)}

    # -- lifecycle ---------------------------------------------------------

    def done(self) -> bool:
        return bool(self.tenants) and all(
            t.status in ("done", "stopped") for t in self.tenants.values())

    def run(self, max_wall_s: float | None = None, max_ticks: int | None = None) -> dict:
        """Tick until every tenant is done or stopped, a shutdown event or a
        signal arrives, or a bound trips; a SIGTERM or SIGINT checkpoints
        and yields every tenant. Returns :meth:`close`'s summary."""
        from ..robustness.preemption import PreemptionGuard

        t_start = time.monotonic()
        with PreemptionGuard() as guard:
            while not self._stop:
                self.tick()
                if guard.requested is not None:
                    self._preempted = True
                    for t in self._order():
                        t.apply_grant(0)
                    self._log("[sched] preemption signal — all tenants checkpointed and yielded")
                    break
                if self.done():
                    break
                if max_ticks is not None and self.ticks >= max_ticks:
                    break
                if max_wall_s is not None and time.monotonic() - t_start >= max_wall_s:
                    break
        return self.close()

    def idle_fraction(self) -> float:
        denom = self.pod_slices * self._wall_s
        if denom <= 0:
            return 0.0
        return round(1.0 - self._busy_slice_s / denom, 6)

    def goodput(self) -> dict:
        """Busy and idle slice time, the preemption pauses and each
        tenant's progress."""
        pauses = [p for t in self.tenants.values() for p in t.pauses_ms]
        return {
            "pod_slices": self.pod_slices,
            "wall_s": round(self._wall_s, 4),
            "busy_slice_s": round(self._busy_slice_s, 4),
            "slice_idle_fraction": self.idle_fraction(),
            "ticks": self.ticks,
            "preempt_count": sum(t.preempt_count for t in self.tenants.values()),
            "preempt_pause_ms_p50": (round(float(np.percentile(pauses, 50)), 3) if pauses
                                     else 0.0),
            "preempt_pause_ms_p99": (round(float(np.percentile(pauses, 99)), 3) if pauses
                                     else 0.0),
            "epochs": {t.spec.tenant: t.daemon.epochs_run for t in self.tenants.values()},
            "busy_slice_s_per_tenant": {t.spec.tenant: round(t.busy_slice_s, 4)
                                        for t in self.tenants.values()},
            "backfill": (None if self.backfill is None else {
                "requests": self.backfill.requests_served,
                "samples": self.backfill.samples_served}),
        }

    # -- live observability ------------------------------------------------

    def status(self) -> dict:
        """The ``/statusz`` payload: the scheduler's state and every
        tenant's own daemon status."""
        return {
            "mode": "scheduler",
            "pod_slices": self.pod_slices,
            "ticks": self.ticks,
            "preempted": self._preempted,
            "goodput": self.goodput(),
            "spool_dir": self.spool_dir,
            "tenants": {name: t.status_view() for name, t in sorted(self.tenants.items())},
            "backfill": None if self.backfill is None else self.backfill.status(),
        }

    def health_probes(self) -> dict:
        probes = {"spool": lambda: os.path.isdir(self.spool_dir)}
        for name, t in self.tenants.items():
            probes[f"tenant_{name}"] = lambda t=t: t.status in ("active", "done", "stopped")
        return probes

    def close(self) -> dict:
        """Checkpoint and close every tenant (each checks its compile
        guard), close the backfill lane; the fleet's summary."""
        summaries = {name: t.close() for name, t in sorted(self.tenants.items())}
        out = {"tenants": summaries, "goodput": self.goodput(), "preempted": self._preempted}
        if self.backfill is not None:
            out["backfill"] = self.backfill.close()
        return out
