"""Deterministic fault injection: the port's copy of the JAX package's
``robustness/faults.py``, numpy only.

A :class:`FaultPlan` describes, in *global round* coordinates, which faults
a run should see:

- ``drop``: scheduled site outages, ``(site, first_round, last_round)``
  triples (inclusive; ``last_round = -1`` means to the end of training). A
  dropped site has weight 0 in the round's aggregate;
- ``flaky_prob`` / ``flaky_seed``: per-(site, round) random drops from a
  counter-based draw (:meth:`FaultPlan._flaky_uniform`), so the same plan
  replays the same outages however the epochs are chunked and wherever a
  fit resumes;
- ``nan_at``: ``(round, site)`` pairs whose *inputs* are poisoned with NaN,
  so the site's gradient goes non-finite for real and the epoch's
  finiteness check and quarantine counters catch it;
- ``delay_at``: stragglers, ``(site, round, delay)`` triples: the site's
  update for rounds ``[round, round + delay)`` never arrives. The
  buffered-async rounds (``TrainConfig.staleness_bound > 0``) then serve
  the site's last deposit, decayed; the bulk-sync rounds see a drop;
- ``kill_at_round``: simulated preemption. The trainer raises
  ``robustness.Preempted`` (exit code 75) after the checkpoint of the
  epoch that crosses the round, and a resumed fit starts past it;
- ``slice_drop_at``, ``slice_delay_at``, ``kill_slice_at``: faults of the
  slice tier of a multi-slice topology, rendered by
  :meth:`FaultPlan.slice_liveness`. One card has no slice tier, so the
  trainer never asks for them, as JAX's skips them without one.

The masks are numpy arrays that the epoch takes as inputs; ``site``
indices are the epoch's site rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np


def _tuplize(rows, width: int, name: str) -> tuple:
    out = []
    for row in rows:
        row = tuple(int(v) for v in row)
        if len(row) != width:
            raise ValueError(f"FaultPlan.{name} entries need {width} integers, got {row!r}")
        out.append(row)
    return tuple(out)


def _window(mask, row: int, lo: int, hi: int) -> None:
    """Zero ``mask[row, lo:hi]`` where the window is not empty."""
    if lo < hi:
        mask[row, lo:hi] = 0.0


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule in global-round coordinates."""

    drop: tuple = ()  # (site, first_round, last_round) triples; -1 = forever
    flaky_prob: float = 0.0
    flaky_seed: int = 0
    nan_at: tuple = ()  # (round, site) pairs
    kill_at_round: int | None = None
    delay_at: tuple = ()  # (site, round, delay) straggler triples
    slice_drop_at: tuple = ()  # (slice, first_round, last_round); -1 = forever
    slice_delay_at: tuple = ()  # (slice, round, delay) straggler triples
    kill_slice_at: tuple = ()  # (slice, round): dead from round until restart

    def __post_init__(self):
        for name, width in (("drop", 3), ("nan_at", 2), ("delay_at", 3), ("slice_drop_at", 3),
                            ("slice_delay_at", 3), ("kill_slice_at", 2)):
            object.__setattr__(self, name, _tuplize(getattr(self, name), width, name))
        if not 0.0 <= float(self.flaky_prob) <= 1.0:
            raise ValueError(f"FaultPlan.flaky_prob must be in [0, 1], got {self.flaky_prob}")
        for site, first, last in self.drop:
            if site < 0 or first < 0 or (last != -1 and last < first):
                raise ValueError(f"bad FaultPlan.drop entry {(site, first, last)}")
        for rnd, site in self.nan_at:
            if rnd < 0 or site < 0:
                raise ValueError(f"bad FaultPlan.nan_at entry {(rnd, site)}")
        for site, rnd, delay in self.delay_at:
            if site < 0 or rnd < 0 or delay < 1:
                raise ValueError(f"bad FaultPlan.delay_at entry {(site, rnd, delay)} "
                                 "(need site >= 0, round >= 0, delay >= 1)")
        for sl, first, last in self.slice_drop_at:
            if sl < 0 or first < 0 or (last != -1 and last < first):
                raise ValueError(f"bad FaultPlan.slice_drop_at entry {(sl, first, last)}")
        for sl, rnd, delay in self.slice_delay_at:
            if sl < 0 or rnd < 0 or delay < 1:
                raise ValueError(f"bad FaultPlan.slice_delay_at entry {(sl, rnd, delay)} "
                                 "(need slice >= 0, round >= 0, delay >= 1)")
        for sl, rnd in self.kill_slice_at:
            if sl < 0 or rnd < 0:
                raise ValueError(f"bad FaultPlan.kill_slice_at entry {(sl, rnd)}")

    # -- round-window masks ----------------------------------------------

    def _flaky_uniform(self, num_sites: int, round_start: int, num_rounds: int) -> np.ndarray:
        """Counter-based uniform ``[num_sites, num_rounds]`` draw keyed by
        (seed, site, global round): the splitmix64 finalizer over one
        counter a cell, so the outage pattern is independent of chunking
        and resume point, bit for bit JAX's."""
        seed_term = (int(self.flaky_seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        site = np.arange(num_sites, dtype=np.uint64)[:, None]
        rnd = (np.uint64(round_start) + np.arange(num_rounds, dtype=np.uint64))[None, :]
        with np.errstate(over="ignore"):  # uint64 wraparound is the point
            x = (np.uint64(seed_term) + site * np.uint64(0xD1B54A32D192ED03)
                 + rnd * np.uint64(0x8CB92BA72F3D8DD7))
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
        return (x >> np.uint64(11)).astype(np.float64) * 2.0 ** -53

    def liveness(self, num_sites: int, round_start: int, num_rounds: int) -> np.ndarray:
        """``[num_sites, num_rounds]`` float32 mask for the round window
        ``[round_start, round_start + num_rounds)``: 1 = live, 0 =
        dropped. A ``delay_at`` window is a drop (no async buffers)."""
        live = np.ones((num_sites, num_rounds), np.float32)
        for site, first, last in self.drop:
            if site < num_sites:
                hi = num_rounds if last == -1 else min(last + 1 - round_start, num_rounds)
                _window(live, site, max(first - round_start, 0), hi)
        for site, rnd, delay in self.delay_at:
            if site < num_sites:
                _window(live, site, max(rnd - round_start, 0),
                        min(rnd + delay - round_start, num_rounds))
        if self.flaky_prob > 0.0:
            live[self._flaky_uniform(num_sites, round_start, num_rounds) < self.flaky_prob] = 0.0
        return live

    def nan_mask(self, num_sites: int, round_start: int, num_rounds: int) -> np.ndarray:
        """``[num_sites, num_rounds]`` bool mask of the (site, round) cells
        whose inputs are poisoned with NaN."""
        mask = np.zeros((num_sites, num_rounds), bool)
        for rnd, site in self.nan_at:
            r = rnd - round_start
            if 0 <= r < num_rounds and site < num_sites:
                mask[site, r] = True
        return mask

    def slice_liveness(self, num_slices: int, round_start: int, num_rounds: int,
                       include_kills: bool = True) -> np.ndarray:
        """``[num_slices, num_rounds]`` float32 slice-tier mask for the
        round window, JAX's: ``slice_drop_at`` and ``slice_delay_at``
        windows are 0, and a ``kill_slice_at`` slice stays 0 from its
        round to the end of the window (``include_kills=False`` leaves the
        kills out)."""
        live = np.ones((num_slices, num_rounds), np.float32)
        for sl, first, last in self.slice_drop_at:
            if sl < num_slices:
                hi = num_rounds if last == -1 else min(last + 1 - round_start, num_rounds)
                _window(live, sl, max(first - round_start, 0), hi)
        for sl, rnd, delay in self.slice_delay_at:
            if sl < num_slices:
                _window(live, sl, max(rnd - round_start, 0),
                        min(rnd + delay - round_start, num_rounds))
        if include_kills:
            for sl, rnd in self.kill_slice_at:
                if sl < num_slices:
                    _window(live, sl, max(rnd - round_start, 0), num_rounds)
        return live

    def kill_round_for_slice(self, slice_id: int) -> int | None:
        """The earliest ``kill_slice_at`` round of ``slice_id``, or None."""
        rounds = [r for sl, r in self.kill_slice_at if sl == slice_id]
        return min(rounds) if rounds else None

    def injects_faults(self) -> bool:
        """Whether the plan perturbs training rounds (drops, flaky sites,
        NaN, stragglers): a kill-only plan needs no per-round masks."""
        return bool(self.drop) or self.flaky_prob > 0.0 or bool(self.nan_at) or bool(self.delay_at)

    def injects_slice_faults(self, include_kills: bool = True) -> bool:
        """Whether the plan perturbs the slice tier."""
        return bool(self.slice_drop_at or self.slice_delay_at
                    or (include_kills and self.kill_slice_at))

    # -- JSON (the CLI's --faults) ---------------------------------------

    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return {k: [list(t) for t in v] if isinstance(v, tuple) else v for k, v in out.items()}

    @classmethod
    def from_json(cls, spec) -> "FaultPlan":
        """Build from a dict or a JSON string."""
        if isinstance(spec, (str, bytes)):
            spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(f"FaultPlan spec must be a JSON object, got {type(spec)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown FaultPlan keys {sorted(unknown)} (have {sorted(known)})")
        return cls(**spec)


def _read_plan(cls, arg: str | None):
    """A plan from the CLI's flag: inline JSON, ``@path`` or a bare path
    to a JSON file; None for no flag."""
    if not arg:
        return None
    if arg.startswith("@"):
        with open(arg[1:]) as fh:
            return cls.from_json(fh.read())
    if os.path.exists(arg):
        with open(arg) as fh:
            return cls.from_json(fh.read())
    return cls.from_json(arg)


def parse_fault_plan(arg: str | None) -> FaultPlan | None:
    """Parse the ``--faults`` flag: inline JSON, or ``@path`` to a JSON file."""
    return _read_plan(FaultPlan, arg)


def fault_window(plan: FaultPlan | None, num_sites: int, round0: int, rounds: int):
    """The masks of the global round window ``[round0, round0 + rounds)``:
    ``(liveness, nan_mask)``, or ``(None, None)`` when the plan injects
    nothing. Both pipelines take their window from here."""
    if plan is None or not plan.injects_faults():
        return None, None
    return plan.liveness(num_sites, round0, rounds), plan.nan_mask(num_sites, round0, rounds)


def slice_fault_window(plan: FaultPlan | None, num_slices: int, round0: int, rounds: int,
                       include_kills: bool = True):
    """The slice-tier mask of the round window, or None when there is no
    slice tier (one card) or no slice fault."""
    if plan is None or num_slices <= 1 or not plan.injects_slice_faults(include_kills):
        return None
    return plan.slice_liveness(num_slices, round0, rounds, include_kills=include_kills)


def poison_inputs(inputs: np.ndarray, nan_mask: np.ndarray, local_iterations: int) -> np.ndarray:
    """NaN injection in the data layer: a copy of the epoch's inputs ``[S,
    steps, B, ...]`` with each poisoned (site, round) cell's
    ``local_iterations`` steps set to NaN, so that site's round gradient
    goes non-finite end to end."""
    if not nan_mask.any():
        return inputs
    out = np.array(inputs, copy=True)
    L = max(int(local_iterations), 1)
    for site, rnd in zip(*np.nonzero(nan_mask)):
        out[site, rnd * L:rnd * L + L] = np.nan
    return out
