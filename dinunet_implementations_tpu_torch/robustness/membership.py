"""Membership table: logical members floating over a fixed slot axis. The
port's own copy of the JAX package's ``robustness/membership.py``
(``MembershipError``, ``MembershipTable``).

The serving fleet (serving/fleet.py) keeps its replica slots in one: each
(re)start of a replica joins at a bumped GENERATION, the record that
incarnation N+1 started with fresh state, and the table's epoch bumps on
every transition. The elastic-rounds daemon (runner/fed_runner.py
``FedDaemon``) maps training sites onto its fixed slot axis with the same
table, and resets and moves each slot's per-site state rows (engine state,
health, staleness buffers, the overlap stash, a personalized head with its
optimizer row) with :func:`reset_slot_state` and :func:`move_slot_state`;
:func:`membership_rollup` is its summary.

Key invariants:

- **Slot assignment is dense-first**: a join takes the LOWEST free slot.
  :meth:`MembershipTable.rebalance` computes explicit moves when churn has
  fragmented occupancy across contiguous slot blocks.
- **Generation counters**: every (re)join of a member increments its
  generation, so a rejoining member never passes for its earlier
  incarnation.
- **Membership epochs**: every transition bumps ``epoch``.

The table is an immutable dataclass (transitions return new tables) and
host-side bookkeeping only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


class MembershipError(ValueError):
    """An invalid membership transition (duplicate join, unknown leave,
    table full)."""


@dataclass(frozen=True)
class MembershipTable:
    """Immutable logical-site → virtual-slot map (see module docstring)."""

    capacity: int  # S_max — the padded virtual-site axis width
    slots: tuple = ()  # [capacity] of site id | None (free)
    generations: tuple = ()  # [capacity] int — current occupant's generation
    known: tuple = ()  # sorted (site_id, last_generation) join history
    epoch: int = 0  # membership epoch; bumps on every transition

    def __post_init__(self):
        if self.capacity < 1:
            raise MembershipError(
                f"capacity must be >= 1, got {self.capacity}"
            )
        if not self.slots:
            object.__setattr__(self, "slots", (None,) * self.capacity)
            object.__setattr__(self, "generations", (0,) * self.capacity)
        if len(self.slots) != self.capacity or len(self.generations) != self.capacity:
            raise MembershipError(
                f"slots/generations length must equal capacity "
                f"({self.capacity}), got {len(self.slots)}/"
                f"{len(self.generations)}"
            )

    # -- queries ---------------------------------------------------------

    def slot_of(self, site_id: str) -> int | None:
        try:
            return self.slots.index(site_id)
        except ValueError:
            return None

    def members(self) -> dict:
        """``{site_id: slot}`` for every occupied slot."""
        return {s: i for i, s in enumerate(self.slots) if s is not None}

    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def occupancy(self) -> np.ndarray:
        """``[capacity]`` float32 mask: 1 = occupied. Multiplied into the
        per-round liveness mask, this is how membership reaches a program
        of fixed shapes."""
        return np.array(
            [0.0 if s is None else 1.0 for s in self.slots], np.float32
        )

    def generation_of(self, site_id: str) -> int:
        """Current (or, for a departed site, last) generation; 0 = never
        joined."""
        slot = self.slot_of(site_id)
        if slot is not None:
            return self.generations[slot]
        return dict(self.known).get(site_id, 0)

    def slice_of(self, slot: int, num_slices: int) -> int:
        """The mesh SLICE a slot lives on under an ``num_slices``-way sliced
        topology: the ``[capacity]`` virtual-site axis shards
        ``P((slice, site))`` slice-major, so slice ``i`` owns the contiguous
        slot band ``[i·cap/n, (i+1)·cap/n)``. A slice joining or leaving a
        run is therefore the same table transition as its band's sites
        joining/leaving — no new machinery, just more slots per event.
        ``num_slices <= 1`` is always slice 0 (the single-mesh case)."""
        if num_slices <= 1:
            return 0
        if self.capacity % num_slices:
            raise MembershipError(
                f"num_slices={num_slices} must divide capacity "
                f"({self.capacity})"
            )
        if not 0 <= slot < self.capacity:
            raise MembershipError(
                f"slot {slot} outside [0, {self.capacity})"
            )
        return slot // (self.capacity // num_slices)

    def placements(self, num_slices: int) -> dict:
        """``{site_id: (slice, slot)}`` for every occupied slot — the
        logical-site → (slice, slot) map under a sliced mesh."""
        return {
            s: (self.slice_of(i, num_slices), i)
            for i, s in enumerate(self.slots)
            if s is not None
        }

    def slice_occupancy(self, num_slices: int) -> list:
        """Occupied-slot count per slice (the per-slice membership gauges)."""
        counts = [0] * max(num_slices, 1)
        for i, s in enumerate(self.slots):
            if s is not None:
                counts[self.slice_of(i, num_slices)] += 1
        return counts

    # -- transitions (pure; each returns a NEW table) --------------------

    def join(self, site_id: str) -> tuple:
        """Admit ``site_id`` into the lowest free slot. Returns ``(table,
        slot, generation)``; a REJOIN (a site seen before) gets generation
        ``last + 1``: the record that state of a previous incarnation
        cannot resurrect."""
        if site_id is None or not str(site_id):
            raise MembershipError("site id must be a non-empty string")
        if self.slot_of(site_id) is not None:
            raise MembershipError(f"site {site_id!r} is already a member")
        try:
            slot = self.slots.index(None)
        except ValueError:
            raise MembershipError(
                f"membership table full ({self.capacity} slots); "
                f"cannot admit {site_id!r}"
            ) from None
        gen = dict(self.known).get(site_id, 0) + 1
        slots = list(self.slots)
        gens = list(self.generations)
        slots[slot] = site_id
        gens[slot] = gen
        known = dict(self.known)
        known[site_id] = gen
        table = dataclasses.replace(
            self, slots=tuple(slots), generations=tuple(gens),
            known=tuple(sorted(known.items())), epoch=self.epoch + 1,
        )
        return table, slot, gen

    def leave(self, site_id: str) -> tuple:
        """Release ``site_id``'s slot. Returns ``(table, freed_slot)``."""
        slot = self.slot_of(site_id)
        if slot is None:
            raise MembershipError(f"site {site_id!r} is not a member")
        slots = list(self.slots)
        gens = list(self.generations)
        slots[slot] = None
        gens[slot] = 0
        table = dataclasses.replace(
            self, slots=tuple(slots), generations=tuple(gens),
            epoch=self.epoch + 1,
        )
        return table, slot

    def rebalance(self, num_blocks: int) -> tuple:
        """Even out occupancy across ``num_blocks`` contiguous slot blocks
        (per-device packing granules). Returns ``(table, moves)`` with
        ``moves`` a list of ``(site_id, src_slot, dst_slot)`` the caller
        must mirror onto its per-slot state. Generations do NOT bump (the
        same incarnation keeps its warm state); the membership epoch bumps
        once when any move happens."""
        if num_blocks < 1 or self.capacity % num_blocks:
            raise MembershipError(
                f"num_blocks={num_blocks} must divide capacity "
                f"({self.capacity})"
            )
        k = self.capacity // num_blocks
        slots = list(self.slots)
        gens = list(self.generations)
        moves = []
        while True:
            counts = [
                sum(1 for s in slots[b * k:(b + 1) * k] if s is not None)
                for b in range(num_blocks)
            ]
            hi, lo = max(counts), min(counts)
            if hi - lo <= 1:
                break
            src_b = counts.index(hi)
            dst_b = counts.index(lo)
            src = next(
                i for i in range(src_b * k, (src_b + 1) * k)
                if slots[i] is not None
            )
            dst = next(
                i for i in range(dst_b * k, (dst_b + 1) * k)
                if slots[i] is None
            )
            moves.append((slots[src], src, dst))
            slots[dst], gens[dst] = slots[src], gens[src]
            slots[src], gens[src] = None, 0
        if not moves:
            return self, []
        table = dataclasses.replace(
            self, slots=tuple(slots), generations=tuple(gens),
            epoch=self.epoch + 1,
        )
        return table, moves

    # -- (de)serialization ----------------------------------------------

    def to_json(self) -> dict:
        return {
            "capacity": self.capacity,
            "slots": list(self.slots),
            "generations": list(self.generations),
            "known": [list(kv) for kv in self.known],
            "epoch": self.epoch,
        }

    @classmethod
    def from_json(cls, spec: dict) -> "MembershipTable":
        return cls(
            capacity=int(spec["capacity"]),
            slots=tuple(spec["slots"]),
            generations=tuple(int(g) for g in spec["generations"]),
            known=tuple((k, int(g)) for k, g in spec.get("known", [])),
            epoch=int(spec.get("epoch", 0)),
        )


# -- slot-state surgery: on the host, between epochs ---------------------------


def _set_row(tree, slot: int, row):
    """``tree``'s row ``slot`` set to ``row`` (a same-shaped tree, or a
    scalar for every leaf), leaf by leaf; None leaves stay None. Returns
    new tensors: the epoch may still hold the old ones."""
    if isinstance(tree, dict):
        return {k: _set_row(v, slot, row[k] if isinstance(row, dict) else row)
                for k, v in tree.items()}
    if tree is None:
        return None
    out = tree.clone()
    out[slot] = row
    return out


def reset_slot_state(state, slot: int, engine=None):
    """Fresh per-site rows for ``slot``, JAX's ``reset_slot_state``: the
    engine state re-initialized by ``engine.init`` on the current params
    (``engine=None`` keeps the rows, for an engine with empty state), the
    health counters zeroed, the staleness buffer emptied (weight 0, the
    never-deposited age), the overlap stash's row cleared (``valid`` 0)
    and a personalized head's row restarted from the CURRENT global head
    with a fresh optimizer row (zero moments and count). Called at every
    slot assignment, so a rejoining site starts its new generation clean;
    the cohort's privacy ledger (the trainer's accountant) is untouched, as
    ε belongs to the mechanism's history, not to a slot. Returns a new
    state; ``state`` is left as it was."""
    import dataclasses as dc

    from ..engines.base import ASYNC_NEVER_AGE

    personal = getattr(state, "personal", None)
    if engine is not None and state.engine_state:
        # under personalization the engine state covers the shared leaves
        shared = {k: v for k, v in state.params.items()
                  if personal is None or k not in personal["params"]}
        state = dc.replace(state, engine_state=_set_row(state.engine_state, slot,
                                                        engine.init(shared)))
    if state.health is not None:
        state = dc.replace(state, health=_set_row(state.health, slot, 0))
    if state.buffers is not None:
        bufs = state.buffers
        state = dc.replace(state, buffers={"grads": _set_row(bufs["grads"], slot, 0.0),
                                           "weight": _set_row(bufs["weight"], slot, 0.0),
                                           "age": _set_row(bufs["age"], slot, ASYNC_NEVER_AGE)})
    if getattr(state, "overlap", None) is not None:
        state = dc.replace(state, overlap=_set_row(state.overlap, slot, 0.0))
    if personal is not None:
        state = dc.replace(state, personal={
            "params": _set_row(personal["params"], slot,
                               {k: state.params[k] for k in personal["params"]}),
            "opt": _set_row(personal["opt"], slot, 0)})
    return state


def move_slot_state(state, src: int, dst: int, engine=None):
    """Copy every per-site row of slot ``src`` to ``dst`` (a rebalance: the
    same incarnation keeps its warm engine state, health, buffer, stash and
    personalized head at its new slot), then reset ``src``, as JAX's
    ``move_slot_state``."""
    import dataclasses as dc

    def mv(tree):
        if isinstance(tree, dict):
            return {k: mv(v) for k, v in tree.items()}
        if tree is None:
            return None
        out = tree.clone()
        out[dst] = tree[src]
        return out

    for key in ("engine_state", "health", "buffers", "overlap", "personal"):
        if getattr(state, key, None) is not None:
            state = dc.replace(state, **{key: mv(getattr(state, key))})
    return reset_slot_state(state, src, engine=engine)


def membership_rollup(table: MembershipTable, state=None, held_rounds: int = 0) -> dict:
    """The daemon's summary, JAX's ``membership_rollup``: slots occupied,
    the mean staleness of the occupied slots' buffers (None for a
    bulk-sync run or before any deposit), and the rounds the quorum held
    back."""
    from ..engines.base import ASYNC_NEVER_AGE

    mean_staleness = None
    buffers = getattr(state, "buffers", None) if state is not None else None
    if buffers is not None:
        ages = buffers["age"].cpu().numpy()
        occ = table.occupancy() > 0
        deposited = occ & (ages < ASYNC_NEVER_AGE)
        if deposited.any():
            mean_staleness = float(ages[deposited].mean())
    return {
        "slots_occupied": int(table.occupied),
        "capacity": int(table.capacity),
        "membership_epoch": int(table.epoch),
        "mean_staleness": mean_staleness,
        "held_rounds": int(held_rounds),
    }
