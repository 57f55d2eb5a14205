"""Membership table: logical members floating over a fixed slot axis. The
port's own copy of the JAX package's ``robustness/membership.py``
(``MembershipError``, ``MembershipTable``).

The serving fleet (serving/fleet.py) keeps its replica slots in one: each
(re)start of a replica joins at a bumped GENERATION, the record that
incarnation N+1 started with fresh state, and the table's epoch bumps on
every transition. In the JAX package the same table maps training sites
onto the padded virtual-site axis of the elastic-rounds daemon; that
daemon and the slot-state helpers it uses (resetting and moving per-site
engine, health and privacy rows) are ROADMAP A10 (b).

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
