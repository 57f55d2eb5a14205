"""Session-slot cache: O(1) recurrent state for streaming inference. The
port's own copy of the JAX package's ``serving/session.py``.

Logical STREAMING SESSIONS float over a fixed ``[slots]`` device-resident
carry table, so the streaming step has one shape for the life of the
server and a returning stream ships only its NEW timesteps. Two halves:

- :class:`SessionTable`: host-side bookkeeping (session id → slot, LRU
  eviction, generation counters). NOT internally locked: the stream lane's
  dispatch thread (resolve) and the caller's thread (close_session, the
  summary) both touch it, and the engine serializes every access under
  its ``_session_lock``. Sessions reach the device only as gathered slot
  indices and a ``fresh`` reset gate.
- :func:`init_carry_table`: the device-resident ``[slots+1, …]`` tensors
  the streaming step gathers and scatters by slot index ON THE DEVICE:
  per-session ``(h, c)`` LSTM carry plus the accumulated mean-pool state
  (models/icalstm.py ICALstmStream). Row ``slots`` is the TRASH row:
  padded request slots in a partly filled batch point there, so their
  (identity) scatter writes can never land on a live session.

Every (re)assignment of a slot bumps the session's generation, and a fresh
assignment zeroes the carry inside the step (the ``fresh`` gate): a session
resumed after eviction can never resurrect another session's (or its own
stale) recurrent state. The generation in the result is the client's
signal that the server restarted its stream.
"""

from __future__ import annotations

import torch


class SessionError(ValueError):
    """An invalid session operation (unknown close, zero capacity)."""


class SessionTable:
    """Host-side session id → carry-table slot map with LRU eviction."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise SessionError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.slots: list = [None] * capacity  # session id | None
        self.generations = [0] * capacity  # current occupant's generation
        self._known: dict = {}  # session id -> last generation (join history)
        self._last_used = [0] * capacity  # LRU tick per slot
        self._tick = 0
        self.evictions = 0

    @property
    def trash_slot(self) -> int:
        """The carry-table row padded request slots scatter into — one past
        the last real slot (:func:`init_carry_table` allocates it)."""
        return self.capacity

    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def slot_of(self, session_id: str):
        try:
            return self.slots.index(session_id)
        except ValueError:
            return None

    def resolve(self, session_id: str) -> tuple:
        """``(slot, generation, fresh)`` for a session, assigning (and, at
        capacity, LRU-evicting) as needed. ``fresh=True`` means the carry row
        must be zeroed before use (the streaming step's reset gate);
        an evicted-then-returning session comes back fresh at a bumped
        generation (its O(1) state was the thing evicted)."""
        if not session_id or not isinstance(session_id, str):
            raise SessionError("session id must be a non-empty string")
        self._tick += 1
        slot = self.slot_of(session_id)
        if slot is not None:
            self._last_used[slot] = self._tick
            return slot, self.generations[slot], False
        try:
            slot = self.slots.index(None)
        except ValueError:
            # LRU eviction: the least recently touched session loses its slot
            slot = min(range(self.capacity), key=lambda i: self._last_used[i])
            self.evictions += 1
        # per-SESSION generation: a rejoin (after close or eviction) comes
        # back at last + 1, the record that its O(1) carry restarted from
        # zero
        gen = self._known.get(session_id, 0) + 1
        self._known[session_id] = gen
        self.slots[slot] = session_id
        self.generations[slot] = gen
        self._last_used[slot] = self._tick
        return slot, gen, True

    def close(self, session_id: str) -> int:
        """Release a session's slot (its next resolve starts fresh)."""
        slot = self.slot_of(session_id)
        if slot is None:
            raise SessionError(f"unknown session {session_id!r}")
        self.slots[slot] = None
        return slot


def init_carry_table(capacity: int, hidden: int, device=None) -> dict:
    """A fresh ``[capacity + 1, …]`` carry table of f32 tensors on
    ``device``: LSTM ``h``/``c``, the accumulated pooled hidden sum, and the
    valid-timestep ``count``. The extra row is the trash slot
    (:attr:`SessionTable.trash_slot`)."""
    rows = capacity + 1
    return {
        "h": torch.zeros((rows, hidden), device=device),
        "c": torch.zeros((rows, hidden), device=device),
        "pooled": torch.zeros((rows, hidden), device=device),
        "count": torch.zeros((rows,), device=device),
    }
