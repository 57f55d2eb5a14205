"""Declarative byzantine-site attacks: the port of the JAX package's
``robustness/attacks.py``.

An :class:`AttackPlan` says, in *global round* coordinates, which sites
lie and how: their local training runs normally, but the gradient they
ship to the aggregation engine is transformed. Five families, each a list
of ``(site, first_round, last_round)`` windows (inclusive; ``-1`` means to
the end of training):

- ``sign_flip``: the site ships ``-g``;
- ``scale``: ``scale_factor · g`` (default 10×);
- ``noise``: ``g + noise_std · ε``, ε a fresh normal draw per (site,
  round, leaf);
- ``free_rider``: an all-zero gradient at the site's full example weight;
- ``collude``: every colluding site ships the SAME direction (one draw per
  round and leaf), scaled to ``collude_scale ×`` its own gradient norm.

:func:`attack_window` renders the plan into the epoch's ``[S, rounds]``
int32 code mask (0 = honest). :func:`make_attack_fn` builds the transform
the epoch applies to each site's finished round gradient, before the
engine (and before rankDAD's or powerSGD's compression).

The plan, the codes and the windows are the JAX package's, as numpy. The
transform works on a site-batched ``[S, ...]`` gradient dict. Its noise and
collusion draws come from ``torch.Generator``s seeded by a fixed integer
formula of (seed, site, round, leaf index) (:func:`draw_seed`), the leaf
index being the leaf's place in JAX's ``jax.tree.flatten`` order
(``weights.LeafTable.leaf_index``): a replay independent of how the
epochs are chunked and where a fit resumes. JAX draws from its own counter
keys, so the numbers differ; ``draw=`` takes any other source, which is
how the tests hand JAX's draws across.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.collectives import site_sq_norms
from .faults import _read_plan

# attack codes in the [S, rounds] mask (0 = honest); one attack a cell
ATTACK_NONE = 0
ATTACK_SIGN_FLIP = 1
ATTACK_SCALE = 2
ATTACK_NOISE = 3
ATTACK_FREE_RIDER = 4
ATTACK_COLLUDE = 5

#: field name -> code, in declaration order (the JSON surface)
ATTACK_FIELDS = {
    "sign_flip": ATTACK_SIGN_FLIP,
    "scale": ATTACK_SCALE,
    "noise": ATTACK_NOISE,
    "free_rider": ATTACK_FREE_RIDER,
    "collude": ATTACK_COLLUDE,
}


def _windows(rows, name: str) -> tuple:
    out = []
    for row in rows:
        row = tuple(int(v) for v in row)
        if len(row) != 3:
            raise ValueError(f"AttackPlan.{name} entries need (site, first_round, last_round) "
                             f"triples, got {row!r}")
        site, first, last = row
        if site < 0 or first < 0 or (last != -1 and last < first):
            raise ValueError(f"bad AttackPlan.{name} entry {row}")
        out.append(row)
    return tuple(out)


@dataclass(frozen=True)
class AttackPlan:
    """Deterministic byzantine-attack schedule in global-round coordinates."""

    sign_flip: tuple = ()  # (site, first_round, last_round) triples; -1 = forever
    scale: tuple = ()
    scale_factor: float = 10.0
    noise: tuple = ()
    noise_std: float = 1.0
    noise_seed: int = 0
    free_rider: tuple = ()
    collude: tuple = ()
    collude_seed: int = 0
    collude_scale: float = 5.0

    def __post_init__(self):
        for name in ATTACK_FIELDS:
            object.__setattr__(self, name, _windows(getattr(self, name), name))
        if float(self.noise_std) < 0.0:
            raise ValueError(f"AttackPlan.noise_std must be >= 0, got {self.noise_std}")
        # one attack a (site, round) cell: overlapping windows on one site
        # would make the mask depend on the order of the fields
        spans = [(site, first, last, name) for name in ATTACK_FIELDS
                 for site, first, last in getattr(self, name)]
        for i, (s, f, l, n) in enumerate(spans):
            for s2, f2, l2, n2 in spans[i + 1:]:
                if s != s2:
                    continue
                hi, hi2 = (np.inf if l == -1 else l), (np.inf if l2 == -1 else l2)
                if f <= hi2 and f2 <= hi:
                    raise ValueError(f"AttackPlan windows overlap on site {s}: {n}[{f}, {l}] vs "
                                     f"{n2}[{f2}, {l2}] — one attack per (site, round) cell")

    def codes(self, num_sites: int, round_start: int, num_rounds: int) -> np.ndarray:
        """``[num_sites, num_rounds]`` int32 attack codes of the round
        window ``[round_start, round_start + num_rounds)`` (0 = honest)."""
        mask = np.zeros((num_sites, num_rounds), np.int32)
        for name, code in ATTACK_FIELDS.items():
            for site, first, last in getattr(self, name):
                if site >= num_sites:
                    continue
                lo = max(first - round_start, 0)
                hi = num_rounds if last == -1 else min(last + 1 - round_start, num_rounds)
                if lo < hi:
                    mask[site, lo:hi] = code
        return mask

    def attacker_sites(self) -> tuple:
        """The distinct sites the plan ever attacks from, sorted."""
        return tuple(sorted({site for name in ATTACK_FIELDS for site, _, _ in getattr(self, name)}))

    def injects_attacks(self) -> bool:
        return any(getattr(self, name) for name in ATTACK_FIELDS)

    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return {k: [list(t) for t in v] if isinstance(v, tuple) else v for k, v in out.items()}

    @classmethod
    def from_json(cls, spec) -> "AttackPlan":
        """Build from a dict or a JSON string."""
        if isinstance(spec, (str, bytes)):
            spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(f"AttackPlan spec must be a JSON object, got {type(spec)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown AttackPlan keys {sorted(unknown)} (have {sorted(known)})")
        return cls(**spec)


def parse_attack_plan(arg: str | None) -> AttackPlan | None:
    """Parse the ``--attacks`` flag: inline JSON, or ``@path`` to a JSON file."""
    return _read_plan(AttackPlan, arg)


def attack_window(plan: AttackPlan | None, num_sites: int, round0: int, rounds: int):
    """The ``[S, rounds]`` code mask of the global round window ``[round0,
    round0 + rounds)``, or None when the plan attacks nothing. Both
    pipelines take their window from here."""
    if plan is None or not plan.injects_attacks():
        return None
    return plan.codes(num_sites, round0, rounds)


def draw_seed(kind: str, key: tuple) -> int:
    """The generator seed of one draw: ``kind`` "noise" with ``key =
    (noise_seed, site, round, leaf index)``, "collude" with ``key =
    (collude_seed, round, leaf index)``, and the privacy plane's "dp"
    (``(dp_seed, site, round, leaf index)``, privacy/dpsgd.py) and "pad"
    (``(seed, lo, hi, round, leaf index)``, privacy/secure_agg.py), folded
    by ``h = h·1000003 + k`` modulo 2**63 from a per-kind start."""
    h = {"noise": 1, "collude": 2, "dp": 3, "pad": 4}[kind]
    for k in key:
        h = (h * 1_000_003 + int(k)) % (1 << 63)
    return h


_GENERATORS = threading.local()


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` set to ``seed``: one a thread and
    device, re-seeded for each draw (``manual_seed`` resets its counter, so
    the draw is a fresh generator's), so that a draw makes no generator of
    its own."""
    cache = _GENERATORS.__dict__.setdefault("by_device", {})
    key = str(device)
    if key not in cache:
        cache[key] = torch.Generator(device=device)
    return cache[key].manual_seed(seed)


def default_draw(kind: str, key: tuple, shape, device) -> torch.Tensor:
    """A standard normal ``shape`` draw from a ``torch.Generator`` on
    ``device`` seeded with :func:`draw_seed`."""
    gen = seeded_generator(draw_seed(kind, key), device)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


def make_attack_fn(plan: AttackPlan, table=None, draw=default_draw):
    """The transform of ``plan`` over a site-batched gradient dict.

    Returns ``attack(grads, code, code_dev, rnd) -> grads``: ``grads`` maps
    each parameter's ``state_dict`` name to its ``[S, ...]`` round
    gradients (row ``s`` is site ``s``), ``code`` is the round's ``[S]``
    attack codes in host memory (numpy), read to pick the noise and
    collusion draws, ``code_dev`` the same codes on the gradients' device,
    which the gate reads (a copy from pageable host memory each round
    would wait for the device), and ``rnd`` the global round.

    ``table`` is the model's ``weights.LeafTable``: the leaf index of each
    draw and the leaves stored as the transpose of their JAX matrix (a
    draw is made in the JAX shape and transposed for them). Without one the
    leaves are indexed in the dict's order and none is transposed.
    ``draw(kind, key, shape, device)`` gives a draw (:func:`default_draw`;
    ``kind`` and ``key`` as for :func:`draw_seed`).

    As in JAX: sign-flip, scale and free-rider are one multiplicative gate
    per site (f32, cast back); noise then adds ``noise_std · ε`` to a noisy
    site's leaves; a colluding site's leaves become the round's shared
    direction ``d`` times ``collude_scale · ‖g‖ / ‖d‖``, with ``‖g‖`` over
    its gradient before any attack. A non-finite gradient stays
    non-finite."""
    has_scalework = bool(plan.sign_flip or plan.scale or plan.free_rider)

    def gate(c):
        """Each site's multiplier from its code, on the codes' device."""
        return torch.where(c == ATTACK_SIGN_FLIP, -1.0, torch.where(
            c == ATTACK_SCALE, float(plan.scale_factor),
            torch.where(c == ATTACK_FREE_RIDER, 0.0, 1.0))).float()

    def layout(grads):
        """Each leaf's JAX leaf index and whether it is stored transposed,
        in JAX's leaf order."""
        if table is None:
            return [(i, k, False) for i, k in enumerate(grads)]
        index, transposed = table.leaf_index, table.transposed
        return sorted(((index[k], k, k in transposed) for k in grads))

    def shaped(d, tr):
        return d.mT if tr else d

    def attack(grads: dict, code, code_dev, rnd: int) -> dict:
        code = np.asarray(code).astype(np.int64)
        S = code.shape[0]
        leaves = layout(grads)
        dev = next(iter(grads.values())).device
        out = dict(grads)
        if has_scalework and np.isin(code, (ATTACK_SIGN_FLIP, ATTACK_SCALE,
                                            ATTACK_FREE_RIDER)).any():
            mult = gate(code_dev)
            out = {k: (g.float() * mult.reshape((S,) + (1,) * (g.dim() - 1))).to(g.dtype)
                   for k, g in out.items()}
        for s in np.nonzero(code == ATTACK_NOISE)[0]:
            for i, k, tr in leaves:
                g = out[k]
                jshape = g.shape[1:][::-1] if tr else g.shape[1:]
                eps = shaped(draw("noise", (plan.noise_seed, s, rnd, i), jshape, dev), tr)
                g = g.clone()
                g[s] = g[s] + (plan.noise_std * eps).to(g.dtype)
                out[k] = g
        colluding = np.nonzero(code == ATTACK_COLLUDE)[0]
        if len(colluding):
            dirs, dsq = {}, torch.zeros((), device=dev)
            for i, k, tr in leaves:
                jshape = grads[k].shape[1:][::-1] if tr else grads[k].shape[1:]
                dirs[k] = shaped(draw("collude", (plan.collude_seed, rnd, i), jshape, dev), tr)
                dsq = dsq + dirs[k].square().sum()
            gsq = site_sq_norms(grads)
            mag = plan.collude_scale * gsq.sqrt() / torch.clamp(dsq.sqrt(), min=1e-30)
            for k, d in dirs.items():
                g = out[k].clone()
                for s in colluding:
                    g[s] = (d * mag[s]).to(g.dtype)
                out[k] = g
        return out

    return attack
