"""powerSGD, low-rank gradient compression with error feedback: the port
of the JAX package's ``engines/powersgd.py``, with its wire codecs and its
byzantine-robust modes.

Per round and per compressible leaf, on ``[S, ...]`` tensors (Vogels et
al., 2019):

    M_s = G_s + e_s                    (error feedback)
    P   = orth( Σ_s cast(M_s q_s · w_s) )
    q'  = Σ_s cast(M_sᵀ P · w_s)
    Ĝ   = P q'ᵀ                        (the aggregate, the same for every site)
    e_s = M_s − Ĝ                      (each site's residual, carried)

``cast`` is the wire: each site's payload rounds through the
``precision_bits`` dtype and back to f32 (or through the ``wire_quant``
codec's grid, one scale a site), and the sum runs in f32. With a
bf16 wire the two big products take bf16 operands and accumulate in f32
(``lowrank.lp_matmul``). ``orth`` is the shifted CholeskyQR2 of
``lowrank.orthonormalize_many``, one call for the leaves of one rank (JAX
orthonormalizes leaf by leaf; the result is each leaf's own either way).
The 1-D leaves are a weighted f32 sum. A dead site's gradient and weight
are zeroed before the products, so its ``M = e`` adds nothing; the
trainer freezes its ``q`` and ``e`` for the round.

Robust modes (``robust_agg``): ``"norm_clip"`` clips each site's incoming
gradient to ``robust_clip_mult`` times the live-weighted median site norm
before the error feedback (``e`` is the site's own state and stays
unclipped). ``"trimmed_mean"`` and ``"coordinate_median"`` replace both
weighted sums: ``P = orth(reduce_s cast(M_s q_s))`` and ``q' =
reduce_s cast(M_sᵀ P)``, each a per-coordinate live-weighted trimmed mean
or median of the sites' unweighted payloads, so a hostile site casts one
vote in the shared subspace; the 1-D leaves are reduced the same way in
f32.

The state of one site is ``{"q": {name: [n, r] or None}, "e": {name: [m,
n] or None}}``; the trainer stacks it per site. ``q`` stays per site
(``[S, n, r]``), as JAX's vmap keeps it: after a round with every site
live all rows are equal, but a frozen dead site's row then differs.

Over a process group (``aggregate(..., axis=)``) both sums are two-level,
as JAX's packed axis: each rank's partial over its ``[K]`` sites goes
through the wire (the payload dtype, or the codec; not each site's
payload, as JAX's packed form) and every leaf's partial, the dense ones
too, is summed over the group in one collective a sum. ``P``, ``q'`` and
the aggregate are then the same on every rank; each site's ``e`` stays
on the rank that owns the site. Over slices each sum takes the fused
form, or the split form with every leaf's slice partial through the
inter-slice codec (``dcn_wire_quant``): two inter-slice hops a round, P
and then q', which depends on the orthonormalized P. The robust modes
run with every site on one device only.

Orientation: factors are taken in the JAX matrix layout. A leaf named in
``transposed`` (a port ``nn.Linear.weight`` ``[out, in]``, the transpose of
the flax kernel) is factorized through its transposed view; ``q`` and ``e``
stay in the JAX orientation, so checkpoints cross both ways, and only
``Ĝ`` is transposed back.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import (
    _through_wire,
    check_robust_agg,
    clip_site_gradients,
    payload_dtype,
    per_site,
    resolve_dcn_codec,
    resolve_wire_codec,
    robust_reduce_tree,
    site_weight_scale,
    tree_psum,
)
from .base import (
    Engine,
    jax_shapes,
    mask_dead_site,
    refuse_on_mesh,
    refuse_secure_agg,
    robust_gather_dcn_wire,
    robust_gather_wire,
)
from .lowrank import (
    _matrix_shape,
    is_compressible,
    jax_leaf_shape,
    lowrank_rank_groups,
    lp_matmul,
    orthonormalize_many,
)


def default_q(seed: int, index: int, n: int, r: int, device=None):
    """The first right factor ``Q [n, r]`` of the leaf at ``index`` (its
    place in the flattened JAX params tree), the same on every site: drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed·1000003 +
    index`` and moved to ``device``.

    JAX draws ``normal(fold_in(PRNGKey(seed), index), (n, r))``; the two
    generators give different numbers, so the port's first Q is a random
    init of its own, like its weights. Tests hand JAX's Q across as numpy."""
    gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + int(index))
    q = torch.randn((n, r), generator=gen, dtype=torch.float32)
    return q if device is None else q.to(device)


def make_powersgd(dad_reduction_rank: int = 10, precision_bits="32", seed: int = 0,
                  transposed=(), leaf_index=None, wire_quant="none", robust_agg="none",
                  dcn_wire_quant="", secure_agg="off", robust_trim_frac: float = 0.2,
                  robust_clip_mult: float = 2.5, wire_stochastic: bool = False) -> Engine:
    """The powerSGD engine at rank ``dad_reduction_rank``. ``transposed``
    names the leaves stored as the transpose of their JAX matrix
    (``weights.leaf_table(cfg).transposed``); ``leaf_index`` maps a leaf's
    name to its index in the flattened JAX params tree, the key of its
    first Q (``.leaf_index`` of the same table; default: the order of the
    params dict)."""
    refuse_secure_agg(secure_agg)
    codec = resolve_wire_codec(precision_bits, wire_quant, wire_stochastic)
    dcn = resolve_dcn_codec(precision_bits, wire_quant, dcn_wire_quant, wire_stochastic)
    ddtype = None if dcn is None else dcn.dtype
    check_robust_agg(robust_agg, robust_trim_frac)
    gather_mode = robust_agg in ("trimmed_mean", "coordinate_median")
    pdtype = payload_dtype(precision_bits)
    # a bf16 wire also runs the two big products in bf16; "16-ieee" and
    # "32" keep f32 math
    mm_dtype = torch.bfloat16 if pdtype == torch.bfloat16 else None
    transposed = frozenset(transposed)

    def init(params: dict) -> dict:
        qs, es = {}, {}
        for i, (name, p) in enumerate(params.items()):
            js = jax_leaf_shape(name, p.shape, transposed)
            if not is_compressible(js):
                qs[name] = es[name] = None
                continue
            m, n = _matrix_shape(js)
            index = i if leaf_index is None else leaf_index[name]
            qs[name] = default_q(seed, index, n, min(dad_reduction_rank, m, n), p.device)
            es[name] = torch.zeros((m, n), dtype=torch.float32, device=p.device)
        return {"q": qs, "e": es}

    # a rank's partial over a group crosses the wire as JAX's packed form
    # ships it: at the payload dtype, or through the codec
    group_wire = pdtype if codec.quant == "none" else codec

    def aggregate(grads: dict, state: dict, weight, live=None, rnd=None, axis=None,
                  total=None):
        refuse_on_mesh(axis, robust_agg=robust_agg != "none")
        grads, weight = mask_dead_site(grads, weight, live)
        if robust_agg == "norm_clip":
            grads = clip_site_gradients(grads, weight, robust_clip_mult)
        scale = site_weight_scale(weight, axis, total)  # [S], or the rank's [K]

        def wire(x):
            """Each site's ``[S, ...]`` payload as its wire carries it (f32);
            over a group the rank's partial goes through the wire instead."""
            if axis is not None:
                return x
            if codec.quant != "none":
                return codec.compress(x, batched=True)
            return x if pdtype == torch.float32 else x.to(pdtype).float()

        def reduce(payloads: dict, wired=()) -> dict:
            """Each of the sites' ``[S, ...]`` payloads to one: the sum of
            the weighted payloads, or the robust reducer of unweighted ones
            (every payload in one sort). Over a group: each rank's partial
            (through the wire for the names in ``wired``) and one
            collective."""
            if gather_mode:
                return robust_reduce_tree(payloads, weight, robust_agg, robust_trim_frac)
            parts = {k: p.sum(0) for k, p in payloads.items()}
            if axis is None:
                return parts
            parts = {k: _through_wire(p, group_wire) if k in wired else p
                     for k, p in parts.items()}
            return dict(zip(parts, tree_psum(list(parts.values()), axis, dcn)))

        # the robust modes' payloads are unweighted: the reducer weighs
        sc = 1.0 if gather_mode else scale[:, None, None]
        agg, qs, es, Ms, first = {}, {}, {}, {}, {}
        for name, g in grads.items():
            q, e = state["q"][name], state["e"][name]
            if q is None:
                first[name] = g.float() if gather_mode else g.float() * per_site(scale, g)
                qs[name] = es[name] = None
                continue
            # the JAX matrices [S, m, n]; transposed leaves through a view
            G = g.transpose(1, 2) if name in transposed else g.reshape(g.shape[0], *e.shape[1:])
            Ms[name] = M = G.float() + e
            first[name] = wire(lp_matmul(M, q, mm_dtype) * sc)  # [S, m, r]
        # the dense leaves' aggregates and the sketches [m, r]
        first = reduce(first, wired=Ms)
        sketches = {name: first[name] for name in Ms}
        agg.update((k, v.to(grads[k].dtype)) for k, v in first.items() if k not in Ms)
        # P of every leaf of one rank in one orthonormalization (each leaf's
        # own, as JAX's per-leaf orth): every M stays live until then, ~123 MB
        # at the flagship
        by_rank: dict[int, list[str]] = {}
        for name, sk in sketches.items():
            by_rank.setdefault(sk.shape[1], []).append(name)
        Ps = {}
        for names in by_rank.values():
            Ps.update(zip(names, orthonormalize_many([sketches[n] for n in names])))
        q_news = reduce({name: wire(lp_matmul(M.mT, Ps[name], mm_dtype) * sc)
                         for name, M in Ms.items()}, wired=Ms)  # [n, r]
        for name, M in Ms.items():
            g, P, q_new = grads[name], Ps[name], q_news[name]
            G_hat = P @ q_new.T
            es[name] = M - G_hat
            qs[name] = q_new.expand(g.shape[0], *q_new.shape).contiguous()
            rec = G_hat.T if name in transposed else G_hat.reshape(g.shape[1:])
            agg[name] = rec.contiguous().to(g.dtype)
        return ({k: agg[k] for k in grads},
                {"q": {k: qs[k] for k in grads}, "e": {k: es[k] for k in grads}})

    def wire_shapes(grads, pack: int = 1) -> list:
        """JAX's model: two psums a compressible leaf, ``P [m, r]`` and
        ``Q [n, r]`` at the wire dtype, a dense f32 psum a 1-D leaf; the
        gather modes ship each as a ``[pack, ...]`` block."""
        groups, dense = lowrank_rank_groups(jax_shapes(grads, transposed), dad_reduction_rank)
        lead = (pack,) if gather_mode else ()
        out = [(lead + (d, r), codec.dtype) for r, mns in groups for m, n in mns
               for d in (m, n)]
        return (out + [(lead + s, torch.float32) for s in dense]
                + robust_gather_wire(pack, robust_agg))

    def dcn_wire_shapes(grads, pack: int = 1, sites_per_slice: int = 1) -> list:
        """JAX's inter-slice model: two hops a compressible leaf, P's slice
        partial ``[m, r]`` and q''s ``[n, r]`` (at the inter-slice codec's
        dtype, else the wire's; ``[sites_per_slice, ...]`` blocks in the
        gather modes), each dense leaf's slice partial (the codec's dtype,
        else f32)."""
        groups, dense = lowrank_rank_groups(jax_shapes(grads, transposed), dad_reduction_rank)
        lead = (sites_per_slice,) if gather_mode else ()
        out = [(lead + (d, r), ddtype or codec.dtype) for r, mns in groups for m, n in mns
               for d in (m, n)]
        return (out + [(lead + s, ddtype or torch.float32) for s in dense]
                + robust_gather_dcn_wire(sites_per_slice, robust_agg))

    return Engine("powerSGD", init, aggregate, wire_shapes=wire_shapes, wire_dtype=codec.dtype,
                  dcn_wire_shapes=dcn_wire_shapes, dcn_dtype=ddtype)
