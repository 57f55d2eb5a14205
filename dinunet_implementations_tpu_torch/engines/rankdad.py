"""rankDAD, distributed-AD low-rank gradient compression: each site
factorizes every compressible gradient leaf to rank-r factors by power
iteration and ships the factors; the aggregate is the weighted mean of the
sites' rank-r reconstructions. The port of the JAX package's
``engines/rankdad.py``, with its wire codecs and its byzantine-robust
modes.

Per round: a dead site's gradient and weight are zeroed; the 1-D leaves
are a weighted f32 sum (``precision_bits`` does not touch them); the
compressible leaves, grouped by effective rank ``min(rank, m, n)``, are
factorized per site (one K7 launch a rank class on the card, see
``engines/lowrank.py``); ``P`` and ``Q·w_s`` are cast to the payload dtype (or, under a
``wire_quant`` codec, each site's factor goes through the codec's grid,
one scale a site); the reconstruction ``Σ_s P_s (w_s Q_s)ᵀ`` accumulates
in f32. With
``dad_warm_start`` the engine state holds each leaf's per-site subspace Ω
``[S, n, r]``, seeded at ``init`` with the cold-start draw
(``lowrank.default_omega``, so round one equals a cold start) and replaced
every round by the sites' unweighted ``Q``; the trainer freezes a dead
site's Ω for the round.

Robust modes (``robust_agg``): ``"norm_clip"`` clips each site's gradient
to ``robust_clip_mult`` times the live-weighted median site norm before
the factorization. ``"trimmed_mean"`` and ``"coordinate_median"`` still
factorize every site's leaves (K7 on the card); each site's unweighted
``P`` and ``Q`` are cast to the payload dtype, each site's rank-r
reconstruction ``P_s Q_sᵀ`` ``[S, m, n]`` is formed in the JAX
orientation and laid out as its leaf, and each coordinate is reduced over
the sites by the live-weighted trimmed mean or median; the dense leaves
are reduced the same way in f32, all of them with the reconstructions in
one sort.

Over a process group (``aggregate(..., axis=)``) each rank factorizes
its own ``[K]`` sites (K7 on the card: every member iterates on its own,
so the factors are those of the one-device round member for member), one
packed all-gather a rank class brings every site's factors to every rank
(JAX's ``site_all_gather_packed``), each rank reconstructs the same
aggregate over all ``S`` sites, and the dense leaves take one two-level
sum. Ω stays with the rank that owns its site. Over slices the gather is
hierarchical (the slice's block, then across slices, each site row
through the inter-slice codec when ``dcn_wire_quant`` sets one) and the
dense sum takes the fused or split form. The robust modes run with every
site on one device only.

Orientation: factors are taken in the JAX matrix layout. A leaf named in
``transposed`` is stored as the transpose of its JAX matrix (a port
``nn.Linear.weight`` ``[out, in]`` against the flax kernel ``[in, out]``):
the engine factorizes its transposed view, keeps Ω, P and Q in the JAX
orientation and transposes only the reconstruction back.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import (
    check_robust_agg,
    clip_site_gradients,
    payload_dtype,
    resolve_dcn_codec,
    resolve_wire_codec,
    robust_reduce_tree,
    site_all_gather_packed,
    site_weight_scale,
    weighted_tree_sum,
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
    default_omega,
    is_compressible,
    jax_leaf_shape,
    lowrank_rank_groups,
    subspace_iteration_grouped,
)


def make_rankdad(dad_reduction_rank: int = 10, dad_num_pow_iters: int = 5,
                 dad_tol: float = 1e-3, precision_bits="32", dad_warm_start: bool = True,
                 use_kernel: bool = True, transposed=(), wire_quant="none",
                 robust_agg="none", dcn_wire_quant="", secure_agg="off",
                 robust_trim_frac: float = 0.2, robust_clip_mult: float = 2.5,
                 wire_stochastic: bool = False) -> Engine:
    """The rankDAD engine. ``use_kernel=False`` runs the power iteration's
    plain version on any device (the reference the card's kernel path is
    held against); ``transposed`` names the leaves stored as the transpose
    of their JAX matrix (``weights.leaf_table(cfg).transposed``)."""
    refuse_secure_agg(secure_agg)
    codec = resolve_wire_codec(precision_bits, wire_quant, wire_stochastic)
    dcn = resolve_dcn_codec(precision_bits, wire_quant, dcn_wire_quant, wire_stochastic)
    ddtype = None if dcn is None else dcn.dtype
    check_robust_agg(robust_agg, robust_trim_frac)
    gather_mode = robust_agg in ("trimmed_mean", "coordinate_median")
    pdtype = payload_dtype(precision_bits)
    wdtype = codec.dtype
    # a bf16 wire also runs the power iteration's products in bf16;
    # "16-ieee" and "32" keep f32 math
    mm_dtype = torch.bfloat16 if pdtype == torch.bfloat16 else None
    transposed = frozenset(transposed)

    def rank_of(name, shape) -> int | None:
        js = jax_leaf_shape(name, shape, transposed)
        if not is_compressible(js):
            return None
        m, n = _matrix_shape(js)
        return min(dad_reduction_rank, m, n)

    def init(params: dict) -> dict:
        if not dad_warm_start:
            return {}
        oms = {}
        for name, p in params.items():
            r = rank_of(name, p.shape)
            oms[name] = (None if r is None else
                         default_omega(_matrix_shape(jax_leaf_shape(name, p.shape, transposed)), r,
                                       p.device))
        return {"omega": oms}

    def matrices(name, g):
        """A site-batched leaf ``[S, ...]`` as its JAX matrices ``[S, m, n]``
        (a view; transposed leaves keep their storage)."""
        g = g.contiguous()
        if name in transposed:
            return g.transpose(1, 2)
        return g.reshape(g.shape[0], *_matrix_shape(g.shape[1:]))

    def wire(x):
        """One site-batched factor as its wire carries it (f32)."""
        if codec.quant == "none":
            return x.to(pdtype).float()
        return codec.compress(x, batched=True)

    def aggregate(grads: dict, state: dict, weight, live=None, rnd=None, axis=None,
                  total=None):
        refuse_on_mesh(axis, robust_agg=robust_agg != "none")
        grads, weight = mask_dead_site(grads, weight, live)
        if robust_agg == "norm_clip":
            grads = clip_site_gradients(grads, weight, robust_clip_mult)
        scale = site_weight_scale(weight, axis, total)  # [S], or the rank's [K]
        # the gather modes' per-site payloads (dense leaves as they are,
        # compressible ones as each site's reconstruction), reduced per
        # coordinate in one sort once every class is factorized
        out, gathered, dense = {}, {}, {}
        classes: dict[int, list[str]] = {}
        for name, g in grads.items():
            r = rank_of(name, g.shape[1:])
            if r is not None:
                classes.setdefault(r, []).append(name)
            elif gather_mode:
                gathered[name] = g
            else:
                dense[name] = g
        # the 1-D leaves: the weighted f32 sum (over a group, one collective)
        out.update((k, v.to(grads[k].dtype))
                   for k, v in weighted_tree_sum(dense, scale, axis, dcn_wire=dcn).items())
        order = sorted(classes.items())
        omegas = state["omega"] if dad_warm_start else {}
        results = subspace_iteration_grouped(
            [([matrices(n, grads[n]) for n in names], r, [omegas.get(n) for n in names])
             for r, names in order],
            dad_num_pow_iters, dad_tol, matmul_dtype=mm_dtype, use_kernel=use_kernel)
        new_oms = dict(omegas)
        for (_, names), pqs in zip(order, results):
            # every factor of the class through the wire, then (over a
            # group) ONE gather of the class's [K, Σ(m + n), r] block
            parts = []
            for name, (P, Q) in zip(names, pqs):
                # next round's subspace guess: this round's per-site,
                # unweighted right factor
                new_oms[name] = Q
                # the robust modes ship the unweighted Q: the reducer weighs
                parts += [wire(P), wire(Q if gather_mode else Q * scale[:, None, None])]
            parts = site_all_gather_packed(parts, axis, dcn)
            for i, name in enumerate(names):
                g = grads[name]
                Pw, Qw = parts[2 * i].contiguous(), parts[2 * i + 1].contiguous()  # [S, m|n, r]
                if gather_mode:
                    G = torch.einsum("smr,snr->smn", Pw, Qw)
                    gathered[name] = G.mT if name in transposed else G.reshape(g.shape)
                elif name in transposed:
                    out[name] = torch.einsum("snr,smr->nm", Qw, Pw).to(g.dtype)
                else:
                    out[name] = torch.einsum("smr,snr->mn", Pw, Qw).reshape(g.shape[1:]).to(
                        g.dtype)
        if gathered:
            red = robust_reduce_tree(gathered, weight, robust_agg, robust_trim_frac)
            out.update((k, v.to(grads[k].dtype)) for k, v in red.items())
        agg = {name: out[name] for name in grads}
        return agg, ({"omega": new_oms} if dad_warm_start else state)

    def wire_shapes(grads, pack: int = 1) -> list:
        """JAX's model: one gather a rank class of the ``[pack, Σ(m + n),
        r]`` factors at the wire dtype, a dense f32 psum a 1-D leaf
        (``[pack, ...]`` gathers in the gather modes)."""
        groups, dense = lowrank_rank_groups(jax_shapes(grads, transposed), dad_reduction_rank)
        f32 = torch.float32
        return ([((pack, sum(m + n for m, n in mns), r), wdtype) for r, mns in groups]
                + [(((pack,) + s) if gather_mode else s, f32) for s in dense]
                + robust_gather_wire(pack, robust_agg))

    def dcn_wire_shapes(grads, pack: int = 1, sites_per_slice: int = 1) -> list:
        """JAX's inter-slice model: a rank class's slice block
        ``[sites_per_slice, Σ(m + n), r]`` (at the inter-slice codec's dtype,
        else the wire's), each dense leaf's slice partial (at the codec's
        dtype, else f32; a ``[sites_per_slice, ...]`` block in the gather
        modes)."""
        groups, dense = lowrank_rank_groups(jax_shapes(grads, transposed), dad_reduction_rank)
        dense_dtype = ddtype or torch.float32
        return ([((sites_per_slice, sum(m + n for m, n in mns), r), ddtype or wdtype)
                 for r, mns in groups]
                + [(((sites_per_slice,) + s) if gather_mode else s, dense_dtype)
                   for s in dense]
                + robust_gather_dcn_wire(sites_per_slice, robust_agg))

    return Engine("rankDAD", init, aggregate, wire_shapes=wire_shapes, wire_dtype=wdtype,
                  dcn_wire_shapes=dcn_wire_shapes, dcn_dtype=ddtype)
