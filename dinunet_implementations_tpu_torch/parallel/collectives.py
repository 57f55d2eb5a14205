"""Cross-site reductions: the port of the JAX package's
``parallel/collectives.py``: the weighted mean, the wire codecs, the
byzantine-robust reducers and the site axis over processes, with its
slice tier.

In JAX these are ``psum``s over a site mesh or ``vmap`` axis. In the port
a site-batched value carries an explicit leading site axis. With every
site on one card (``axis=None``, JAX's ``mesh=None``) that axis is
``[S]`` and a reduction is a sum over it. Over a process group (a
:class:`PackedAxis`, parallel/mesh.py ``SiteMesh``) each rank holds its
contiguous ``[K]`` block of the ``S = W·K`` sites (virtual site ``d·K + j``
is row ``j`` of rank ``d``) and a reduction is two-level, as JAX's
:func:`two_level_psum`: a local sum over the rank's ``[K]``, then ONE
collective over the group on one flat buffer (:func:`flat_psum`), not
one a leaf. Gathers stack the ranks' blocks in the same global order.

Slices (a :class:`PackedAxis` with ``slices > 1``, parallel/mesh.py
``sliced_site_mesh``): the ranks lie slice-major, rank ``sl·P + p`` the
``p``-th of slice ``sl``'s ``P``, and a reduction grows JAX's third tier.
Tier 0 is the local sum over ``[K]``, tier 1 the intra-slice sum over the
slice's ``P`` ranks, tier 2 the inter-slice hop over the ranks of the same
``p`` across slices (:func:`three_level_psum`):

- ``dcn_wire=None``, the FUSED form: tiers 1 and 2 are ONE all-reduce
  over the whole group, the collective of the unsliced world, so its
  values are bit for bit those of the same world without slices. The
  bookkeeping sums (totals, losses, sync-BN) always take this form;
- a :class:`WireCodec`, the SPLIT form: the intra-slice all-reduce
  completes the slice's partial, the partial goes through the codec
  (one scale a payload), and the inter-slice all-reduce ships it.

Gathers under slices are hierarchical: the intra-slice gather assembles
the slice's block, which crosses the inter-slice hop (through the codec,
one scale a site row, when one is set) in the same slice-major site
order. :data:`COLLECTIVES` counts the inter-slice hops apart
(``dcn_all_reduce``, ``dcn_all_gather`` and ``dcn_elements``, the elements
a rank sends across them).

``precision_bits`` payload casts: ``"16"`` is bfloat16, ``"16-ieee"`` the
reference's IEEE fp16, ``"32"`` f32. The weighted mean accumulates in f32
and is cast back to the payload dtype before :func:`payload_uncast`, as
the JAX ``site_weighted_mean`` does, so a 16-bit wire rounds both each
site's payload and the mean.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_PAYLOAD_DTYPES = {
    "32": torch.float32, 32: torch.float32,
    "16": torch.bfloat16, 16: torch.bfloat16,
    "16-ieee": torch.float16,
}


def payload_dtype(precision_bits="32") -> torch.dtype:
    """Resolve the ``precision_bits`` flag to the payload dtype."""
    return _PAYLOAD_DTYPES[precision_bits]


def per_site(v, like):
    """A per-site ``[S]`` vector (or any ``[S, ...]`` prefix) shaped to
    broadcast against an ``[S, ...]`` leaf."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def site_weight_scale(weight, axes=None, total=None):
    """Per-site normalized weight ``w_s / Σ w`` over ``weight [S]``, or over
    a group's ``[K]`` blocks (``axes``, a :class:`PackedAxis`: the total
    spans every rank); an all-zero round gives scale 0, which keeps
    updates finite. ``total``, when the caller has already summed ``Σ w``
    over every site, saves the collective."""
    w = weight.float()
    if total is None:
        total = psum(w.sum(), axes)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12), torch.zeros_like(w))


def payload_cast(tree: dict, precision_bits="32") -> dict:
    """Cast a gradient dict to the payload dtype before the reduction."""
    dtype = payload_dtype(precision_bits)
    return {k: g.to(dtype) for k, g in tree.items()}


def payload_uncast(tree: dict, like: dict) -> dict:
    """Restore each leaf's original dtype after the reduction."""
    return {k: g.to(like[k].dtype) for k, g in tree.items()}


def site_weighted_mean(tree: dict, weight, axes=None, wire_dtype=None, total=None,
                       dcn_wire=None) -> dict:
    """Example-count-weighted mean across sites: each site's ``[S, ...]``
    leaf contributes in proportion to ``weight [S]``, so the aggregate is
    the pooled-data gradient. Accumulates in f32 and casts back to each
    leaf's dtype. Over a group (``axes``) the rank's ``[K]`` partials go
    through ``wire_dtype`` and one collective (:func:`weighted_tree_sum`;
    over slices the split form when ``dcn_wire`` is a codec); ``total`` as
    :func:`site_weight_scale` (the total is a bookkeeping sum: fused)."""
    scale = site_weight_scale(weight, axes, total)
    agg = weighted_tree_sum(tree, scale, axes, wire_dtype, dcn_wire)
    return {k: agg[k].to(g.dtype) for k, g in tree.items()}


# ---------------------------------------------------------------------------
# byzantine-robust reducers over the site axis
# ---------------------------------------------------------------------------

#: the accepted ``robust_agg`` values. "none" is the weighted mean;
#: "norm_clip" clips each site's gradient norm to ``robust_clip_mult`` times
#: the live-weighted median site norm before the same weighted mean;
#: "trimmed_mean" and "coordinate_median" reduce each coordinate over the
#: sites' payloads. On one card every site's payload is already at hand
#: (the leading ``[S]`` axis), so there is no gather.
ROBUST_AGGS = ("none", "norm_clip", "trimmed_mean", "coordinate_median")


def check_robust_agg(robust_agg: str, trim_frac: float = 0.2) -> None:
    """JAX's ``ValueError`` for an unknown mode, and for a trimmed mean
    whose ``trim_frac`` is outside [0, 0.5)."""
    if robust_agg not in ROBUST_AGGS:
        raise ValueError(f"robust_agg must be one of {ROBUST_AGGS}, got {robust_agg!r}")
    if robust_agg == "trimmed_mean" and not 0.0 <= float(trim_frac) < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")


def _sorted_site_axis(vals, weight):
    """Sort ``vals [S, ...]`` along the site axis per coordinate (stably,
    as ``jnp.argsort``) and carry each site's weight with the permutation.
    Returns ``(v_sorted, w_sorted, cum, total)``: ``cum`` the inclusive
    cumulative weight in sorted order, ``total`` its last row."""
    v_sorted, order = torch.sort(vals, dim=0, stable=True)
    w = per_site(weight.float(), vals).expand_as(vals)
    w_sorted = torch.gather(w, 0, order)
    cum = torch.cumsum(w_sorted, dim=0)
    return v_sorted, w_sorted, cum, cum[-1:]


def weighted_trimmed_mean(vals, weight, trim_frac: float):
    """Per-coordinate weighted trimmed mean over the leading site axis:
    ``trim_frac`` of the total live weight dropped from each tail, each
    sorted entry contributing the overlap of its weight interval with the
    kept band (exact for fractional trims; a dead site, weight 0, never
    shifts the band). A coordinate with no live weight reduces to 0."""
    if not 0.0 <= float(trim_frac) < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
    v_sorted, w_sorted, cum, total = _sorted_site_axis(vals, weight)
    t = np.float32(trim_frac)  # the f32 products of JAX's band
    lo, hi = total * float(t), total * float(np.float32(1.0) - t)
    keep = torch.clamp(torch.minimum(cum, hi) - torch.maximum(cum - w_sorted, lo), min=0.0)
    out = (keep * v_sorted).sum(0) / torch.clamp(keep.sum(0), min=1e-12)
    return torch.where(total[0] > 0, out, torch.zeros_like(out))


def weighted_coordinate_median(vals, weight):
    """Per-coordinate weighted (lower) median over the leading site axis:
    the sorted value whose cumulative weight interval holds half the total
    live weight. A dead site is never picked; a coordinate with no live
    weight reduces to 0."""
    v_sorted, w_sorted, cum, total = _sorted_site_axis(vals, weight)
    mid = 0.5 * total
    keep = ((cum - w_sorted < mid) & (cum >= mid) & (w_sorted > 0)).float()
    out = (keep * v_sorted).sum(0) / torch.clamp(keep.sum(0), min=1.0)
    return torch.where(total[0] > 0, out, torch.zeros_like(out))


def robust_site_reduce(vals, weight, mode: str, trim_frac: float = 0.2):
    """One ``[S, ...]`` payload through the robust reducer ``mode``."""
    if mode == "trimmed_mean":
        return weighted_trimmed_mean(vals, weight, trim_frac)
    if mode == "coordinate_median":
        return weighted_coordinate_median(vals, weight)
    raise ValueError(f"unknown robust site reducer {mode!r}")


def site_flat(tree: dict):
    """A site-batched dict ``{name: [S, ...]}`` as one f32 ``[S, N]``
    buffer, its leaves side by side in the dict's order: the per-site
    norms, the clip and the robust reducers then take a few launches for
    the whole tree instead of a few a leaf."""
    S = next(iter(tree.values())).shape[0]
    return torch.cat([g.reshape(S, -1).float() for g in tree.values()], 1)


def site_unflat(flat, like: dict) -> dict:
    """:func:`site_flat` undone: ``flat [S, N]`` (or ``[N]``, a reduced
    buffer) back into ``like``'s leaves, each in its shape (without the
    site axis for ``[N]``) and dtype."""
    lead = flat.shape[:-1]
    parts = flat.split([g[0].numel() for g in like.values()], dim=-1)
    return {k: v.reshape(lead + g.shape[1:]).to(g.dtype)
            for (k, g), v in zip(like.items(), parts)}


def site_sq_norms(tree: dict):
    """Each site's ``Σ x²`` over a site-batched dict, in f32: ``[S]``."""
    flat = site_flat(tree)
    return (flat * flat).sum(1)


def robust_reduce_tree(tree: dict, weight, mode: str, trim_frac: float = 0.2) -> dict:
    """Every ``[S, ...]`` leaf of ``tree`` through the robust reducer
    ``mode`` in one sort of the site axis (:func:`site_flat`): each leaf's
    f32 reduction, in its shape without the site axis."""
    if not tree:
        return {}
    flat = robust_site_reduce(site_flat(tree), weight, mode, trim_frac)
    return site_unflat(flat, {k: g.float() for k, g in tree.items()})


def robust_clip_scales(nsq, weight, clip_mult: float):
    """The norm-clip defense's per-site scales: each site's squared
    gradient norm ``nsq [S]`` against ``clip_mult`` times the
    live-weighted median site norm (a hostile site cannot move a median it
    does not own). 1 for a site under the threshold."""
    med = weighted_coordinate_median(torch.sqrt(nsq.float()), weight)
    tau = med * float(np.float32(clip_mult))
    norm = torch.sqrt(nsq.float())
    return torch.where(norm > tau, tau / torch.clamp(norm, min=1e-30), torch.ones_like(norm))


def clip_site_gradients(grads: dict, weight, clip_mult: float) -> dict:
    """The norm-clip defense on site-batched gradients ``{name: [S,
    ...]}``: each site's whole tree scaled by :func:`robust_clip_scales`
    (f32, cast back). The weights are left alone: the weighted mean
    renormalizes as usual."""
    flat = site_flat(grads)
    scale = robust_clip_scales((flat * flat).sum(1), weight, clip_mult)
    return site_unflat(flat * scale[:, None], grads)


# ---------------------------------------------------------------------------
# quantized wire codecs
# ---------------------------------------------------------------------------

#: the accepted ``TrainConfig.wire_quant`` values: "none" keeps the
#: ``precision_bits`` wire, "bf16" forces a bf16 wire, "int8" and "fp8"
#: are the scale-per-payload codecs of :class:`WireCodec`
WIRE_QUANTS = ("none", "bf16", "int8", "fp8")

#: the largest finite float8_e4m3fn magnitude: the fp8 codec maps each
#: payload's amax onto it
FP8_E4M3_MAX = 448.0
#: the magnitude above which JAX's float8_e4m3fn cast gives NaN: values up
#: to it round to 448 (464 is the tie, which rounds to even), larger ones
#: and infinities overflow. torch's cast saturates to 448 instead.
_FP8_NAN_ABOVE = 464.0


def _mul32(h, c: int):
    """The low 32 bits of ``h · c`` for int64 ``h`` in [0, 2³²) and a
    32-bit constant ``c``, with every partial product under 2⁴⁹ (no int64
    overflow on any device)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + ((h * hi) & 0xFFFF) * 65536) & 0xFFFFFFFF


def _dither_uniform(v):
    """JAX's deterministic per-element uniform in [0, 1) for stochastic
    rounding: a murmur-style finalizer of the value's own f32 bits, bit
    for bit. JAX hashes in uint32; torch has no uint32 shifts on the CPU,
    so the hash runs in int64 with the low 32 bits kept after every
    multiply (:func:`_mul32`)."""
    h = v.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = _mul32(h, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).float() * (1.0 / (1 << 24))


def _payload_amax_scale(xf, batched: bool, grid_max: float):
    """The symmetric scale mapping a payload's amax onto ``grid_max``: one
    for the whole payload, or with ``batched=True`` one a row of the
    leading site axis. An all-zero (a dead site's) or non-finite amax
    takes scale 1.0, as in JAX."""
    a = xf.abs()
    if not batched:
        amax = a.max()
    elif a.dim() > 1:
        amax = a.amax(dim=tuple(range(1, a.dim())), keepdim=True)
    else:
        amax = a
    ok = amax.isfinite() & (amax > 0)
    # a tensor divisor, not a Python scalar: the CUDA kernel of a division
    # by a scalar multiplies by its reciprocal, one ulp from JAX's quotient
    return torch.where(ok, amax / torch.full_like(amax, float(np.float32(grid_max))),
                       torch.ones_like(amax))


@dataclass(frozen=True)
class WireCodec:
    """One wire codec, JAX's: a payload is rounded through the wire grid
    and restored to f32 (:meth:`compress`); the reduction then runs in
    f32. ``dtype`` is what one element costs on the wire (what
    ``wire_bytes`` counts): int8 and fp8 are one byte with one f32 scale a
    payload (not counted). ``stochastic`` (int8 only) rounds ``floor(v +
    u)`` with ``u`` from :func:`_dither_uniform`."""

    quant: str  # "none" | "bf16" | "int8" | "fp8"
    dtype: torch.dtype
    stochastic: bool = False

    def compress(self, x, batched: bool = False):
        """``x`` through the wire grid, f32 in and out; ``batched=True``
        scales each row of the leading site axis on its own."""
        xf = x.float()
        if self.quant == "none":
            return xf.to(self.dtype).float()
        if self.quant == "bf16":
            return xf.to(torch.bfloat16).float()
        if self.quant == "int8":
            scale = _payload_amax_scale(xf, batched, 127.0)
            v = xf / scale
            q = torch.floor(v + _dither_uniform(v)) if self.stochastic else torch.round(v)
            # the int8 grid as JAX's cast leaves it: a NaN (a non-finite
            # payload's) becomes 0 and -0 becomes +0 (``+ 0.0``); every other
            # clipped value is an integer, exact in f32
            q = torch.nan_to_num(torch.clamp(q, -127.0, 127.0), nan=0.0) + 0.0
            return q * scale
        if self.quant == "fp8":
            scale = _payload_amax_scale(xf, batched, FP8_E4M3_MAX)
            v = xf / scale
            q = v.to(torch.float8_e4m3fn).float()
            # JAX's cast overflows to NaN where torch's saturates
            q = torch.where(v.abs() > _FP8_NAN_ABOVE, float("nan"), q)
            q = torch.where(v.isnan() | v.isinf(), float("nan"), q)
            return q * scale
        raise ValueError(f"unknown wire codec {self.quant!r}")


def resolve_wire_codec(precision_bits="32", wire_quant: str = "none",
                       stochastic: bool = False) -> WireCodec:
    """``(precision_bits, TrainConfig.wire_quant)`` to the engines' wire
    codec, JAX's: "none" defers to ``precision_bits``; any other value sets
    the wire dtype only (the power iteration's products stay governed by
    ``precision_bits``). ``stochastic`` holds for int8 only."""
    if wire_quant not in WIRE_QUANTS:
        raise ValueError(f"wire_quant must be one of {WIRE_QUANTS}, got {wire_quant!r}")
    dtype = {"none": None, "bf16": torch.bfloat16, "int8": torch.int8,
             "fp8": torch.float8_e4m3fn}[wire_quant] or payload_dtype(precision_bits)
    return WireCodec(quant=wire_quant, dtype=dtype,
                     stochastic=bool(stochastic) and wire_quant == "int8")


def resolve_dcn_codec(precision_bits="32", wire_quant: str = "none", dcn_wire_quant: str = "",
                      stochastic: bool = False):
    """``TrainConfig.dcn_wire_quant`` to the inter-slice codec, JAX's:
    ``""`` (the default) follows ``wire_quant``, ``"none"`` is ``None``,
    the fused form (no rounding at the slice boundary). An axis of one
    slice never consults it: there is no slice tier to codec."""
    eff = dcn_wire_quant or wire_quant
    if eff == "none":
        return None
    return resolve_wire_codec(precision_bits, eff, stochastic)


def codec_payload(tree: dict, codec: WireCodec, precision_bits="32") -> dict:
    """Each site's payload of a site-batched dict on the wire: the
    ``precision_bits`` cast for the "none" codec (the dtype kept, as JAX's
    ``payload_cast``), else each site's row through the codec (f32)."""
    if codec.quant == "none":
        return payload_cast(tree, precision_bits)
    return {k: codec.compress(g, batched=True) for k, g in tree.items()}


# ---------------------------------------------------------------------------
# the site axis over processes
# ---------------------------------------------------------------------------

#: what the collectives of this process did since the counters were last
#: set to 0: the calls of each kind over the whole group or one slice and
#: the bytes they carried (a gather counts every rank's block); the
#: inter-slice hops of the split form and of the hierarchical gathers,
#: and the elements this rank sent across them
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "bytes": 0, "dcn_all_reduce": 0,
               "dcn_all_gather": 0, "dcn_elements": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True)
class PackedAxis:
    """The packed site axis over a process group: every payload carries a
    leading ``[pack]`` axis (the rank's K sites), and a reduction sums that
    axis locally before ONE collective over ``group``. ``group=None`` is a
    world of one with no group: the collective is the identity. The
    tensors stay on their device whatever the backend: gloo takes CUDA
    tensors for every collective used here (``all_reduce``, ``all_gather``,
    ``broadcast``; ``scripts/torch_gloo_cuda_probe.py`` checks it on the
    card).

    ``slices > 1`` (JAX's ``slice_name``) lays ``slices`` slices of ``world
    / slices`` ranks over the group, slice-major: ``slice_group`` is this
    rank's slice (None for one rank a slice, where the intra-slice tier is
    the identity) and ``cross_group`` the ranks of its place in every
    slice, the inter-slice hop (module docstring). They take the place of
    JAX's ``slice_name``; a FUSED reduction spans ``group`` (JAX's
    ``reduce_axes()``, ``(slice, site)``)."""

    group: object | None
    pack: int
    world: int = 1
    rank: int = 0
    slices: int = 1
    slice_group: object | None = None
    cross_group: object | None = None

    @property
    def per_slice(self) -> int:
        """P, the ranks of one slice."""
        return self.world // self.slices


def _all_reduce(buf, axes: PackedAxis, group=None, dcn: bool = False):
    """The sum of ``buf`` over ``group`` (default: the whole group), as a
    new tensor; ``dcn`` counts it as an inter-slice hop."""
    import torch.distributed as dist

    if dcn:
        COLLECTIVES["dcn_all_reduce"] += 1
        COLLECTIVES["dcn_elements"] += buf.numel()
    else:
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["bytes"] += buf.numel() * buf.element_size()
    group = axes.group if group is None else group
    if group is None:
        return buf.clone()
    t = buf.detach().contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


def _all_gather(x, axes: PackedAxis, group=None, size: int | None = None, dcn: bool = False):
    """Every rank's ``x [n, ...]`` of ``group`` (default: the whole group,
    ``size`` ranks) stacked in rank order: ``[size·n, ...]``."""
    import torch.distributed as dist

    size = axes.world if size is None else size
    if dcn:
        COLLECTIVES["dcn_all_gather"] += 1
        COLLECTIVES["dcn_elements"] += x.numel()
    else:
        COLLECTIVES["all_gather"] += 1
        COLLECTIVES["bytes"] += x.numel() * x.element_size() * size
    group = axes.group if group is None else group
    if group is None:
        return x.clone()
    t = x.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, 0)


def _flat(parts: list):
    return torch.cat([p.reshape(-1).float() for p in parts])


def _unflat(tot, parts: list) -> list:
    return [t.reshape(p.shape) for t, p in zip(tot.split([p.numel() for p in parts]), parts)]


def flat_psum(parts: list, axes: PackedAxis | None) -> list:
    """Several already-reduced local partials summed over the group in ONE
    collective: raveled into one f32 buffer, reduced, split back to each
    part's shape (f32). ``axes=None`` returns them as they are. Over
    slices this is the FUSED form: one all-reduce over every rank."""
    if axes is None or not parts:
        return list(parts)
    return _unflat(_all_reduce(_flat(parts), axes), parts)


def slice_psum(parts: list, axes: PackedAxis) -> list:
    """Tier 1 of the split form: the partials summed over this rank's
    slice in one collective (f32; as they are for one rank a slice)."""
    if axes.slice_group is None:
        return [p.float() for p in parts]
    return _unflat(_all_reduce(_flat(parts), axes, axes.slice_group), parts)


def dcn_psum(parts: list, axes: PackedAxis, dcn_wire: WireCodec) -> list:
    """Tier 2 of the split form (JAX's ``_dcn_hop``): each completed
    per-slice partial through the codec (one scale a partial), then ONE
    inter-slice all-reduce for all of them."""
    comp = [dcn_wire.compress(p) for p in parts]
    return _unflat(_all_reduce(_flat(comp), axes, axes.cross_group, dcn=True), comp)


def tree_psum(parts: list, axes: PackedAxis | None, dcn_wire=None, slice_live=None) -> list:
    """Rank partials (already through the intra-slice wire) summed over
    every site: one collective at one slice or in the fused form, tier 1
    then tier 2 in the split form (module docstring). ``slice_live``, this
    rank's slice's 0/1 gate, zeroes the partials before any cross-slice
    tier (after the intra-slice sum in the split form, as JAX's
    :func:`weighted_tree_sum`)."""
    if axes is None:
        return list(parts)
    sliced = axes.slices > 1
    if not sliced or dcn_wire is None:
        if sliced and slice_live is not None:
            parts = [p * slice_live for p in parts]
        return flat_psum(parts, axes)
    inner = slice_psum(parts, axes)
    if slice_live is not None:
        inner = [p * slice_live for p in inner]
    return dcn_psum(inner, axes, dcn_wire)


def psum(x, axes: PackedAxis | None):
    """One already-local value summed over the group (the identity for
    ``axes=None``)."""
    return x if axes is None else flat_psum([x], axes)[0]


def _through_wire(part, wire_dtype=None):
    """A rank's partial as its collective ships it: through ``wire_dtype``
    (a :class:`WireCodec`, a dtype, or None: as it is)."""
    if isinstance(wire_dtype, WireCodec):
        return wire_dtype.compress(part)
    if wire_dtype is not None:
        return part.to(wire_dtype).float()
    return part


def _pack_partial(x, wire_dtype=None):
    """Tier 0, JAX's ``_pack_partial``: the sum over the leading ``[K]``
    axis, then the partial through ``wire_dtype``."""
    return _through_wire(x.sum(0), wire_dtype)


def three_level_psum(x, axes: PackedAxis | None, wire_dtype=None, dcn_wire=None,
                     slice_live=None):
    """JAX's hierarchical reduction of one ``[K, ...]`` payload: tier 0 the
    local sum (the partial through ``wire_dtype``), then the fused or the
    split form over the slices (module docstring; at one slice the one
    collective of :func:`two_level_psum`). ``slice_live`` is this rank's
    slice's 0/1 gate (a 0-dim tensor or a float) on a sliced axis, as
    :func:`tree_psum` applies it: ``×1`` is exact and ``×0`` leaves the
    slice out."""
    part = _pack_partial(x, wire_dtype)
    return part if axes is None else tree_psum([part], axes, dcn_wire, slice_live)[0]


def two_level_psum(x, axes: PackedAxis, wire_dtype=None, dcn_wire=None):
    """The packed reduction of one ``[K, ...]`` payload: the local sum,
    the partial through ``wire_dtype``, one collective; on a sliced axis
    :func:`three_level_psum`'s tiers."""
    return three_level_psum(x, axes, wire_dtype, dcn_wire)


def weighted_site_sum(g, scale, axes: PackedAxis | None, wire_dtype=None, dcn_wire=None,
                      slice_live=None):
    """One leaf's ``Σ_s scale_s · g_s`` in f32: the site-batched ``g [K,
    ...]`` scaled by ``scale [K]``, through :func:`three_level_psum`."""
    gf = g.float()
    return three_level_psum(gf * per_site(scale, gf), axes, wire_dtype, dcn_wire, slice_live)


def weighted_tree_sum(tree: dict, scale, axes: PackedAxis | None, wire_dtype=None,
                      dcn_wire=None, slice_live=None) -> dict:
    """``Σ_s scale_s · g_s`` of every leaf of a site-batched dict in f32:
    the sum over ``[S]`` for ``axes=None``; over a group each leaf's local
    weighted partial (through ``wire_dtype``) and ONE collective for the
    whole tree; in the split form over slices one intra-slice and ONE
    inter-slice collective for the whole tree, each leaf's slice partial
    through ``dcn_wire`` on its own scale (:func:`tree_psum`)."""
    parts = {k: (g.float() * per_site(scale, g)).sum(0) for k, g in tree.items()}
    if axes is None:
        return parts
    parts = {k: _through_wire(p, wire_dtype) for k, p in parts.items()}
    return dict(zip(parts, tree_psum(list(parts.values()), axes, dcn_wire, slice_live)))


def site_all_gather(x, axes: PackedAxis | None, dcn_wire=None):
    """Every site's ``[K, ...]`` block to every rank: ``[S, ...]`` in global
    site order (as it is for ``axes=None``). On a sliced axis the gather is
    hierarchical: the slice's block over its ranks, then (through
    ``dcn_wire``, one scale a site row, when set) over the slices."""
    if axes is None:
        return x
    if axes.slices == 1:
        return _all_gather(x, axes)
    block = (x.clone() if axes.slice_group is None
             else _all_gather(x, axes, axes.slice_group, axes.per_slice))
    if dcn_wire is not None:
        block = dcn_wire.compress(block, batched=True)
    return _all_gather(block, axes, axes.cross_group, axes.slices, dcn=True)


def site_all_gather_packed(parts: list, axes: PackedAxis | None, dcn_wire=None) -> list:
    """ONE gather for a list of ``[K, k_i, ...]`` parts of one dtype and
    matching trailing dims: concatenated on axis 1, gathered, split back
    into ``[S, k_i, ...]`` views, JAX's packed factor exchange (two
    hierarchical hops over slices, :func:`site_all_gather`)."""
    if axes is None:
        return list(parts)
    sizes = [p.shape[1] for p in parts]
    gathered = site_all_gather(torch.cat(parts, 1) if len(parts) > 1 else parts[0], axes,
                               dcn_wire)
    return list(gathered.split(sizes, dim=1))


def site_index(axes: PackedAxis | None = None) -> int:
    """The global index of the first site of this rank's block."""
    return 0 if axes is None else axes.rank * axes.pack


def site_count(axes: PackedAxis | None, local: int | None = None) -> int:
    """The global site count: ``W · K`` over a group, ``local`` (the
    ``[S]`` axis's length) for ``axes=None``."""
    return local if axes is None else axes.world * axes.pack
