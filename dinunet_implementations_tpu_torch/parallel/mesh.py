"""The site mesh over processes: the port of the JAX package's
``parallel/mesh.py``.

JAX lays its ``site`` axis over the devices of a ``jax.sharding.Mesh``.
The port lays it over the ranks of a ``torch.distributed`` process group:
a :class:`SiteMesh` is the group, its size W, this process's rank, the
rank's device and, when known, K, the sites a rank holds. ``S = W·K``
virtual sites pack K a rank in rank-major order: virtual site ``d·K + j``
is row ``j`` of rank ``d``'s ``[K]`` block, as JAX's device-major order.
Inside a rank the sites stay the port's leading ``[K]`` axis (parameters
as stride-0 views, the LSTM kernels folding sites into rows, as with
``mesh=None``); the engines reduce over the group in two levels
(parallel/collectives.py ``PackedAxis``).

Slices (:func:`sliced_site_mesh`, JAX's ``(slice, site, model)`` mesh):
the slice axis lies over the group's ranks slice-major. With ``n`` slices
of ``P`` ranks, rank ``sl·P + p`` is the ``p``-th rank of slice ``sl`` and
holds virtual sites ``(sl·P + p)·K + j``, JAX's order. The mesh carries
three groups: the whole group (the fused reductions), this rank's slice
(the intra-slice tier) and the ranks of its place ``p`` in every slice
(the inter-slice hop); every rank creates every sub-group, in one order.
One process has no devices to lay slices on: a sliced mesh needs a group.

Backends: "nccl" needs one card a rank; "gloo" takes CPU and CUDA
tensors, so several ranks can share one card. The model axis
(``model_axis_size > 1``) is ROADMAP A11 (c) and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collectives import PackedAxis

SITE_AXIS = "site"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"


@dataclass(frozen=True)
class SiteMesh:
    """One process's view of the site mesh: the process ``group`` (None
    for a world of one without a runtime), ``world`` ranks, this ``rank``,
    its ``device`` and the ``backend`` name; ``pack`` is K when the mesh was
    built for a site count (None: derived from the data, as JAX's
    :func:`pack_factor`)."""

    group: object | None
    world: int
    rank: int
    device: torch.device
    backend: str | None = None
    pack: int | None = None
    slices: int = 1
    slice_group: object | None = None
    cross_group: object | None = None

    @property
    def per_slice(self) -> int:
        """P, the ranks of one slice (the site axis's width)."""
        return self.world // self.slices

    @property
    def slice_id(self) -> int:
        """The slice this rank belongs to."""
        return self.rank // self.per_slice

    @property
    def shape(self) -> dict:
        """JAX's ``dict(mesh.shape)``: ``{"slice": n, "site": P, "model":
        1}`` over slices, ``{"site": W, "model": 1}`` at one slice."""
        if self.slices > 1:
            return {SLICE_AXIS: self.slices, SITE_AXIS: self.per_slice, MODEL_AXIS: 1}
        return {SITE_AXIS: self.world, MODEL_AXIS: 1}

    @property
    def axis_names(self) -> tuple:
        if self.slices > 1:
            return (SLICE_AXIS, SITE_AXIS, MODEL_AXIS)
        return (SITE_AXIS, MODEL_AXIS)

    def axis(self, num_sites: int) -> PackedAxis:
        """The packed site axis of ``num_sites`` global sites on this mesh."""
        return PackedAxis(self.group, pack_factor(self, num_sites), self.world, self.rank,
                          self.slices, self.slice_group, self.cross_group)

    def block(self, num_sites: int) -> slice:
        """This rank's rows of a ``[num_sites, ...]`` per-site array."""
        k = pack_factor(self, num_sites)
        return slice(self.rank * k, (self.rank + 1) * k)

    @property
    def coordinator(self) -> bool:
        """Rank 0: the one process that writes logs, checkpoints and
        telemetry files (JAX's ``_coordinator``)."""
        return self.rank == 0


def _refuse_model_axis(model_axis_size: int) -> None:
    if model_axis_size != 1:
        raise NotImplementedError(
            f"model_axis_size={model_axis_size} (the mesh's model axis: ring LSTM, ring "
            "attention) is not ported: ROADMAP A11 (c)")


def _group_view():
    """``(group, world, rank, backend)`` of the default process group, or
    a world of one when no runtime is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return (dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                str(dist.get_backend()))
    return None, 1, 0, None


def _mesh_device(device, backend, rank: int) -> torch.device:
    """The rank's device: the caller's, else the card of the rank's local
    index, whatever the backend (gloo takes CUDA tensors too). The CPU
    only when the caller says so; with no card and no device this raises
    (core/device.py), as a CUDA device with no card does."""
    from ..core.device import resolve_device

    if device is None and torch.cuda.is_available():
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    return dev


def packed_site_mesh(num_sites: int, sites_per_device: int = 1, devices=None,
                     model_axis_size: int = 1, device=None) -> SiteMesh:
    """A mesh for ``num_sites`` virtual sites packed ``sites_per_device``
    a rank, over the default process group (a world of one without a
    runtime). Raises, as JAX's, when the pack factor does not divide the
    site count or the mesh needs more ranks than the group has; a group
    with ranks left over raises too (an idle rank would stall its peers'
    collectives). ``devices`` is taken for JAX's signature: the group's
    ranks are the devices."""
    if sites_per_device < 1:
        raise ValueError(f"sites_per_device must be >= 1, got {sites_per_device}")
    if num_sites % sites_per_device:
        raise ValueError(f"sites_per_device={sites_per_device} must divide the virtual site "
                         f"count ({num_sites})")
    _refuse_model_axis(model_axis_size)
    group, world, rank, backend = _group_view()
    need = num_sites // sites_per_device
    if need > world:
        raise ValueError(f"need {need} devices for {need} sites × model={model_axis_size}, "
                         f"have {world}")
    if need < world:
        raise ValueError(f"{need} mesh sites on a group of {world} ranks leaves ranks without "
                         "sites: every rank of the group takes part in each round's collectives")
    return SiteMesh(group, world, rank, _mesh_device(device, backend, rank), backend,
                    sites_per_device)


def make_site_mesh(num_sites: int | None = None, devices=None, model_axis_size: int = 1,
                   device=None) -> SiteMesh:
    """One site a rank (JAX's ``make_site_mesh``): ``num_sites`` defaults
    to the group's size."""
    _refuse_model_axis(model_axis_size)
    if num_sites is None:
        num_sites = _group_view()[1]
    return packed_site_mesh(num_sites, 1, devices, model_axis_size, device)


#: the sub-groups of a sliced world, created once a process group:
#: ``(world group, slices) -> (slice groups, cross groups)``; cleared when
#: the group ends (parallel/distributed.py ``distributed_shutdown``)
_SLICE_GROUPS: dict = {}


def slice_groups(num_slices: int):
    """``(slice_group, cross_group)`` of this rank over the default group
    laid as ``num_slices`` slices: every rank creates every slice's group
    (None for one rank a slice: that tier is the identity) and every
    place's cross group, in one order, once a process group."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    per = world // num_slices
    key = (id(dist.group.WORLD), num_slices)
    if key not in _SLICE_GROUPS:
        inner = ([dist.new_group([sl * per + p for p in range(per)]) for sl in range(num_slices)]
                 if per > 1 else [None] * num_slices)
        cross = [dist.new_group([sl * per + p for sl in range(num_slices)]) for p in range(per)]
        _SLICE_GROUPS[key] = (inner, cross)
    inner, cross = _SLICE_GROUPS[key]
    return inner[rank // per], cross[rank % per]


def sliced_site_mesh(num_slices: int, sites_per_slice: int, sites_per_device: int = 1,
                     devices=None, model_axis_size: int = 1, device=None) -> SiteMesh:
    """JAX's three-tier ``(slice, site, model)`` mesh: ``num_slices``
    slices, each of ``sites_per_slice`` virtual sites packed
    ``sites_per_device`` a rank, over the default process group
    (slice-major, module docstring). One slice collapses to
    :func:`packed_site_mesh`, as in JAX. JAX's checks and messages; the
    group must hold exactly ``num_slices × sites_per_slice /
    sites_per_device`` ranks, and one process with no group raises naming
    the group it needs (there are no virtual devices to lay slices on)."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if sites_per_device < 1:
        raise ValueError(f"sites_per_device must be >= 1, got {sites_per_device}")
    if sites_per_slice % sites_per_device:
        raise ValueError(f"sites_per_device={sites_per_device} must divide the per-slice site "
                         f"count ({sites_per_slice})")
    if num_slices == 1:
        return packed_site_mesh(sites_per_slice, sites_per_device, devices, model_axis_size,
                                device)
    _refuse_model_axis(model_axis_size)
    per_slice = sites_per_slice // sites_per_device  # site-axis members a slice
    need = num_slices * per_slice * model_axis_size
    group, world, rank, backend = _group_view()
    if group is None:
        raise ValueError(f"sliced_site_mesh({num_slices}, {sites_per_slice}, {sites_per_device}) "
                         f"needs a process group of {need} ranks (parallel/distributed.py "
                         "distributed_init): one process has no devices to lay slices on")
    if need > world:
        raise ValueError(f"need {need} devices for {num_slices} slices × {per_slice} site-axis "
                         f"members × model={model_axis_size}, have {world}")
    if need < world:
        raise ValueError(f"{need} mesh sites on a group of {world} ranks leaves ranks without "
                         "sites: every rank of the group takes part in each round's collectives")
    inner, cross = slice_groups(num_slices)
    return SiteMesh(group, world, rank, _mesh_device(device, backend, rank), backend,
                    sites_per_device, num_slices, inner, cross)


def slice_count(mesh) -> int:
    """Slices on ``mesh`` (1 for a one-slice mesh and ``mesh=None``)."""
    return 1 if mesh is None else mesh.slices


def site_axis_of(mesh):
    """The axis a per-site array's leading dim lies on, JAX's: ``site`` at
    one slice; over slices the ``(slice, site)`` pair with width-1 tiers
    dropped (one of them alone as its name)."""
    if mesh is not None and mesh.slices > 1:
        shape = mesh.shape
        tiers = tuple(ax for ax in (SLICE_AXIS, SITE_AXIS) if shape[ax] > 1)
        if len(tiers) == 1:
            return tiers[0]
        return tiers or None
    return SITE_AXIS


def pack_factor(mesh, num_sites: int) -> int:
    """K, the sites a rank holds of ``num_sites``: ``num_sites`` itself for
    ``mesh=None`` (every site on one device); raises when the mesh's ranks
    do not divide the sites, or the count disagrees with the K the mesh
    was built for."""
    if mesh is None:
        return num_sites
    if num_sites % mesh.world:
        raise ValueError(f"{num_sites} virtual sites do not divide over the mesh's "
                         f"{mesh.world} site-axis members")
    k = num_sites // mesh.world
    if mesh.pack is not None and k != mesh.pack:
        raise ValueError(f"the mesh was built for {mesh.pack} sites a rank; {num_sites} sites "
                         f"over {mesh.world} ranks are {k}")
    return k


def host_mesh(num_sites: int, model_axis_size: int = 1) -> SiteMesh:
    """A CPU mesh of ``num_sites`` ranks (JAX's ``host_mesh``, the
    simulator's): the default process group under gloo, whose size must be
    ``num_sites``; K follows from the data (:func:`pack_factor`)."""
    _refuse_model_axis(model_axis_size)
    group, world, rank, backend = _group_view()
    if world != num_sites:
        raise ValueError(f"host_mesh({num_sites}) needs a process group of {num_sites} ranks, "
                         f"have {world} (parallel/distributed.py distributed_init)")
    if backend not in (None, "gloo"):
        raise ValueError(f"host_mesh runs on the CPU: the group's backend must be gloo, got "
                         f"{backend!r}")
    return SiteMesh(group, world, rank, torch.device("cpu"), backend)
