"""The site mesh over processes: the port of the JAX package's
``parallel/mesh.py`` at one slice.

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

Backends: "nccl" needs one card a rank; "gloo" takes CPU and CUDA
tensors, so several ranks can share one card. The slice axis
(``sliced_site_mesh`` with more than one slice) is ROADMAP A11 (b), the
model axis (``model_axis_size > 1``) A11 (c): both raise.
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

    @property
    def shape(self) -> dict:
        """JAX's ``dict(mesh.shape)`` of a one-slice mesh."""
        return {SITE_AXIS: self.world, MODEL_AXIS: 1}

    @property
    def axis_names(self) -> tuple:
        return (SITE_AXIS, MODEL_AXIS)

    def axis(self, num_sites: int) -> PackedAxis:
        """The packed site axis of ``num_sites`` global sites on this mesh."""
        return PackedAxis(self.group, pack_factor(self, num_sites), self.world, self.rank)

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


def sliced_site_mesh(num_slices: int, sites_per_slice: int, sites_per_device: int = 1,
                     devices=None, model_axis_size: int = 1, device=None) -> SiteMesh:
    """One slice collapses to :func:`packed_site_mesh`, as in JAX; more are
    ROADMAP A11 (b)."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if num_slices != 1:
        raise NotImplementedError(f"sliced_site_mesh(num_slices={num_slices}) is not ported: "
                                  "ROADMAP A11 (b)")
    return packed_site_mesh(sites_per_slice, sites_per_device, devices, model_axis_size, device)


def slice_count(mesh) -> int:
    """Slices on ``mesh``: always 1 (more are ROADMAP A11 (b))."""
    return 1


def site_axis_of(mesh) -> str:
    """The axis a per-site array's leading dim lies on: ``site``."""
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
