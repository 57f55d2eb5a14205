"""The multi-process runtime: the port of the JAX package's
``parallel/distributed.py``, over ``torch.distributed``.

:func:`distributed_init` joins a process group of ``num_processes`` ranks
at a coordinator address (``host:port``; rank 0 hosts the store).
Nothing on a machine tells a program of its cluster, so the address, the
world size and the rank are the caller's. The backend is explicit:
``"nccl"`` for CUDA devices, ``"gloo"`` for the CPU, or the caller's
choice (gloo also takes CUDA tensors, so several ranks can share one
card); the code never tries one backend and then uses another.

:func:`multihost_site_mesh` lays the site axis over the group's ranks
(parallel/mesh.py ``SiteMesh``); the placement helpers keep each rank's
own ``[K]`` block of a per-site array on its device, and
:func:`fetch_site_outputs` brings per-site outputs back to every rank.
:func:`multihost_sliced_site_mesh` lays slices over the group's ranks
(one rank a slice by default, JAX's one process a slice); the slice
liveness mask rides replicated (:func:`put_epoch_plan`).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from ..robustness.retry import RetryTimeout, with_retry
from .collectives import site_all_gather
from .mesh import SiteMesh, _mesh_device, _refuse_model_axis

_initialized = False

#: the whole join's wall-clock budget, retries included: a coordinator that
#: never comes up fails the worker in about two minutes
JOIN_DEADLINE_S = 120.0
#: one attempt's budget: the store's connect timeout
JOIN_ATTEMPT_TIMEOUT_S = 45.0
#: the group's collective timeout once joined: a dead peer becomes an error
#: in the survivors' next collective, not a hang
COLLECTIVE_TIMEOUT_S = 600.0


def default_backend(device=None) -> str:
    """``"nccl"`` for a CUDA device (the default device is the card),
    ``"gloo"`` for the CPU."""
    if device is None:
        return "nccl"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_init(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, device=None,
                     join_deadline_s: float | None = JOIN_DEADLINE_S,
                     join_timeout_s: float | None = JOIN_ATTEMPT_TIMEOUT_S) -> bool:
    """Join the process group, JAX's contract: ``False`` for one process
    (``num_processes`` None or 1 with no coordinator), ``True`` once a
    group of several is up; a second call is a no-op that returns ``True``.

    ``backend`` defaults from ``device`` (:func:`default_backend`). The
    join retries a refused connect under jittered backoff
    (robustness/retry.py) and fails fast: ``join_timeout_s`` bounds one
    attempt (the store's connect timeout), ``join_deadline_s`` the whole
    join; past either it raises (``RetryTimeout`` or the last error).
    Every failure leaves nothing initialized."""
    import torch.distributed as dist

    global _initialized
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if _initialized:
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs coordinator_address, num_processes and "
                         "process_id together (no cluster autodetection here)")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id must be in [0, {num_processes}), got {process_id}")
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got {coordinator_address!r}")
    attempt_s = join_timeout_s if join_timeout_s is not None else COLLECTIVE_TIMEOUT_S

    def attempt():
        # the store's connect waits at most one attempt's budget; the
        # group's collectives then wait COLLECTIVE_TIMEOUT_S
        store = dist.TCPStore(host, int(port), int(num_processes), int(process_id) == 0,
                              timeout=datetime.timedelta(seconds=attempt_s),
                              wait_for_workers=False)
        dist.init_process_group(backend, store=store, world_size=int(num_processes),
                                rank=int(process_id),
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))

    try:
        with_retry(attempt, attempts=3, base_delay=0.5,
                   retry_on=(RuntimeError, OSError, ConnectionError),
                   describe="torch.distributed.init_process_group",
                   deadline_s=join_deadline_s)()
    except (RuntimeError, OSError, RetryTimeout):
        _destroy()
        raise
    _initialized = True
    return True


def _destroy() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def distributed_shutdown() -> None:
    """Tear the group down and clear the flag, so a later
    :func:`distributed_init` joins again; a no-op when nothing is up. The
    flag clears even when the teardown raises."""
    global _initialized
    from .mesh import _SLICE_GROUPS

    try:
        _destroy()
    finally:
        _initialized = False
        _SLICE_GROUPS.clear()


def multihost_site_mesh(sites_per_process: int | None = None, model_axis_size: int = 1,
                        devices=None, device=None) -> SiteMesh:
    """The site mesh over every process of the group (a world of one
    without a runtime): ``sites_per_process`` sites a rank (default 1), on
    ``device`` (default: the rank's card, under either backend)."""
    import torch.distributed as dist

    _refuse_model_axis(model_axis_size)
    k = 1 if sites_per_process is None else int(sites_per_process)
    if k < 1:
        raise ValueError(f"sites_per_process must be >= 1, got {k}")
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), str(dist.get_backend())
        return SiteMesh(dist.group.WORLD, world, rank, _mesh_device(device, backend, rank),
                        backend, k)
    return SiteMesh(None, 1, 0, _mesh_device(device, None, 0), None, k)


def multihost_sliced_site_mesh(num_slices: int | None = None, sites_per_slice: int | None = None,
                               sites_per_device: int = 1, model_axis_size: int = 1,
                               devices=None, device=None) -> SiteMesh:
    """JAX's real-host ``(slice, site, model)`` mesh: the slice axis tiles
    the group's processes (parallel/mesh.py ``sliced_site_mesh``, one
    device a rank). ``num_slices`` defaults to the process count and must
    divide it; ``sites_per_slice`` to ``sites_per_device`` times the
    ranks of a slice; a slice's site-axis members must divide over its
    ranks. One process collapses to ``sliced_site_mesh`` (which needs a
    group for more than one slice), as JAX's does."""
    import torch.distributed as dist

    from .mesh import sliced_site_mesh

    _refuse_model_axis(model_axis_size)
    n_proc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if num_slices is None:
        num_slices = n_proc if n_proc > 1 else 1
    if sites_per_slice is None:
        sites_per_slice = sites_per_device * max(n_proc // max(num_slices, 1), 1)
    if n_proc == 1:
        return sliced_site_mesh(num_slices, sites_per_slice, sites_per_device, devices,
                                model_axis_size, device)
    if n_proc % num_slices:
        raise ValueError(f"num_slices={num_slices} must divide the process count ({n_proc}) — "
                         "slices are process granules over DCN")
    if sites_per_slice % sites_per_device:
        raise ValueError(f"sites_per_device={sites_per_device} must divide the per-slice site "
                         f"count ({sites_per_slice})")
    procs_per_slice = n_proc // num_slices
    site_members = sites_per_slice // sites_per_device
    if site_members % procs_per_slice:
        raise ValueError(f"{site_members} site-axis members per slice must divide over "
                         f"{procs_per_slice} processes per slice")
    per_proc_sites = site_members // procs_per_slice
    if per_proc_sites != 1:
        # a rank holds one device: its sites pack on it (K = sites_per_device
        # · per_proc_sites), the same slice-major site order
        sites_per_device *= per_proc_sites
    return sliced_site_mesh(num_slices, sites_per_slice, sites_per_device, devices,
                            model_axis_size, device)


def spans_processes(mesh) -> bool:
    """Whether ``mesh`` holds other processes' ranks."""
    return mesh is not None and mesh.world > 1


def put_site_batch(mesh, arr, dtype=None):
    """A host ``[S, ...]`` per-site array as this rank's ``[K, ...]`` block
    on its device (every process holds the whole array, as in JAX);
    ``mesh=None`` keeps all ``S`` rows (on the card)."""
    a = torch.as_tensor(np.ascontiguousarray(np.asarray(arr)))
    if dtype is not None:
        a = a.to(dtype)
    if mesh is None:
        from ..core.device import resolve_device

        return a.to(resolve_device())
    return a[mesh.block(a.shape[0])].contiguous().to(mesh.device)


def put_site_inventory(mesh, inventory, input_dtype=None):
    """The padded ``[S, N_max, ...]`` site inventory (data/api.py
    ``SiteInventory``) placed once a fit: this rank's ``[K]`` block of its
    inputs (cast to ``input_dtype``) and labels."""
    return (put_site_batch(mesh, inventory.inputs, input_dtype),
            put_site_batch(mesh, inventory.labels))


def put_replicated(mesh, arr, dtype=None):
    """A small host array, the whole of it, on the rank's device."""
    a = torch.as_tensor(np.ascontiguousarray(np.asarray(arr)))
    if dtype is not None:
        a = a.to(dtype)
    return a.to(mesh.device)


def put_epoch_plan(mesh, positions, live=None, poison=None, attack=None, slice_live=None):
    """One epoch's ``[S, steps, B]`` index plan and its ``[S, rounds]``
    masks, each as this rank's block, and the ``[num_slices, rounds]``
    slice-liveness mask whole (replicated: every rank reads its own
    slice's row and counts the live slices)."""
    return tuple(None if a is None else put_site_batch(mesh, a)
                 for a in (positions, live, poison, attack)) + (
        None if slice_live is None else (
            put_site_batch(None, slice_live) if mesh is None
            else put_replicated(mesh, slice_live)),)


def fetch_site_outputs(tree, mesh):
    """Per-site outputs (``[K, ...]`` blocks, a tensor or a dict of them)
    as host numpy ``[S, ...]`` on every rank: one all-gather a leaf."""
    axes = None if mesh is None else mesh.axis(mesh.world * next(
        iter(tree.values() if isinstance(tree, dict) else [tree])).shape[0])

    def one(t):
        return site_all_gather(t, axes).cpu().numpy()

    return {k: one(v) for k, v in tree.items()} if isinstance(tree, dict) else one(tree)
