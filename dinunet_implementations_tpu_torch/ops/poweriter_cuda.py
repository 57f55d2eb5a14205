"""The fused power iteration of one rank class: the CUDA kernel K7 for the
card, its plain PyTorch version beside it.

Counterpart of the JAX package's ``ops/poweriter_pallas.py``
(``_poweriter_kernel`` behind ``fused_subspace_iteration_grouped``). One
call factorizes every member of one rank class, ``G_l ≈ P_l Q_lᵀ``:
``P = cholqr2(G Ω)``, σ from the column norms of ``GᵀP``, refinements
``P = cholqr2(G (GᵀP))`` until the member's relative σ change is at most
``tol`` or it has made ``num_iters`` of them, and ``Q = GᵀP``.

Arguments: ``G`` is one stack ``[L, m, n]`` of f32 members, or a list of
such stacks (the shape buckets of one class, which share ``r``); each
stack may have any strides as long as one matrix axis is contiguous, so a
transposed view of a ``[L, n, m]`` tensor passes without a copy. ``om``
matches it with ``[L, n, r]`` warm starts (inner ``[n, r]`` contiguous; the
member axis may be a stride-0 broadcast). ``mm_dtype`` is None (f32
products) or ``torch.bfloat16`` (bf16 operands, f32 accumulation, the
``lowrank.lp_matmul`` policy). Returns ``(P, Q, trips)`` with ``P [L, m,
r]``, ``Q [L, n, r]`` per stack (lists for a list) and ``trips`` the int32
count of refinements each member made, in member order.

:func:`poweriter_fused` launches ``csrc/poweriter.cu`` once per call for
CUDA tensors and raises on anything it does not take, including a class
whose iterates do not fit in one block's shared memory; for CPU tensors,
and only for them, it runs :func:`poweriter_plain`. ``POWERITER_LAUNCHES``
counts kernel launches. :func:`k7_takes` is the shape gate by which the
engine sends a class the kernel does not take to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..engines.lowrank import _cholqr_multi, lp_matmul
from . import _build

#: K7 launches since the counter was last set to 0
POWERITER_LAUNCHES = 0

#: ranks the kernel is instantiated for (the iterates' columns live in registers)
MAX_RANK = 16
#: shape buckets one launch takes: their descriptors are kernel parameters
MAX_BUCKETS = 16
#: dynamic shared memory one block may use on an H100: the 232,448 bytes a
#: block may opt in to, less 4 KB for the kernel's static arrays (3,280
#: bytes at r = 16, as ptxas reports them)
SMEM_LIMIT = 232448 - 4096

_entry: list = []
_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel():
    """``(entry, error_string)`` of ``csrc/poweriter.cu``, built on first use."""
    if not _entry:
        lib = _build.load("poweriter")
        fn = lib.dn_poweriter
        fn.argtypes = [_I, ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, _I, ctypes.c_float,
                       _P, _P]
        fn.restype = _I
        lib.dn_error_string.argtypes = [_I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entry.append((fn, lib.dn_error_string))
    return _entry[0]


def _as_lists(G, om):
    single = torch.is_tensor(G)
    Gs, oms = ([G], [om]) if single else (list(G), list(om))
    if len(Gs) != len(oms):
        raise ValueError(f"{len(Gs)} G stacks for {len(oms)} omega stacks")
    return single, Gs, oms


def _plain_stack(G, om, num_iters: int, tol: float, mm_dtype):
    """The loop of ``_poweriter_kernel`` over one ``[L, m, n]`` stack: every
    member iterates while its own delta is above ``tol``, finished members
    are frozen, and ``trips`` counts each member's refinements."""
    G, om = G.float(), om.float()
    Gt = G.mT

    def mm(a, b):
        return lp_matmul(a, b, mm_dtype)

    P, _ = _cholqr_multi(mm(G, om))
    sig = torch.linalg.vector_norm(mm(Gt, P), dim=-2)  # [L, r]
    L = G.shape[0]
    delta = torch.full((L,), float("inf"), device=G.device)
    trips = torch.zeros(L, dtype=torch.int32, device=G.device)
    for _ in range(num_iters):
        active = delta > tol
        if not bool(active.any()):
            break
        P_cand, colnorms = _cholqr_multi(mm(G, mm(Gt, P)))
        sig_new = torch.sqrt(colnorms)  # ‖G Gᵀ p‖ ≈ σ² → σ scale
        delta_new = torch.linalg.vector_norm(sig_new - sig, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(sig, dim=-1), min=1e-12)
        P = torch.where(active[:, None, None], P_cand, P)
        sig = torch.where(active[:, None], sig_new, sig)
        delta = torch.where(active, delta_new, delta)
        trips += active.int()
    return P, mm(Gt, P), trips


def poweriter_plain(G, om, num_iters: int, tol: float, mm_dtype=None):
    """Plain PyTorch version of K7 on any device: the per-member loop of
    ``_poweriter_kernel``, LAPACK for the ``[r, r]`` Cholesky and
    triangular inverse (as the JAX package on the CPU)."""
    single, Gs, oms = _as_lists(G, om)
    outs = [_plain_stack(g, o, num_iters, tol, mm_dtype) for g, o in zip(Gs, oms)]
    Ps, Qs = [o[0] for o in outs], [o[1] for o in outs]
    trips = torch.cat([o[2] for o in outs])
    return (Ps[0], Qs[0], trips) if single else (Ps, Qs, trips)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"poweriter_fused: {what}")


def class_smem_bytes(shapes, r: int) -> int:
    """Dynamic shared memory of one launch: each block holds its member's
    iterates ``P [m, r]`` and ``GᵀP [n, r]`` in f32, sized for the class's
    largest ``m + n``."""
    return 4 * r * max(m + n for m, n in shapes)


def k7_takes(shapes, r: int) -> bool:
    """Whether K7 takes a rank class of rank ``r`` whose shape buckets are
    ``shapes`` (``[(m, n), ...]``, one per stack): a pure shape gate, the
    counterpart of the JAX package's ``class_fits_vmem``. A class that
    fails it is routed to :func:`poweriter_plain` by the caller before any
    launch (``engines/lowrank.py``); :func:`poweriter_fused` itself raises
    on it."""
    return (1 <= r <= MAX_RANK and 0 < len(shapes) <= MAX_BUCKETS
            and class_smem_bytes(shapes, r) <= SMEM_LIMIT)


def poweriter_fused(G, om, num_iters: int, tol: float, mm_dtype=None):
    """K7: one launch for the whole rank class, one thread block per
    member. Same arguments and returns as :func:`poweriter_plain`."""
    single, Gs, oms = _as_lists(G, om)
    if all(g.device.type == "cpu" for g in Gs + oms):
        return poweriter_plain(G, om, num_iters, tol, mm_dtype)
    dev = Gs[0].device
    _check(dev.type == "cuda" and all(a.device == dev for a in Gs + oms),
           "every G and omega stack must be on one CUDA device")
    _check(mm_dtype in (None, torch.bfloat16), f"mm_dtype must be None or bfloat16, got {mm_dtype}")
    _check(num_iters >= 0, f"num_iters must be >= 0, got {num_iters}")
    _check(0 < len(Gs) <= MAX_BUCKETS, f"{len(Gs)} G stacks, the kernel takes 1..{MAX_BUCKETS}")
    r = oms[0].shape[-1]
    _check(1 <= r <= MAX_RANK, f"rank {r} outside the kernel's 1..{MAX_RANK}")
    buckets, shapes, first = [], [], 0
    Ps, Qs = [], []
    for g, o in zip(Gs, oms):
        _check(g.dim() == 3 and g.dtype == torch.float32, f"G must be [L, m, n] float32, got "
               f"{tuple(g.shape)} {g.dtype}")
        L, m, n = g.shape
        _check(L >= 1 and r <= min(m, n), f"G {tuple(g.shape)} cannot take rank {r}")
        _check(g.stride(2) == 1 or g.stride(1) == 1,
               f"G {tuple(g.shape)} needs one matrix axis contiguous, strides {g.stride()}")
        _check(tuple(o.shape) == (L, n, r) and o.dtype == torch.float32,
               f"omega must be [{L}, {n}, {r}] float32, got {tuple(o.shape)} {o.dtype}")
        _check(o.stride(2) == 1 and o.stride(1) == r, "omega's [n, r] must be contiguous")
        P = torch.empty((L, m, r), dtype=torch.float32, device=dev)
        Q = torch.empty((L, n, r), dtype=torch.float32, device=dev)
        # the kernel's Bucket record: element strides, the members' blocks
        # first .. first + L - 1 (numbered within the launch)
        buckets.append([g.data_ptr(), *g.stride(), o.data_ptr(), o.stride(0), P.data_ptr(),
                        Q.data_ptr(), m, n, first, L])
        first += L
        shapes.append((m, n))
        Ps.append(P)
        Qs.append(Q)
    smem = class_smem_bytes(shapes, r)
    _check(smem <= SMEM_LIMIT, f"a class of rank {r} with m + n up to "
           f"{max(m + n for m, n in shapes)} needs {smem} bytes of shared memory a block, "
           f"over the {SMEM_LIMIT} this kernel may use")
    trips = torch.empty(first, dtype=torch.int32, device=dev)
    flat = (ctypes.c_longlong * (12 * len(buckets)))(*(v for b in buckets for v in b))
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        err = fn(0 if mm_dtype is None else 1, flat, len(buckets), r,
                 max(m + n for m, n in shapes), num_iters, tol, trips.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"poweriter kernel failed: {err_str(err).decode()} ({err})")
    global POWERITER_LAUNCHES
    POWERITER_LAUNCHES += 1
    return (Ps[0], Qs[0], trips) if single else (Ps, Qs, trips)

