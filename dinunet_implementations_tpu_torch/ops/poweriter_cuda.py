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
and only for them, it runs :func:`poweriter_plain`. :func:`k7_takes` is the
shape gate of one launch; :func:`k7_launches` cuts a class into the
launches the kernel takes, or sends it to the plain version.

The launch takes one of two routes, chosen by :func:`k7_geometry` before
it, from shapes and strides alone: the staged route
(``poweriter_staged_kernel``: G streamed through a ring of shared-memory
stages filled by asynchronous copies, two blocks an SM, blocks numbered
largest member first) whenever the iterates and the ring fit half an SM's
shared memory and every member and row of G's row-major side is in whole
16-byte chunks; else the direct route (``poweriter_direct_kernel``, the first
design). ``POWERITER_LAUNCHES`` counts launches, ``POWERITER_STAGED_CALLS``
and ``POWERITER_DIRECT_CALLS`` the routes they took. :func:`k7_phase_profile`
reads the staged route's phase clock.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..engines.lowrank import _cholqr_multi, lp_matmul
from . import _build
from .lstm_cuda import device_limits

#: K7 launches since the counter was last set to 0
POWERITER_LAUNCHES = 0
#: K7 launches on the staged route / the direct route
POWERITER_STAGED_CALLS = 0
POWERITER_DIRECT_CALLS = 0

#: ranks the kernel is instantiated for (the iterates' columns live in registers)
MAX_RANK = 16
#: shape buckets one launch takes: their descriptors are kernel parameters
MAX_BUCKETS = 16
#: dynamic shared memory one block may use on an H100: the 232,448 bytes a
#: block may opt in to, less 4 KB for the kernel's static arrays (3,280
#: bytes at r = 16, as ptxas reports them)
SMEM_LIMIT = 232448 - 4096

#: the dynamic shared memory a block may opt in to on an H100
SMEM_OPTIN = 232448
#: threads of a block (``csrc/poweriter.cu``: kThreads)
THREADS = 256
#: rows and columns of a column-band tile of A (``A x``: two tensor boxes
#: of 64 x 32), columns of A a row-band tile holds (four a thread):
#: kBand, kColChunk
_BAND, _COL_CHUNK = 64, 4 * THREADS
#: bytes of a stage of the staged route's ring, one column-band tile
#: (``csrc/poweriter.cu``: 4 * kStageFloats), and the ring sizes it tries,
#: most stages first
STAGE_BYTES = 4 * _BAND * _BAND
RING_STAGES = (4, 3)
#: the staged kernel's static shared memory beside its dynamic share (its
#: r x r scratch, 3,280 bytes at r = 16), kept free of its half of the SM
_STAGED_STATIC_SMEM = 4096
#: int64 fields of a bucket record (``csrc/poweriter.cu``: kStagedFields),
#: ints of the geometry record and int64s of the phase clock (``dn_poweriter``)
_FIELDS, _GEOM_LEN, _PROF_LEN = 14, 3, 10

_entries: dict = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "poweriter": ("poweriter", [_I, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P]),
    "poweriter_max_active_blocks": ("poweriter", [_I, _I, _I, _P]),
}


def _kernel(name: str = "poweriter"):
    """``(entry, error_string)`` of C entry ``dn_<name>`` of
    ``csrc/poweriter.cu``, built on first use."""
    if name not in _entries:
        source, argtypes = _ARGTYPES[name]
        lib = _build.load(source)
        fn = getattr(lib, "dn_" + name)
        fn.argtypes = argtypes
        fn.restype = _I
        lib.dn_error_string.argtypes = [_I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entries[name] = (fn, lib.dn_error_string)
    return _entries[name]


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
    """Whether one K7 launch takes stacks of rank ``r`` whose shape buckets
    are ``shapes`` (``[(m, n), ...]``, one per stack): a pure shape gate,
    the counterpart of the JAX package's ``class_fits_vmem``.
    :func:`poweriter_fused` raises on what fails it; the engine
    (``engines/lowrank.py``) plans its launches by :func:`k7_launches`."""
    return (1 <= r <= MAX_RANK and 0 < len(shapes) <= MAX_BUCKETS
            and class_smem_bytes(shapes, r) <= SMEM_LIMIT)


def k7_launches(Gs, r: int) -> list[list[int]] | None:
    """The K7 launches of a rank class of rank ``r`` whose stacks are
    ``Gs`` (``[L, m, n]`` tensors), each a list of stack indices in order;
    None when the kernel takes no part of it (a rank above
    :data:`MAX_RANK`, iterates over :data:`SMEM_LIMIT`). A class of at most
    :data:`MAX_BUCKETS` stacks is one launch. A larger one, whose members
    are independent, is cut into launches of that many stacks, those whose
    rows are whole 16-byte chunks (:func:`_aligned`) first, so that the
    others, which put a launch on the direct route, share the last ones."""
    shapes = [tuple(G.shape[-2:]) for G in Gs]
    launches = [list(range(len(Gs)))]
    if len(Gs) > MAX_BUCKETS:
        order = sorted(range(len(Gs)), key=lambda k: not _aligned(Gs[k]))
        launches = [sorted(order[i:i + MAX_BUCKETS]) for i in range(0, len(order), MAX_BUCKETS)]
    return launches if all(k7_takes([shapes[k] for k in ks], r) for ks in launches) else None


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def staged_tiles(ra: int, ca: int) -> tuple[int, int] | None:
    """The staged route's tiles of a member whose row-major side A is
    ``[ra, ca]``: ``(band_rows, 64)``, the rows of a row band (``Aᵀy``: up
    to 1024 columns, a multiple of 4 rows, the most a stage holds) and the 64 columns of a column band (``A x``:
    64 rows, as two tensor boxes of 64 x 32, zero past A's edges); None
    when ``ca`` is not a multiple of 4 (A's rows are not whole 16-byte
    chunks)."""
    if ca % 4:
        return None
    return 4 * (STAGE_BYTES // 4 // (4 * min(_COL_CHUNK, ca))), _BAND


def staged_smem_bytes(shapes, r: int, stages: int) -> int:
    """Dynamic shared memory of a staged launch: each block's iterates ``P
    [r][m]`` and ``GᵀP [r][n]`` in f32, each column padded to 4 values, for
    the class's largest, 1024 bytes to align the ring (the swizzled boxes),
    then the ring."""
    return (4 * r * max(_round4(m) + _round4(n) for m, n in shapes) + 1024
            + stages * STAGE_BYTES)


def k7_geometry(shapes, r: int, strides_ok: bool = True, sms: int = 132,
                smem_optin: int = SMEM_OPTIN, row_major=None,
                blocks_per_sm: int | None = None) -> dict:
    """The launch geometry of one K7 call for a rank class of rank ``r``
    whose buckets are ``shapes`` (``[(L, m, n), ...]``, stacks of ``L``
    members), on a card of ``sms`` SMs whose blocks may opt in to
    ``smem_optin`` bytes. ``strides_ok``: every member and every row of each
    bucket's row-major side A is 16-byte aligned and A's width a multiple
    of 4 values (:func:`_aligned`); ``row_major[k]``: bucket
    k's G is row-major (A = G; else A = Gᵀ; default all). ``blocks_per_sm``:
    what ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reported for the
    staged kernel (default 2, its launch bound).

    Staged route whenever the iterates and a ring of 4 (else 3) stages of
    :data:`STAGE_BYTES` fit half of ``smem_optin`` less the static arrays
    and ``strides_ok``; else the direct route, the first design. Returns a
    dict: ``route``, ``stages``, ``tiles`` (per bucket
    ``(band_rows, band_cols)``), ``smem``, ``threads``, ``blocks`` (one a
    member), ``blocks_per_sm``, ``waves``, ``order`` (the buckets in launch
    order: largest member first, a stable sort; the direct route's is the
    member order) and, on the direct route, ``why``."""
    mn = [(m, n) for _, m, n in shapes]
    members = sum(L for L, _, _ in shapes)
    row_major = [True] * len(shapes) if row_major is None else list(row_major)
    tiles = [staged_tiles(*((m, n) if rm else (n, m))) for (m, n), rm in zip(mn, row_major)]
    if strides_ok and all(tiles):
        for stages in RING_STAGES:
            smem = staged_smem_bytes(mn, r, stages)
            if smem <= smem_optin // 2 - _STAGED_STATIC_SMEM:
                bps = 2 if blocks_per_sm is None else blocks_per_sm
                order = sorted(range(len(mn)), key=lambda k: -mn[k][0] * mn[k][1])
                return {"route": "staged", "stages": stages, "tiles": tiles, "smem": smem, "threads": THREADS, "blocks": members,
                        "blocks_per_sm": bps, "waves": math.ceil(members / max(1, bps * sms)),
                        "order": order}
        why = "the iterates and the ring exceed half of an SM's shared memory"
    else:
        why = "a member or a row of G's row-major side is not in whole 16-byte chunks"
    return k7_direct_geometry(shapes, r, sms, why)


def k7_direct_geometry(shapes, r: int, sms: int = 132, why: str = "asked for") -> dict:
    """The direct route, the first design: one block a member in member
    order, the iterates in shared memory, one block an SM (its registers).
    Measurements may ask for it."""
    members = sum(L for L, _, _ in shapes)
    return {"route": "direct", "smem": class_smem_bytes([(m, n) for _, m, n in shapes], r),
            "threads": THREADS, "blocks": members, "blocks_per_sm": 1,
            "waves": math.ceil(members / sms), "order": list(range(len(shapes))), "why": why}


def _geom_ints(g: dict):
    """The geometry record ``dn_poweriter`` reads: route, stages, dynamic
    shared memory."""
    v = [1, g["stages"], g["smem"]] if g["route"] == "staged" else [0] * _GEOM_LEN
    return (ctypes.c_int * _GEOM_LEN)(*v)


def _dtype_code(mm_dtype) -> int:
    return 0 if mm_dtype is None else 1


_geometries: dict = {}


def device_k7_geometry(device, shapes, r: int, strides_ok: bool = True, row_major=None,
                       mm_dtype=None) -> dict:
    """:func:`k7_geometry` on ``device``'s SM count and shared memory, with
    the staged kernel's blocks an SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    (:func:`k7_max_active_blocks`). Worked out once per device and class."""
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, tuple(map(tuple, shapes)), r, strides_ok,
           None if row_major is None else tuple(row_major), _dtype_code(mm_dtype))
    if key not in _geometries:
        sms, optin = device_limits(dev)
        g = k7_geometry(shapes, r, strides_ok, sms, optin, row_major)
        if g["route"] == "staged":
            bps = k7_max_active_blocks(torch.device("cuda", idx), r, g["smem"], mm_dtype)
            g = k7_geometry(shapes, r, strides_ok, sms, optin, row_major, bps)
        _geometries[key] = g
    return _geometries[key]


_occupancy: dict = {}


def k7_max_active_blocks(device, r: int, smem: int, mm_dtype=None) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the staged kernel
    of this rank and operand type at ``smem`` bytes of dynamic shared
    memory, asked once per device and configuration."""
    dev = torch.device(device)
    key = (dev, r, smem, _dtype_code(mm_dtype))
    if key not in _occupancy:
        fn, err_str = _kernel("poweriter_max_active_blocks")
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(_dtype_code(mm_dtype), r, smem, ctypes.byref(out))
        if err != 0:
            raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: "
                               f"{err_str(err).decode()} ({err})")
        _occupancy[key] = out.value
    return _occupancy[key]


def launch_records(shapes, geometry: dict) -> list[tuple[int, int, int]]:
    """``(bucket, first, order)`` of each kernel record, in launch order:
    bucket k of ``shapes`` (``[(L, m, n), ...]``, member order) runs as
    blocks ``first .. first + L - 1`` of the launch, in ``geometry``'s
    order, and its members are ``order .. order + L - 1`` in member order,
    where their trips go."""
    starts = [sum(L for L, _, _ in shapes[:k]) for k in range(len(shapes))]
    out, first = [], 0
    for k in geometry["order"]:
        out.append((k, first, starts[k]))
        first += shapes[k][0]
    return out


def _row_major(g) -> bool:
    """Whether G ``[L, m, n]`` is row-major (A = G); else A = Gᵀ."""
    return g.stride(2) == 1


def _aligned(g) -> bool:
    """Whether every member of G and every row of its row-major side A is
    16-byte aligned and A's rows are whole 16-byte chunks (f32: base, a
    nonzero member stride, row pitch and width), as the staged route's
    tensor maps and bulk copies take them."""
    lda, ca = (g.stride(1), g.shape[2]) if _row_major(g) else (g.stride(2), g.shape[1])
    return (g.data_ptr() % 16 == 0 and lda % 4 == 0 and ca % 4 == 0
            and (g.shape[0] == 1 or (g.stride(0) > 0 and g.stride(0) % 4 == 0)))


def poweriter_fused(G, om, num_iters: int, tol: float, mm_dtype=None, geometry=None):
    """K7: one launch for the whole rank class, one thread block per
    member, on the route of :func:`device_k7_geometry` (or ``geometry``, for
    measurements). Same arguments and returns as :func:`poweriter_plain`."""
    single, Gs, oms = _as_lists(G, om)
    if all(g.device.type == "cpu" for g in Gs + oms):
        return poweriter_plain(G, om, num_iters, tol, mm_dtype)
    Ps, Qs, trips = _k7(Gs, oms, num_iters, tol, mm_dtype, geometry)
    return (Ps[0], Qs[0], trips) if single else (Ps, Qs, trips)


def _k7(Gs, oms, num_iters, tol, mm_dtype, geometry, prof=None):
    dev = Gs[0].device
    _check(dev.type == "cuda" and all(a.device == dev for a in Gs + oms),
           "every G and omega stack must be on one CUDA device")
    _check(mm_dtype in (None, torch.bfloat16), f"mm_dtype must be None or bfloat16, got {mm_dtype}")
    _check(num_iters >= 0, f"num_iters must be >= 0, got {num_iters}")
    _check(0 < len(Gs) <= MAX_BUCKETS, f"{len(Gs)} G stacks, the kernel takes 1..{MAX_BUCKETS}")
    r = oms[0].shape[-1]
    _check(1 <= r <= MAX_RANK, f"rank {r} outside the kernel's 1..{MAX_RANK}")
    shapes, Ps, Qs = [], [], []
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
        shapes.append((L, m, n))
        Ps.append(torch.empty((L, m, r), dtype=torch.float32, device=dev))
        Qs.append(torch.empty((L, n, r), dtype=torch.float32, device=dev))
    smem = class_smem_bytes([(m, n) for _, m, n in shapes], r)
    _check(smem <= SMEM_LIMIT, f"a class of rank {r} with m + n up to "
           f"{max(m + n for _, m, n in shapes)} needs {smem} bytes of shared memory a block, "
           f"over the {SMEM_LIMIT} this kernel may use")
    aligned = all(_aligned(g) for g in Gs)
    row_major = [_row_major(g) for g in Gs]
    geo = geometry or device_k7_geometry(dev, shapes, r, aligned, row_major, mm_dtype)
    staged = geo["route"] == "staged"
    _check(sorted(geo["order"]) == list(range(len(Gs))),
           f"the geometry's order {geo['order']} is not one of {len(Gs)} buckets")
    _check(not staged or aligned, "the staged route needs members and rows in whole 16-byte "
           "chunks")
    _check(prof is None or staged, "the phase clock is the staged route's")
    # the kernel's records in launch order: element strides, the members'
    # blocks, their index in member order, the tiles
    records = []
    for k, first, order in launch_records(shapes, geo):
        g, o, (L, m, n) = Gs[k], oms[k], shapes[k]
        band_rows = geo["tiles"][k][0] if staged else 0
        records.append([g.data_ptr(), *g.stride(), o.data_ptr(), o.stride(0), Ps[k].data_ptr(),
                        Qs[k].data_ptr(), m, n, first, L, order, band_rows])
    trips = torch.empty(sum(L for L, _, _ in shapes), dtype=torch.int32, device=dev)
    flat = (ctypes.c_longlong * (_FIELDS * len(records)))(*(v for b in records for v in b))
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        err = fn(_dtype_code(mm_dtype), flat, len(records), r, max(m + n for _, m, n in shapes),
                 num_iters, tol, trips.data_ptr(), _geom_ints(geo),
                 None if prof is None else prof.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"poweriter kernel ({geo['route']} route) failed: "
                           f"{err_str(err).decode()} ({err})")
    global POWERITER_LAUNCHES, POWERITER_STAGED_CALLS, POWERITER_DIRECT_CALLS
    POWERITER_LAUNCHES += 1
    if staged:
        POWERITER_STAGED_CALLS += 1
    else:
        POWERITER_DIRECT_CALLS += 1
    return Ps, Qs, trips


#: what the staged route's phase clock splits a member's time into
K7_PHASES = ("products", "ring_wait", "issue", "chain", "other")


def k7_phase_profile(G, om, num_iters: int, tol: float, mm_dtype=None, geometry=None) -> dict:
    """One K7 call on the staged route with its phase clock on: the µs the
    last member of the largest bucket (the first in launch order) spends in
    the products (their ring waits and copy issue excluded; ``A x`` and
    ``Aᵀy`` apart, all included), in the ring waits (a warp waiting on a
    stage's mbarrier for its tile to land), in issuing the copies (tensor
    boxes and bulk row copies, by the warp that refills a stage), in the
    r x r chain (the CholeskyQR rounds and the σ update) and in the rest (Ω in, P and Q out, the rounding and output of the
    iterates), each phase's share, its passes over G and its trips; from
    ``clock64`` sums converted by the global timer. For measurements;
    counts as a call."""
    _, Gs, oms = _as_lists(G, om)
    prof = torch.zeros(_PROF_LEN, dtype=torch.int64, device=Gs[0].device)
    shapes = [tuple(g.shape) for g in Gs]
    geo = geometry or device_k7_geometry(Gs[0].device, shapes, oms[0].shape[-1],
                                         all(_aligned(g) for g in Gs),
                                         [_row_major(g) for g in Gs], mm_dtype)
    prof[8] = shapes[geo["order"][0]][0] - 1  # its block: largest bucket first
    _k7(Gs, oms, num_iters, tol, mm_dtype, geo, prof)
    return k7_phase_summary(prof.tolist(), [tuple(g.shape) for g in Gs])


def k7_phase_summary(prof, shapes) -> dict:
    """The phase clock ``prof`` (int64[10]: cycles in ``A x``, in ``Aᵀy``, in
    ring waits, in all; global ns at the start; cycles in the chain; global
    ns at the end; trips; bucket; cycles issuing copies) as µs.
    ``products`` is both products less their ring waits and copy issue."""
    ax, aty, wait, total, ns0, chain, ns1, t, k, issue = prof
    ns_per_cycle = (ns1 - ns0) / total
    cycles = {"products": ax + aty - wait - issue, "ring_wait": wait, "issue": issue,
              "chain": chain, "other": total - ax - aty - chain}
    out = {f"{p}_us": cycles[p] * ns_per_cycle / 1e3 for p in K7_PHASES}
    out.update({f"{p}_share": cycles[p] / total for p in K7_PHASES})
    out.update(ax_us=ax * ns_per_cycle / 1e3, aty_us=aty * ns_per_cycle / 1e3,
               total_us=total * ns_per_cycle / 1e3, passes=2 + 2 * t, trips=t,
               member_shape=list(shapes[k][1:]), ghz=1.0 / ns_per_cycle)
    return out
