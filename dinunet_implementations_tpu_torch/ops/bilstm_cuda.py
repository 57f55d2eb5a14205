"""The fused BIDIRECTIONAL LSTM recurrence, forward and backward, both
directions in one kernel launch: CUDA kernels for the card, their plain
PyTorch versions beside them.

Counterpart of the JAX package's ``ops/lstm_pallas.py`` bidirectional path
(``_fwd_bidir_kernel``, ``_bwd_bidir_kernel``, ``_fwd_pool_kernel4``,
``_bwd_pool_kernel4`` behind ``bilstm_recurrence_fused`` and
``bilstm_pool_fused_op``), with JAX's layouts:

- ``x [T, B, D]`` raw per-step inputs, shared by both directions: the
  reverse direction reads ``x[T-1-s]`` at its step ``s``; nothing is
  flipped;
- ``wih2 [2, 4, D, H]``, ``b2 [2, 4, H]`` (``b_ih + b_hh``), ``whh2 [2, 4,
  H, H]``, direction 0 forward and 1 reverse, gates i, f, o, g;
- ``h02, c02 [2, B, H]`` f32.

Every stream of both directions is stored in X-TIME: ``hs2[1, t]`` is the
reverse state after consuming ``x[T-1..t]``. The streams are ``[2, T, B,
H]``; the backward's gate cotangents are one ``[T, B, 8H]`` array (forward
gates, then reverse gates), the concat that ``dx`` and ``dW_ih`` take.

Kernels (``csrc/bilstm_fwd.cu``, ``csrc/bilstm_bwd.cu``) and launch counters:

- K3 :func:`bilstm_fwd_fused` (``BIDIR_FWD_LAUNCHES``): the forward;
- K5 :func:`bilstm_pool_fwd_fused` (``POOL_FWD_LAUNCHES``): the forward and
  the time-mean pool, summed in f32 from the f32 h inside the kernel;

  a K3 or K5 call takes one of two routes, chosen by shape before any
  launch (:func:`bidir_geometry`): the cluster route
  (``BIDIR_CLUSTER_CALLS``) is two launches, the i2h projection of both
  directions into an f32 scratch ``[T, B, 8H]`` (:func:`bilstm_proj_fused`,
  ``BIDIR_PROJ_LAUNCHES``; f32: K1's SIMT GEMM with 8 gates, in
  ``lstm_proj_wide_kernel``'s or ``lstm_proj_kernel``'s tiles by shape;
  bf16: ``lstm_proj_mma_kernel`` on the tensor cores, ``lstm_proj_kernel``
  when D is not a multiple of 8) and the recurrence of both directions
  over thread-block clusters that hold W_hh in shared memory; the stream
  route (``BIDIR_STREAM_CALLS``), for a W_hh whose slice fits no cluster
  of 8, is the first design's one launch with the projection inside the
  loop;
- K4 :func:`bilstm_bwd_fused` (``BIDIR_BWD_LAUNCHES``): the backward, with
  a full cotangent stream or a per-row constant at the stream dtype;
- K6 :func:`bilstm_pool_bwd_fused` (``POOL_BWD_LAUNCHES``): the backward of
  the pool, its cotangent ``dpool / T`` a per-row f32 constant;

  a K4 or K6 call takes one of two routes, chosen by shape before any
  launch (:func:`bidir_bwd_geometry`, settled on each kernel's own
  occupancy: :func:`device_k4_geometry`, :func:`device_bidir_bwd_geometry`):
  K2's cluster BPTT with half of the clusters a direction
  (``csrc/lstm_bwd_cluster.cuh``; ``K4_CLUSTER_CALLS``,
  ``BIDIR_BWD_CLUSTER_CALLS``), or the first design for a W_hhᵀ whose slice
  fits no cluster of 8 (``K4_STREAM_CALLS``, ``BIDIR_BWD_STREAM_CALLS``).

Each launches for CUDA tensors and raises on anything it does not take;
for CPU tensors, and only for them, it runs :func:`bilstm_fwd_plain` or
:func:`bilstm_bwd_plain`.

:class:`BiLSTMRecurrence` (the sequence-returning op) and
:class:`BiLSTMPool` (the pooled op) are the differentiable ops. They
dispatch as JAX's ``custom_vmap`` rules do: unbatched weights go to K3/K4;
weights with a leading site axis ``[S, ...]`` of stride 0 go to K5/K6 in
the pooled op (K3/K4 in the sequence op), the rows of ``x`` being ``S``
site-major blocks, and the weight gradients come back per site. Under
``compute_dtype=torch.bfloat16`` the two dispatches of the pooled op differ
by design, as in JAX: the unbatched pool is the f32 mean of the bf16 ``hs``
and its cotangent is cast to bf16; K5's pool is the f32 sum of the f32 h
and K6's cotangent stays f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lstm_cuda import (
    _CLUSTER_STATIC_SMEM,
    BWD_PHASES,
    K1_CLUSTER_MAX_H,
    K1_CLUSTER_SIZES,
    SMEM_OPTIN,
    _cdiv,
    _check,
    _cluster_config,
    _geom_ints,
    _launch_proj,
    _launch_proj_mma,
    _site_weight,
    _stream_dtype,
    bwd_geometry,
    cluster_occupancy,
    device_limits,
    k1_column_map,
    phase_summary,
    settle_geometry,
)

#: K3 launches since the counter was last set to 0
BIDIR_FWD_LAUNCHES = 0
#: K4 launches since the counter was last set to 0
BIDIR_BWD_LAUNCHES = 0
#: K5 launches since the counter was last set to 0
POOL_FWD_LAUNCHES = 0
#: K6 launches since the counter was last set to 0
POOL_BWD_LAUNCHES = 0
#: K3 and K5 calls whose recurrence took the cluster route / the stream route
BIDIR_CLUSTER_CALLS = 0
BIDIR_STREAM_CALLS = 0
#: launches of the projection kernel for both directions (8 gates)
BIDIR_PROJ_LAUNCHES = 0
#: K4 launches on the cluster route / the stream route
K4_CLUSTER_CALLS = 0
K4_STREAM_CALLS = 0
#: K6 launches on the cluster route / the stream route
BIDIR_BWD_CLUSTER_CALLS = 0
BIDIR_BWD_STREAM_CALLS = 0

_entries: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FWD = [_I, _P, _L, _L, _P, _P, _P, _P, _P] + [_P] * 8
# (library, C entry) -> argument types
_ARGTYPES = {
    ("bilstm_fwd", "dn_bilstm_fwd"): _FWD + [_I, _I, _I, _I, _P],
    ("bilstm_fwd", "dn_bilstm_pool_fwd"): _FWD + [_P, _I, _I, _I, _I, _P],
    ("bilstm_fwd", "dn_bilstm_rec"): [_I, _I] + [_P] * 13 + [_I, _I, _I, _P, _P, _P],
    ("bilstm_fwd", "dn_bilstm_max_active_clusters"): [_I, _I, _I, _I, _P, _P],
    ("bilstm_bwd", "dn_bilstm_bwd"): [_I] + [_P] * 7 + [_P, _L, _L, _P, _L, _L]
    + [_P] * 5 + [_I, _I, _I, _P, _P, _P],
    ("bilstm_bwd", "dn_bilstm_pool_bwd"): [_I] + [_P] * 14 + [_I, _I, _I, _P, _P, _P],
    ("bilstm_bwd", "dn_bilstm_bwd_max_active_clusters"): [_I, _I, _I, _P, _P],
    ("bilstm_bwd", "dn_bilstm_k4_max_active_clusters"): [_I, _I, _I, _P, _P],
}


def _kernel(lib_name: str, entry: str):
    """``(entry, error_string)`` of ``csrc/<lib_name>.cu``, built on first use."""
    key = (lib_name, entry)
    if key not in _entries:
        lib = _build.load(lib_name)
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[key]
        fn.restype = _I
        lib.dn_error_string.argtypes = [_I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entries[key] = (fn, lib.dn_error_string)
    return _entries[key]


def _launch(lib_name: str, entry: str, *args) -> None:
    fn, err_str = _kernel(lib_name, entry)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry} kernel failed: {err_str(err).decode()} ({err})")


# ---------------------------------------------------------------------------
# K3/K5's launch geometry (pure shape arithmetic, tested on the CPU)

#: the most threads of a block of the f32 recurrence, at 8 rows a thread and
#: below (``csrc/bilstm_fwd.cu:kRows8Threads``, ``kSimtThreads``)
_ROWS8_THREADS, _SIMT_THREADS = 640, 512


def _rows_a_thread(R: int) -> int:
    """Rows a thread carries in the product: the fewest of 1, 2, 4 that
    cover ``R``, else 8 (a thread's tile is 2 columns by these rows)."""
    r = 1
    while r < 8 and r < R:
        r *= 2
    return r


#: the most threads and 16-row m-tiles of a block of the bf16 recurrence
#: (``kMmaThreads``, and the instances ``rec_mma_tiles`` launches)
_MMA_THREADS, _MMA_TILES = 704, 3


def _mma_config(R: int, H: int, C: int, smem_optin: int, pool: bool) -> dict | None:
    """Threads and shared memory of a block of the bf16 recurrence, whose
    product runs on the tensor cores (``csrc/bilstm_fwd.cu:mma_smem_bytes``),
    or None if none fits: the W_hh slice transposed ``[nw, ks]`` bf16 (``nw
    = 4·smax`` rounded up to 8, ``ks = H`` rounded up to 16, plus 8), h as
    the bf16 operand ``[rp, ks]`` (``rp = R`` rounded up to 16, at most 3
    tiles of 16), the f32 exchange ``[2, smax, rp | 1]``, pre ``[rp, nw +
    8]``, the carry and, with ``pool``, the pool sums ``[rp, smax]``; a warp
    for each pair of 8-column n-tiles, at least 4."""
    if H > K1_CLUSTER_MAX_H:
        return None
    smax = _cdiv(H, C)
    nw = _cdiv(4 * smax, 8) * 8
    ks = _cdiv(H, 16) * 16 + 8
    rp = _cdiv(R, 16) * 16
    threads = 32 * max(4, _cdiv(nw // 8, 2))
    if rp > 16 * _MMA_TILES or threads > _MMA_THREADS:
        return None
    smem = (_cdiv(nw * ks * 2, 16) * 16 + _cdiv(rp * ks * 2, 16) * 16
            + 4 * (2 * smax * (rp | 1) + rp * (nw + 8) + rp * smax * (2 if pool else 1)))
    if smem + _CLUSTER_STATIC_SMEM > smem_optin:
        return None
    return {"rpt": 16, "row_groups": rp // 16, "rp": rp, "threads": threads, "smem": smem,
            "smax": smax}


def bidir_cluster_geometry(rows: int, H: int, C: int, R: int, dtype=None,
                           smem_optin: int = SMEM_OPTIN, slots: int | None = None,
                           pool: bool = True) -> dict | None:
    """The cluster route's geometry for clusters of ``C`` blocks of ``R``
    rows each, ``clusters`` of them a direction, or None if such a block
    does not fit; ``slots`` is the clusters of both directions the card
    runs at once (for ``waves``); ``pool``: K5's layout, with the pool sums
    in shared memory. f32: K1's block layout (``_cluster_config``), two
    columns a thread; bf16: the tensor-core layout (:func:`_mma_config`)."""
    if dtype == torch.bfloat16:
        cfg = _mma_config(R, H, C, smem_optin, pool)
    else:
        rpt = _rows_a_thread(R)
        cfg = _cluster_config(R, H, C, 4, smem_optin, pool=pool, cols_a_thread=2, rpts=(rpt,),
                              max_threads=_ROWS8_THREADS if rpt == 8 else _SIMT_THREADS)
    if cfg is None:
        return None
    clusters = _cdiv(rows, R)
    return {"route": "cluster", "C": C, "R": R, **cfg, "j0": k1_column_map(H, C),
            "clusters": clusters, "blocks": 2 * clusters * C, "pool": pool,
            "waves": _cdiv(2 * clusters, slots) if slots else None}


def bidir_geometry(rows: int, H: int, dtype=None, sms: int = 132, smem_optin: int = SMEM_OPTIN,
                   cluster_slots: dict | None = None, pool: bool = True) -> dict:
    """The launch geometry of K3 (``pool=False``) or K5 for ``rows`` rows of
    width ``H`` at the operand dtype (None: f32; ``torch.bfloat16``) on a
    card of ``sms`` SMs whose blocks may opt in to ``smem_optin`` bytes;
    ``cluster_slots`` maps a cluster size to the clusters the card runs at
    once (``cudaOccupancyMaxActiveClusters``; default ``sms // C``).

    Cluster route: both directions' clusters share the card's slots, half
    each. The smallest cluster size ``C`` (2, 4, 8) whose block fits with
    ``R``, the rows a cluster, the fewest that keep the clusters of both
    directions within one wave; failing that, the smallest ``C`` that fits
    a row at all, with as many rows a cluster as fit (several waves).
    Stream route, for a W_hh whose slice fits no cluster of 8: the first
    design's kernel, which picks its own rows a block. Returns a dict with
    ``route`` and the numbers the C entry takes."""
    slots = {C: (cluster_slots or {}).get(C, sms // C) for C in K1_CLUSTER_SIZES}
    sizes = [C for C in K1_CLUSTER_SIZES if C <= H and slots[C] >= 2]
    for wave_only in (True, False):
        for C in sizes:
            R = _cdiv(rows, slots[C] // 2)
            g = bidir_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C], pool)
            while g is None and not wave_only and R > 1:
                R = R // 2 if R > 64 else R - 1
                g = bidir_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C], pool)
            if g is not None:
                return g
    return bidir_stream_geometry(rows, H, sms)


def bidir_stream_geometry(rows: int, H: int, sms: int = 132) -> dict:
    """The stream route: the first design's kernel, one block of ``R`` (1,
    2, 4, 8) rows a direction, the fewest that keep both directions' blocks
    within the SMs (it picks ``R`` itself, as here). Measurements may ask
    for it."""
    R = 1
    while R < 8 and _cdiv(rows, R) > sms // 2:
        R *= 2
    blocks = 2 * _cdiv(rows, R)
    return {"route": "stream", "R": R, "threads": min(1024, _cdiv(4 * H, 32) * 32),
            "blocks": blocks, "waves": _cdiv(blocks, sms)}


_geometries: dict = {}


def device_bidir_geometry(device, rows: int, H: int, compute_dtype=None, pool: bool = True) -> dict:
    """:func:`bidir_geometry` on ``device``'s SM count and shared memory,
    with the clusters the card runs at once from
    ``cudaOccupancyMaxActiveClusters`` of this kernel
    (``ops/lstm_cuda.py:settle_geometry``). Worked out once per device and
    shape."""
    dev = torch.device(device)
    key = (dev, rows, H, compute_dtype == torch.bfloat16, pool)
    if key not in _geometries:
        sms, optin = device_limits(dev)
        _geometries[key] = settle_geometry(
            lambda slots: bidir_geometry(rows, H, compute_dtype, sms, optin, slots, pool),
            lambda g: bidir_max_active_clusters(dev, rows, H, compute_dtype, g))
    return _geometries[key]


def bidir_max_active_clusters(device, rows: int, H: int, compute_dtype=None,
                              geometry: dict | None = None, pool: bool = True) -> int | None:
    """``cudaOccupancyMaxActiveClusters`` of the cluster recurrence at this
    geometry (clusters of both directions together), asked once per device
    and configuration; None on the stream route."""
    g = geometry or device_bidir_geometry(device, rows, H, compute_dtype, pool)
    if g["route"] != "cluster":
        return None
    dev = torch.device(device)
    code = 0 if compute_dtype is None else 1
    geom = _geom_ints(g)
    with torch.cuda.device(dev):
        return cluster_occupancy(_kernel("bilstm_fwd", "dn_bilstm_max_active_clusters"),
                                 ("bidir", dev, code, g["pool"], rows, H, tuple(geom)),
                                 code, int(g["pool"]), rows, H, geom)


def bidir_bwd_geometry(rows: int, H: int, dtype=None, sms: int = 132,
                       smem_optin: int = SMEM_OPTIN, cluster_slots: dict | None = None) -> dict:
    """The launch geometry of K4 and K6: ``ops/lstm_cuda.py:bwd_geometry``
    for two directions, whose clusters share the card's slots, half each;
    the stream route (the first design) for a W_hhᵀ whose slice fits no
    cluster of 8."""
    return bwd_geometry(rows, H, dtype, sms, smem_optin, cluster_slots, 2)


#: the C entry of each two-direction BPTT's occupancy query: K4's bf16
#: instance reads a bf16 dhs, K6's an f32 constant, so their registers, and
#: the clusters the card runs at once, may differ
_BWD2_OCCUPANCY = {"k4": "dn_bilstm_k4_max_active_clusters",
                   "k6": "dn_bilstm_bwd_max_active_clusters"}


def _device_bwd2_geometry(kernel: str, device, rows: int, H: int, compute_dtype) -> dict:
    dev = torch.device(device)
    key = (kernel, dev, rows, H, compute_dtype == torch.bfloat16)
    if key not in _geometries:
        sms, optin = device_limits(dev)
        _geometries[key] = settle_geometry(
            lambda slots: bidir_bwd_geometry(rows, H, compute_dtype, sms, optin, slots),
            lambda g: _bwd2_max_active_clusters(kernel, dev, rows, H, compute_dtype, g))
    return _geometries[key]


def _bwd2_max_active_clusters(kernel: str, device, rows: int, H: int, compute_dtype,
                              geometry: dict | None) -> int | None:
    g = geometry or _device_bwd2_geometry(kernel, device, rows, H, compute_dtype)
    if g["route"] != "cluster":
        return None
    dev = torch.device(device)
    code = 0 if compute_dtype is None else 1
    geom = _geom_ints(g)
    with torch.cuda.device(dev):
        return cluster_occupancy(_kernel("bilstm_bwd", _BWD2_OCCUPANCY[kernel]),
                                 (kernel, dev, code, rows, H, tuple(geom)), code, rows, H, geom)


def device_bidir_bwd_geometry(device, rows: int, H: int, compute_dtype=None) -> dict:
    """:func:`bidir_bwd_geometry` of K6 on ``device``'s SM count and shared
    memory, with the clusters the card runs at once from
    ``cudaOccupancyMaxActiveClusters`` of K6's cluster kernel
    (``ops/lstm_cuda.py:settle_geometry``). Worked out once per device and
    shape."""
    return _device_bwd2_geometry("k6", device, rows, H, compute_dtype)


def bidir_bwd_max_active_clusters(device, rows: int, H: int, compute_dtype=None,
                                  geometry: dict | None = None) -> int | None:
    """``cudaOccupancyMaxActiveClusters`` of K6's cluster route at this
    geometry (clusters of both directions together), asked once per device
    and configuration; None on the stream route."""
    return _bwd2_max_active_clusters("k6", device, rows, H, compute_dtype, geometry)


def device_k4_geometry(device, rows: int, H: int, compute_dtype=None) -> dict:
    """:func:`bidir_bwd_geometry` of K4, as :func:`device_bidir_bwd_geometry`
    but settled on K4's own occupancy entry and kept under its own key."""
    return _device_bwd2_geometry("k4", device, rows, H, compute_dtype)


def k4_max_active_clusters(device, rows: int, H: int, compute_dtype=None,
                           geometry: dict | None = None) -> int | None:
    """``cudaOccupancyMaxActiveClusters`` of K4's cluster route at this
    geometry (clusters of both directions together); None on the stream
    route."""
    return _bwd2_max_active_clusters("k4", device, rows, H, compute_dtype, geometry)


# ---------------------------------------------------------------------------
# plain versions


def _direction_plain(x, wih4, b4, whh4, h0, c0, sdt, reverse: bool):
    """One direction's loop, the kernel's time map and casts: step ``s``
    consumes ``x[t]`` with ``t = T-1-s`` for the reverse direction and
    stores at ``t``. Returns the six f32 streams, the f32 carries and the
    f32 sum of h over the direction's own time."""
    T, B, D = x.shape
    H = wih4.shape[-1]
    wih = wih4.to(sdt).float().permute(1, 0, 2).reshape(D, 4 * H)
    whh = whh4.to(sdt).float().permute(1, 0, 2).reshape(H, 4 * H)
    xp = torch.matmul(x.to(sdt).float(), wih)  # [T, B, 4H]
    b = b4.float().reshape(4 * H)
    h, c = h0.float(), c0.float()
    total = torch.zeros_like(h)
    streams = [[None] * T for _ in range(6)]
    for s in range(T):
        t = T - 1 - s if reverse else s
        pre = xp[t] + torch.matmul(h.to(sdt).float(), whh) + b
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        o = torch.sigmoid(pre[:, 2 * H:3 * H])
        g = torch.tanh(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        total = total + h
        for st, v in zip(streams, (h, c, i, f, o, g)):
            st[t] = v
    return [torch.stack(st) for st in streams], h, c, total


def bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype=None, residuals=True,
                     pool=False):
    """Plain PyTorch version of K3 (and, with ``pool=True``, K5): both
    directions' loops over T with the kernels' time maps and casts. Under
    ``compute_dtype=torch.bfloat16`` the operands of both products are
    rounded to bf16 and the products accumulate in f32; the streams are
    bf16 and the carries f32.

    Returns ``(hs2, cs2, i2, f2, o2, g2, hT2, cT2)``: streams ``[2, T, B,
    H]`` at the stream dtype in x-time, carries ``[2, B, H]`` f32; with
    ``residuals=False`` only ``(hs2, (hT2, cT2))``. ``pool=True`` appends
    K5's ``pool [B, 2H]`` f32: each direction's f32 h summed over its own
    time, times ``1/T``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, _ = x.shape
    dirs = [_direction_plain(x, wih2[d], b2[d], whh2[d], h02[d], c02[d], sdt, d == 1)
            for d in (0, 1)]
    streams = [torch.stack([dirs[0][0][k], dirs[1][0][k]]).to(sdt) for k in range(6)]
    hT2 = torch.stack([dirs[0][1], dirs[1][1]])
    cT2 = torch.stack([dirs[0][2], dirs[1][2]])
    if pool:
        sums = torch.cat([dirs[0][3], dirs[1][3]], -1)
        return (*streams, hT2, cT2, sums * (1.0 / T))
    if not residuals:
        return streams[0], (hT2, cT2)
    return (*streams, hT2, cT2)


def bilstm_proj_plain(x, wih2, b2, compute_dtype=None):
    """Plain PyTorch version of the cluster route's projection: ``xp2 [T, B,
    8H] = x W_ih + b`` in f32 for both directions, direction ``d``'s gates
    i, f, o, g at columns ``d·4H + k·H``, from operands rounded to the
    compute dtype."""
    sdt = _stream_dtype(compute_dtype)
    T, B, D = x.shape
    H = wih2.shape[-1]
    w = wih2.to(sdt).float().reshape(8, D, H).permute(1, 0, 2).reshape(D, 8 * H)
    return torch.matmul(x.to(sdt).float(), w) + b2.float().reshape(8 * H)


def bilstm_bwd_plain(ai2, af2, ao2, ag2, cs2, whh2, c02, dhsf, dhsr, dhT2, dcT2,
                     compute_dtype=None):
    """Plain PyTorch version of K4 (and K6): each direction's loop over its
    own time, backwards, of the JAX ``_bwd_bidir_kernel``. ``ai2 .. cs2``
    are the forward's residual streams ``[2, T, B, H]`` in x-time;
    ``dhsf, dhsr`` the cotangents of ``hs2[0], hs2[1]``, each a ``[T, B,
    H]`` stream or a ``[1, B, H]`` per-row constant (K6: ``dpool / T`` in
    f32); ``dhT2, dcT2 [2, B, H]`` those of the terminal carries. Under
    ``compute_dtype=torch.bfloat16`` each dp is rounded to bf16 before the
    product with ``W_hhᵀ`` (also bf16) and the product accumulates in f32.

    Returns ``(dp [T, B, 8H] at the stream dtype: the forward direction's
    gates i, f, o, g, then the reverse direction's; dh02, dc02 [2, B, H]
    f32)``."""
    sdt = _stream_dtype(compute_dtype)
    _, T, B, H = cs2.shape
    dp = torch.empty((T, B, 8 * H), dtype=sdt, device=cs2.device)
    dh0, dc0 = [], []
    for d, dhs in enumerate((dhsf, dhsr)):
        wT = whh2[d].to(sdt).float().transpose(1, 2)  # W_hh[d, k]ᵀ
        i, f, o, g, c = (a[d].float() for a in (ai2, af2, ao2, ag2, cs2))
        dh_c, dc_c = dhT2[d].float(), dcT2[d].float()
        for s in range(T):
            t = s if d == 1 else T - 1 - s
            tp = t + 1 if d == 1 else t - 1  # one step earlier in the direction's own time
            c_prev = c[tp] if 0 <= tp < T else c02[d].float()
            dh = dhs[t if dhs.shape[0] == T else 0].float() + dh_c
            tc = torch.tanh(c[t])
            dc = dh * o[t] * (1 - tc * tc) + dc_c
            dps = (dc * g[t] * i[t] * (1 - i[t]), dc * c_prev * f[t] * (1 - f[t]),
                   dh * tc * o[t] * (1 - o[t]), dc * i[t] * (1 - g[t] * g[t]))
            dp[t, :, 4 * H * d:4 * H * (d + 1)] = torch.cat(dps, -1).to(sdt)
            ops = [v.to(sdt).float() for v in dps]
            dh_c = (((ops[0] @ wT[0]) + ops[1] @ wT[1]) + ops[2] @ wT[2]) + ops[3] @ wT[3]
            dc_c = dc * f[t]
        dh0.append(dh_c)
        dc0.append(dc_c)
    return dp, torch.stack(dh0), torch.stack(dc0)


# ---------------------------------------------------------------------------
# kernel wrappers


def _fwd_checks(fn, x, wih2, b2, whh2, h02, c02, compute_dtype):
    """Validates a forward call (``whh2, h02, c02`` None: the projection's
    alone); returns ``(sdt, x, wih2, b2, whh2, T, B, D, H)``: x and whh2 at
    the stream dtype, wih2 contiguous at its own (each route converts it
    into the layout it reads)."""

    def check(cond, what):
        _check(cond, what, fn)

    check(x.device.type == "cuda", f"unsupported device {x.device}")
    sdt = _stream_dtype(compute_dtype)
    rec = whh2 is not None
    if compute_dtype is None:
        check(all(a.dtype == torch.float32 for a in (x, wih2) + ((whh2,) if rec else ())),
              "x, wih2 and whh2 must be float32 when compute_dtype is None")
    check(x.dim() == 3, f"x must be [T, B, D], got {tuple(x.shape)}")
    T, B, D = x.shape
    H = wih2.shape[-1]
    check(T >= 1 and B >= 1, "x needs at least one step and one row")
    check(tuple(wih2.shape) == (2, 4, D, H), f"wih2 must be [2, 4, {D}, {H}], got {tuple(wih2.shape)}")
    check(tuple(b2.shape) == (2, 4, H) and b2.dtype == torch.float32,
          f"b2 must be [2, 4, {H}] float32, got {tuple(b2.shape)} {b2.dtype}")
    check(all(a.device == x.device for a in (wih2, b2)), "all inputs must be on one device")
    check(x.stride(-1) == 1, "x must be contiguous in its last axis")
    if rec:
        check(all(a.dtype == torch.float32 for a in (h02, c02)), "h02 and c02 must be float32")
        check(tuple(whh2.shape) == (2, 4, H, H),
              f"whh2 must be [2, 4, {H}, {H}], got {tuple(whh2.shape)}")
        check(tuple(h02.shape) == (2, B, H) and tuple(c02.shape) == (2, B, H),
              f"h02 and c02 must be [2, {B}, {H}]")
        check(all(a.device == x.device for a in (whh2, h02, c02)), "all inputs must be on one device")
        check(h02.is_contiguous() and c02.is_contiguous(), "h02 and c02 must be contiguous")
        whh2 = whh2.to(sdt).contiguous()
    # the weights are small (2.4 MB at the flagship): W_ih is copied once a
    # call at the stream dtype, in the layout of the route that reads it
    return sdt, x.to(sdt), wih2.contiguous(), b2.contiguous(), whh2, T, B, D, H


def _fwd_outputs(sdt, T, B, H, device, residuals):
    def stream():
        return torch.empty((2, T, B, H), dtype=sdt, device=device)

    hs2 = stream()
    res = [stream() for _ in range(5)] if residuals else [None] * 5
    hT2 = torch.empty((2, B, H), dtype=torch.float32, device=device)
    return hs2, res, hT2, torch.empty_like(hT2)


def _ptr(a):
    return None if a is None else a.data_ptr()


def _proj2(x, wih2, b2, sdt):
    """The projection of both directions, W_ih read as one ``[8, D, H]``:
    ``xp2 [T, B, 8H]`` f32. f32: K1's projection kernel with 8 gates (its
    tiles picked by shape in the C entry); bf16: the tensor-core GEMM over
    W_ih transposed ``[8H, D]`` (the conversion to bf16 writes it so), for a
    D of whole 16-byte chunks (K1's kernel otherwise, by shape)."""
    global BIDIR_PROJ_LAUNCHES
    T, B, D = x.shape
    H = wih2.shape[-1]
    if sdt == torch.float32 or D % 8:
        w = wih2.to(sdt).contiguous().reshape(8, D, H)
        xp2 = _launch_proj(x, w, b2.reshape(8, H), 0 if sdt == torch.float32 else 1)
    else:
        if x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            x = x.contiguous()
        wt = wih2.reshape(8, D, H).transpose(1, 2).to(sdt, memory_format=torch.contiguous_format)
        xp2 = _launch_proj_mma(x, wt.reshape(8 * H, D), b2.reshape(8 * H))
    BIDIR_PROJ_LAUNCHES += 1
    return xp2


def bilstm_proj_fused(x, wih2, b2, compute_dtype=None):
    """The cluster route's projection kernel alone: same arguments and
    return as :func:`bilstm_proj_plain`; ``x`` may be a strided view
    contiguous over D."""
    if x.device.type == "cpu":
        return bilstm_proj_plain(x, wih2, b2, compute_dtype)
    sdt, x, wih2, b2, *_ = _fwd_checks("bilstm_proj_fused", x, wih2, b2, None, None, None,
                                       compute_dtype)
    with torch.cuda.device(x.device):
        return _proj2(x, wih2, b2, sdt)


def _bidir_fwd(fn, x, wih2, b2, whh2, h02, c02, compute_dtype, residuals, pool, geometry,
               prof=None):
    """K3 (``pool`` False) or K5 on the route of :func:`bidir_geometry` for
    this device, or of ``geometry``; returns ``(hs2, res, hT2, cT2,
    pooled)``."""
    global BIDIR_CLUSTER_CALLS, BIDIR_STREAM_CALLS
    sdt, x, wih2, b2, whh2, T, B, D, H = _fwd_checks(fn, x, wih2, b2, whh2, h02, c02,
                                                     compute_dtype)
    g = geometry or device_bidir_geometry(x.device, B, H, compute_dtype, pool)
    _check(g["route"] == "stream" or g["pool"] == pool,
           "the geometry's shared-memory layout is the other kernel's (pool differs)", fn)
    hs2, res, hT2, cT2 = _fwd_outputs(sdt, T, B, H, x.device, residuals)
    pooled = torch.empty((B, 2 * H), dtype=torch.float32, device=x.device) if pool else None
    code = 0 if sdt == torch.float32 else 1
    outs = (hs2.data_ptr(), *(_ptr(r) for r in res), hT2.data_ptr(), cT2.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if g["route"] == "cluster":
            xp2 = _proj2(x, wih2, b2, sdt)
            _launch("bilstm_fwd", "dn_bilstm_rec", code, int(pool), xp2.data_ptr(),
                    whh2.data_ptr(), h02.data_ptr(), c02.data_ptr(), *outs, _ptr(pooled), T, B, H,
                    _geom_ints(g), _ptr(prof), stream)
        else:
            _check(prof is None, "the phase clock is the cluster route's", fn)
            wih2 = wih2.to(sdt)
            head = (code, x.data_ptr(), x.stride(0), x.stride(1), wih2.data_ptr(), b2.data_ptr(),
                    whh2.data_ptr(), h02.data_ptr(), c02.data_ptr(), *outs)
            if pool:
                _launch("bilstm_fwd", "dn_bilstm_pool_fwd", *head, pooled.data_ptr(), T, B, D, H,
                        stream)
            else:
                _launch("bilstm_fwd", "dn_bilstm_fwd", *head, T, B, D, H, stream)
    if g["route"] == "cluster":
        BIDIR_CLUSTER_CALLS += 1
    else:
        BIDIR_STREAM_CALLS += 1
    return hs2, res, hT2, cT2, pooled


def bilstm_fwd_fused(x, wih2, b2, whh2, h02, c02, compute_dtype=None, residuals=True,
                     geometry=None):
    """K3: both directions' forward. Same arguments and returns as
    :func:`bilstm_fwd_plain` (without ``pool``). ``x`` may be a strided view
    (any strides over T and B, contiguous over D); the residual streams are
    written only when ``residuals=True``; ``hT2, cT2`` come from the
    kernel's f32 carries, never from the stream dtype. The route is
    :func:`device_bidir_geometry`'s (``pool=False``), or ``geometry``'s (a
    :func:`bidir_geometry` result, for measurements); a launch the card
    refuses raises, nothing falls back."""
    if x.device.type == "cpu":
        return bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype, residuals)
    hs2, res, hT2, cT2, _ = _bidir_fwd("bilstm_fwd_fused", x, wih2, b2, whh2, h02, c02,
                                       compute_dtype, residuals, False, geometry)
    global BIDIR_FWD_LAUNCHES
    BIDIR_FWD_LAUNCHES += 1
    if residuals:
        return (hs2, *res, hT2, cT2)
    return hs2, (hT2, cT2)


def bilstm_pool_fwd_fused(x, wih2, b2, whh2, h02, c02, compute_dtype=None, geometry=None):
    """K5: K3 with every residual stream, plus the time-mean pool summed in
    f32 inside the kernel. Same arguments and returns as
    :func:`bilstm_fwd_plain` with ``pool=True``: ``(hs2, cs2, i2, f2, o2,
    g2, hT2, cT2, pool [B, 2H] f32)``; routes as :func:`bilstm_fwd_fused`
    (``pool=True``)."""
    if x.device.type == "cpu":
        return bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype, pool=True)
    hs2, res, hT2, cT2, pooled = _bidir_fwd("bilstm_pool_fwd_fused", x, wih2, b2, whh2, h02,
                                            c02, compute_dtype, True, True, geometry)
    global POOL_FWD_LAUNCHES
    POOL_FWD_LAUNCHES += 1
    return (hs2, *res, hT2, cT2, pooled)


def bidir_phase_profile(x, wih2, b2, whh2, h02, c02, compute_dtype=None, geometry=None,
                        pool: bool = True) -> dict:
    """One K5 (or, ``pool=False``, K3) call on the cluster route with its
    phase clock on: the mean µs a step of block 0 (direction 0) spends in
    each phase (``ops/lstm_cuda.py:K1_PHASES``) and each phase's share. For
    measurements: it counts one projection launch (``BIDIR_PROJ_LAUNCHES``)
    and one cluster-route call (``BIDIR_CLUSTER_CALLS``), but no K3 or K5
    call (``BIDIR_FWD_LAUNCHES``, ``POOL_FWD_LAUNCHES``)."""
    T, B, _ = x.shape
    g = geometry or device_bidir_geometry(x.device, B, wih2.shape[-1], compute_dtype, pool)
    _check(g["route"] == "cluster", "the phase clock is the cluster route's", "bidir_phase_profile")
    prof = torch.zeros(5 * T + 2, dtype=torch.int64, device=x.device)
    _bidir_fwd("bidir_phase_profile", x, wih2, b2, whh2, h02, c02, compute_dtype, pool, pool, g,
               prof)
    return phase_summary(prof, T)


def _bwd_checks(fn, streams, whh2, c02, dhT2, dcT2, compute_dtype):
    """Validates a backward call; returns ``(sdt, T, B, H, W_hhᵀ [2, 4, H,
    H] contiguous at the stream dtype)``."""

    def check(cond, what):
        _check(cond, what, fn)

    cs2 = streams[4]
    check(cs2.device.type == "cuda", f"unsupported device {cs2.device}")
    sdt = _stream_dtype(compute_dtype)
    check(cs2.dim() == 4 and cs2.shape[0] == 2, f"cs2 must be [2, T, B, H], got {tuple(cs2.shape)}")
    _, T, B, H = cs2.shape
    check(all(tuple(a.shape) == (2, T, B, H) and a.dtype == sdt and a.is_contiguous()
              for a in streams), f"ai2, af2, ao2, ag2 and cs2 must be contiguous [2, {T}, {B}, {H}] {sdt}")
    check(tuple(whh2.shape) == (2, 4, H, H), f"whh2 must be [2, 4, {H}, {H}], got {tuple(whh2.shape)}")
    carries = (c02, dhT2, dcT2)
    check(all(tuple(a.shape) == (2, B, H) and a.dtype == torch.float32 and a.is_contiguous()
              for a in carries), f"c02, dhT2 and dcT2 must be contiguous [2, {B}, {H}] float32")
    check(all(a.device == cs2.device for a in streams + carries + (whh2,)),
          "all inputs must be on one device")
    return sdt, T, B, H, whh2.to(sdt).transpose(2, 3).contiguous()


def _bwd_outputs(sdt, T, B, H, device):
    dp = torch.empty((T, B, 8 * H), dtype=sdt, device=device)
    dh02 = torch.empty((2, B, H), dtype=torch.float32, device=device)
    return dp, dh02, torch.empty_like(dh02)


def bilstm_bwd_fused(ai2, af2, ao2, ag2, cs2, whh2, c02, dhsf, dhsr, dhT2, dcT2,
                     compute_dtype=None, geometry=None):
    """K4: both directions' backward in one launch. Same arguments and
    returns as :func:`bilstm_bwd_plain`. ``dhsf, dhsr`` are at the stream
    dtype, each a ``[T, B, H]`` view contiguous over H or a ``[1, B, H]``
    per-row constant (read at every step, never broadcast in memory). The
    route is :func:`device_k4_geometry`'s, or ``geometry``'s (a
    :func:`bidir_bwd_geometry` result, for measurements); a launch the card
    refuses raises, nothing falls back."""
    streams = (ai2, af2, ao2, ag2, cs2)
    if cs2.device.type == "cpu":
        return bilstm_bwd_plain(*streams, whh2, c02, dhsf, dhsr, dhT2, dcT2, compute_dtype)
    return _k4(streams, whh2, c02, dhsf, dhsr, dhT2, dcT2, compute_dtype, geometry)


def _k4(streams, whh2, c02, dhsf, dhsr, dhT2, dcT2, compute_dtype, geometry, prof=None):
    global BIDIR_BWD_LAUNCHES, K4_CLUSTER_CALLS, K4_STREAM_CALLS
    fn, dev = "bilstm_bwd_fused", streams[4].device
    sdt, T, B, H, wT = _bwd_checks(fn, streams, whh2, c02, dhT2, dcT2, compute_dtype)
    for name, d in (("dhsf", dhsf), ("dhsr", dhsr)):
        _check(d.dim() == 3 and d.shape[0] in (1, T) and tuple(d.shape[1:]) == (B, H)
               and d.dtype == sdt and d.stride(-1) == 1 and d.device == dev,
               f"{name} must be [{T} or 1, {B}, {H}] {sdt}, contiguous in its last axis", fn)
    g = geometry or device_k4_geometry(dev, B, H, compute_dtype)
    _check(g.get("dirs") == 2, "the geometry is K2's (one direction)", fn)

    def time_stride(d):
        return d.stride(0) if d.shape[0] == T and T > 1 else 0

    dp, dh02, dc02 = _bwd_outputs(sdt, T, B, H, dev)
    with torch.cuda.device(dev):
        _launch("bilstm_bwd", "dn_bilstm_bwd", 0 if sdt == torch.float32 else 1,
                *(a.data_ptr() for a in streams), wT.data_ptr(), c02.data_ptr(),
                dhsf.data_ptr(), time_stride(dhsf), dhsf.stride(1),
                dhsr.data_ptr(), time_stride(dhsr), dhsr.stride(1),
                dhT2.data_ptr(), dcT2.data_ptr(), dp.data_ptr(), dh02.data_ptr(),
                dc02.data_ptr(), T, B, H, _geom_ints(g), _ptr(prof),
                torch.cuda.current_stream(dev).cuda_stream)
    BIDIR_BWD_LAUNCHES += 1
    if g["route"] == "cluster":
        K4_CLUSTER_CALLS += 1
    else:
        K4_STREAM_CALLS += 1
    return dp, dh02, dc02


def k4_phase_profile(ai2, af2, ao2, ag2, cs2, whh2, c02, dhsf, dhsr, dhT2, dcT2,
                     compute_dtype=None, geometry=None) -> dict:
    """One K4 call on the cluster route with its phase clock on: the mean µs
    a step of block 0 (direction 0) spends in each of
    ``ops/lstm_cuda.py:BWD_PHASES`` and each phase's share. For
    measurements; counts as a call."""
    T, B, H = cs2.shape[1:]
    g = geometry or device_k4_geometry(cs2.device, B, H, compute_dtype)
    _check(g["route"] == "cluster", "the phase clock is the cluster route's", "k4_phase_profile")
    prof = torch.zeros(5 * T + 2, dtype=torch.int64, device=cs2.device)
    _k4((ai2, af2, ao2, ag2, cs2), whh2, c02, dhsf, dhsr, dhT2, dcT2, compute_dtype, g, prof)
    return phase_summary(prof, T, BWD_PHASES)


def bilstm_pool_bwd_fused(ai2, af2, ao2, ag2, cs2, whh2, c02, dpoolf, dpoolr, dhT2, dcT2,
                          compute_dtype=None, geometry=None):
    """K6: the backward of the time-mean pool, both directions in one
    launch. ``dpoolf, dpoolr [B, H]`` f32 are the pool's cotangent already
    divided by T, a per-row constant at every step (kept in f32 at any
    stream dtype). Returns as :func:`bilstm_bwd_plain`. The route is
    :func:`device_bidir_bwd_geometry`'s, or ``geometry``'s (a
    :func:`bidir_bwd_geometry` result, for measurements); a launch the card
    refuses raises, nothing falls back."""
    streams = (ai2, af2, ao2, ag2, cs2)
    if cs2.device.type == "cpu":
        return bilstm_bwd_plain(*streams, whh2, c02, dpoolf[None], dpoolr[None], dhT2, dcT2,
                                compute_dtype)
    return _k6(streams, whh2, c02, dpoolf, dpoolr, dhT2, dcT2, compute_dtype, geometry)


def _k6(streams, whh2, c02, dpoolf, dpoolr, dhT2, dcT2, compute_dtype, geometry, prof=None):
    global POOL_BWD_LAUNCHES, BIDIR_BWD_CLUSTER_CALLS, BIDIR_BWD_STREAM_CALLS
    fn, dev = "bilstm_pool_bwd_fused", streams[4].device
    sdt, T, B, H, wT = _bwd_checks(fn, streams, whh2, c02, dhT2, dcT2, compute_dtype)
    _check(all(tuple(d.shape) == (B, H) and d.dtype == torch.float32 and d.is_contiguous()
               and d.device == dev for d in (dpoolf, dpoolr)),
           f"dpoolf and dpoolr must be contiguous [{B}, {H}] float32", fn)
    g = geometry or device_bidir_bwd_geometry(dev, B, H, compute_dtype)
    _check(g.get("dirs") == 2, "the geometry is K2's (one direction)", fn)
    dp, dh02, dc02 = _bwd_outputs(sdt, T, B, H, dev)
    with torch.cuda.device(dev):
        _launch("bilstm_bwd", "dn_bilstm_pool_bwd", 0 if sdt == torch.float32 else 1,
                *(a.data_ptr() for a in streams), wT.data_ptr(), c02.data_ptr(),
                dpoolf.data_ptr(), dpoolr.data_ptr(), dhT2.data_ptr(), dcT2.data_ptr(),
                dp.data_ptr(), dh02.data_ptr(), dc02.data_ptr(), T, B, H, _geom_ints(g),
                _ptr(prof), torch.cuda.current_stream(dev).cuda_stream)
    POOL_BWD_LAUNCHES += 1
    if g["route"] == "cluster":
        BIDIR_BWD_CLUSTER_CALLS += 1
    else:
        BIDIR_BWD_STREAM_CALLS += 1
    return dp, dh02, dc02


def bidir_bwd_phase_profile(ai2, af2, ao2, ag2, cs2, whh2, c02, dpoolf, dpoolr, dhT2, dcT2,
                            compute_dtype=None, geometry=None) -> dict:
    """One K6 call on the cluster route with its phase clock on: the mean µs
    a step of block 0 (direction 0) spends in each of
    ``ops/lstm_cuda.py:BWD_PHASES`` and each phase's share. For
    measurements; counts as a call."""
    T, B, H = cs2.shape[1:]
    g = geometry or device_bidir_bwd_geometry(cs2.device, B, H, compute_dtype)
    _check(g["route"] == "cluster", "the phase clock is the cluster route's",
           "bidir_bwd_phase_profile")
    prof = torch.zeros(5 * T + 2, dtype=torch.int64, device=cs2.device)
    _k6((ai2, af2, ao2, ag2, cs2), whh2, c02, dpoolf, dpoolr, dhT2, dcT2, compute_dtype, g, prof)
    return phase_summary(prof, T, BWD_PHASES)


# ---------------------------------------------------------------------------
# the differentiable ops


def _weight_grads(needs_dx, x, wih2, hs2, h02, dp, compute_dtype, sites):
    """The products that JAX's ``_bidir_weight_grads`` computes outside its
    kernels, from the backward's ``dp [T, R, 8H]`` (both directions in
    x-time): ``dx`` and ``dW_ih`` as single products against the 8H concat,
    ``db`` its sum, ``dW_hh`` per direction against ``h_prev`` in x-time
    (forward ``[h0; hs[:-1]]``, reverse ``[hs[1:]; h0]``), each accumulated
    in f32 from operands rounded to the compute dtype. With ``sites`` the
    rows are ``S`` site-major blocks and the weight gradients come back per
    site ``[S, ...]``."""
    T, R, D = x.shape
    H = hs2.shape[-1]
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    dpf = dp.to(cdt).float()
    dx = None
    if needs_dx:
        w_cat8 = torch.cat([wih2[d].permute(1, 0, 2).reshape(D, 4 * H) for d in (0, 1)], -1)
        dx = torch.matmul(dpf, w_cat8.to(cdt).float().T).to(x.dtype)
    xf = x.to(cdt).float()
    h_prev = torch.stack([
        torch.cat([h02[0][None].to(hs2.dtype), hs2[0, :-1]], 0),
        torch.cat([hs2[1, 1:], h02[1][None].to(hs2.dtype)], 0),
    ]).to(cdt).float()  # [2, T, R, H]
    if sites:
        S = sites
        xv, dpv = xf.reshape(T, S, R // S, D), dpf.reshape(T, S, R // S, 8 * H)
        dwih = torch.einsum("tsbd,tsbg->sdg", xv, dpv).reshape(S, D, 2, 4, H).permute(0, 2, 3, 1, 4)
        db = dpv.sum((0, 2)).reshape(S, 2, 4, H)
        dwhh = torch.einsum("dtsbh,tsbdg->sdhg", h_prev.reshape(2, T, S, R // S, H),
                            dpv.reshape(T, S, R // S, 2, 4 * H))
        dwhh = dwhh.reshape(S, 2, H, 4, H).permute(0, 1, 3, 2, 4)
    else:
        dwih = torch.einsum("tbd,tbg->dg", xf, dpf).reshape(D, 2, 4, H).permute(1, 2, 0, 3)
        db = dpf.sum((0, 1)).reshape(2, 4, H)
        dwhh = torch.einsum("dtbh,tbdg->dhg", h_prev, dpf.reshape(T, R, 2, 4 * H))
        dwhh = dwhh.reshape(2, H, 4, H).permute(0, 2, 1, 3)
    return dx, dwih, db, dwhh


def _sites_of(wih2) -> int:
    return wih2.shape[0] if wih2.dim() == 5 else 0


def _blocks(sites, wih2, b2, whh2):
    return tuple(_site_weight(w, sites) for w in (wih2, b2, whh2))


class BiLSTMRecurrence(torch.autograd.Function):
    """The sequence-returning op, JAX's ``bilstm_recurrence_fused``:
    ``apply(x [T, R, D], wih2, b2, whh2, h02, c02, compute_dtype,
    use_kernel) -> (hs_f, hs_r [T, R, H] in x-time, hT2, cT2)``.

    Forward: K3 with its residual streams (its plain version when
    ``use_kernel`` is False); backward: K4 with both cotangent streams, then
    the weight-gradient products (``_vjp_bidir_bwd``). Site-batched weights
    ``[S, 2, ...]`` of stride 0 fold the sites into the kernels' rows (the
    JAX ``custom_vmap`` fold) and get per-site gradients."""

    @staticmethod
    def forward(ctx, x, wih2, b2, whh2, h02, c02, compute_dtype=None, use_kernel=True):
        sites = _sites_of(wih2)
        wih, b, whh = _blocks(sites, wih2, b2, whh2)
        fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
        hs2, cs2, i2, f2, o2, g2, hT2, cT2 = fwd(x, wih, b, whh, h02, c02, compute_dtype)
        ctx.save_for_backward(x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return hs2[0], hs2[1], hT2, cT2

    @staticmethod
    def backward(ctx, dhsf, dhsr, dhT2, dcT2):
        x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2 = ctx.saved_tensors
        sdt = _stream_dtype(ctx.compute_dtype)
        zero = torch.zeros_like(h02)

        def stream_cot(d):
            if d is None:
                return torch.zeros_like(hs2[0])
            d = d.to(sdt)
            return d if d.stride(-1) == 1 else d.contiguous()

        bwd = bilstm_bwd_fused if ctx.use_kernel else bilstm_bwd_plain
        dp, dh02, dc02 = bwd(i2, f2, o2, g2, cs2, whh, c02, stream_cot(dhsf), stream_cot(dhsr),
                             zero if dhT2 is None else dhT2.float().contiguous(),
                             zero if dcT2 is None else dcT2.float().contiguous(),
                             ctx.compute_dtype)
        dx, dwih, db, dwhh = _weight_grads(ctx.needs_input_grad[0], x, wih, hs2, h02, dp,
                                           ctx.compute_dtype, ctx.sites)
        return dx, dwih, db, dwhh, dh02, dc02, None, None


def _pool_forward(x, wih, b, whh, h02, c02, compute_dtype, use_kernel, sites, residuals):
    """The pooled op's forward, dispatched as JAX's ``_pool_fwd_kcall``:
    K5 for site-batched weights (the pool from the kernel's f32 sums), K3
    otherwise (the pool the f32 mean of the stream-dtype ``hs``). Returns
    ``(pooled [R, 2H] f32, hT2, cT2, streams or None)``."""
    if sites:
        args = (x, wih, b, whh, h02, c02, compute_dtype)
        *streams, hT2, cT2, pooled = (bilstm_pool_fwd_fused(*args) if use_kernel
                                      else bilstm_fwd_plain(*args, pool=True))
        return pooled, hT2, cT2, streams
    fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
    out = fwd(x, wih, b, whh, h02, c02, compute_dtype, residuals)
    if residuals:
        *streams, hT2, cT2 = out
        hs2 = streams[0]
    else:
        (hs2, (hT2, cT2)), streams = out, None
    pooled = hs2.mean(1, dtype=torch.float32)  # [2, R, H]
    return torch.cat([pooled[0], pooled[1]], -1), hT2, cT2, streams


class BiLSTMPool(torch.autograd.Function):
    """The pooled op, JAX's ``bilstm_pool_fused_op``: ``apply(x [T, R, D],
    wih2, b2, whh2, h02, c02, compute_dtype, use_kernel) -> (pooled [R, 2H]
    f32, hT2, cT2)``, ``pooled`` the concat of each direction's time mean.

    Unbatched weights: K3 forward and K4 backward with the cotangent
    ``dpool / T`` cast to the stream dtype as a per-row constant.
    Site-batched weights ``[S, 2, ...]`` of stride 0: K5 forward and K6
    backward with ``dpool / T`` in f32, per-site weight gradients. The
    plain versions replace the kernels when ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, wih2, b2, whh2, h02, c02, compute_dtype=None, use_kernel=True):
        sites = _sites_of(wih2)
        wih, b, whh = _blocks(sites, wih2, b2, whh2)
        pooled, hT2, cT2, streams = _pool_forward(x, wih, b, whh, h02, c02, compute_dtype,
                                                  use_kernel, sites, True)
        ctx.save_for_backward(x, wih, whh, h02, c02, *streams)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return pooled, hT2, cT2

    @staticmethod
    def backward(ctx, dpooled, dhT2, dcT2):
        x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2 = ctx.saved_tensors
        T, H = x.shape[0], hs2.shape[-1]
        zero = torch.zeros_like(h02)
        if dpooled is None:
            dpooled = torch.zeros((x.shape[1], 2 * H), dtype=torch.float32, device=x.device)
        dpoolf = (dpooled[:, :H].float() / T).contiguous()
        dpoolr = (dpooled[:, H:].float() / T).contiguous()
        carries = (zero if dhT2 is None else dhT2.float().contiguous(),
                   zero if dcT2 is None else dcT2.float().contiguous())
        streams = (i2, f2, o2, g2, cs2)
        cdt = ctx.compute_dtype
        if ctx.sites and ctx.use_kernel:  # K6: the constant stays f32
            dp, dh02, dc02 = bilstm_pool_bwd_fused(*streams, whh, c02, dpoolf, dpoolr, *carries,
                                                   cdt)
        else:  # K4, or a plain version: the constant [1, R, H]
            if not ctx.sites:  # K4's constant is at the stream dtype
                sdt = _stream_dtype(cdt)
                dpoolf, dpoolr = dpoolf.to(sdt), dpoolr.to(sdt)
            bwd = bilstm_bwd_fused if ctx.use_kernel else bilstm_bwd_plain
            dp, dh02, dc02 = bwd(*streams, whh, c02, dpoolf[None], dpoolr[None], *carries, cdt)
        dx, dwih, db, dwhh = _weight_grads(ctx.needs_input_grad[0], x, wih, hs2, h02, dp, cdt,
                                           ctx.sites)
        return dx, dwih, db, dwhh, dh02, dc02, None, None


class _StackDirections(torch.autograd.Function):
    """One weight of both directions in model layout (``[..., 4H]``, the
    gate blocks side by side, optionally a stride-0 site axis ``[S, ...]``)
    → JAX's stacked layout ``[(S,) 2, 4, ..., H]``. Only the one block of
    each direction is stacked; the site axis stays stride 0. The backward
    hands each direction its (per-site) gradient in model layout."""

    @staticmethod
    def forward(ctx, w_f, w_r, sites):
        blocks = [_site_weight(w, sites) for w in (w_f, w_r)]
        lead, H = tuple(blocks[0].shape[:-1]), blocks[0].shape[-1] // 4
        st = torch.stack([b.float().reshape(*lead, 4, H).movedim(-2, 0) for b in blocks])
        ctx.sites = sites
        return st.expand(sites, *st.shape) if sites else st

    @staticmethod
    def backward(ctx, g):
        off = 1 if ctx.sites else 0
        out = []
        for d in (0, 1):
            gd = g.select(off, d).movedim(off, -2)  # [(S,) ..., 4, H]
            out.append(gd.reshape(*gd.shape[:-2], -1))
        return out[0], out[1], None


def _model_layout(op, use_kernel, x, params_fwd, params_rev, h02, c02, compute_dtype):
    """``x [B, T, D]``; ``params_*``: ``(w_ih [D, 4H], b [4H], w_hh [H,
    4H])``, each optionally site-batched ``[S, ...]`` of stride 0."""
    B, T, D = x.shape
    H = params_fwd[2].shape[-2]
    sites = params_fwd[0].shape[0] if params_fwd[0].dim() == 3 else 0
    wih2, b2, whh2 = (_StackDirections.apply(f, r, sites) for f, r in zip(params_fwd, params_rev))
    zeros = torch.zeros((2, B, H), dtype=torch.float32, device=x.device)
    h02 = zeros if h02 is None else h02.float().contiguous()
    c02 = zeros if c02 is None else c02.float().contiguous()
    xk = x.to(compute_dtype if compute_dtype is not None else torch.float32).transpose(0, 1)
    args = (xk, wih2, b2, whh2, h02, c02)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if op == "pool":
        if grad:
            pooled, hT2, cT2 = BiLSTMPool.apply(*args, compute_dtype, use_kernel)
        else:  # inference: no residual streams
            blocks = _blocks(sites, wih2, b2, whh2)
            pooled, hT2, cT2, _ = _pool_forward(xk, *blocks, h02, c02, compute_dtype, use_kernel,
                                                sites, False)
        return pooled, (hT2, cT2)
    if grad:
        hsf, hsr, hT2, cT2 = BiLSTMRecurrence.apply(*args, compute_dtype, use_kernel)
    else:
        fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
        hs2, (hT2, cT2) = fwd(xk, *_blocks(sites, wih2, b2, whh2), h02, c02, compute_dtype,
                              residuals=False)
        hsf, hsr = hs2[0], hs2[1]
    return hsf.transpose(0, 1).to(x.dtype), hsr.transpose(0, 1).to(x.dtype), (hT2, cT2)


def bilstm_forward_fused(x, params_fwd, params_rev, h02=None, c02=None, compute_dtype=None):
    """Model-layout wrapper over :class:`BiLSTMRecurrence` (JAX's
    ``bilstm_forward_fused``): ``x [B, T, D]``, ``params_fwd / params_rev =
    (w_ih [D, 4H], b [4H] = b_ih + b_hh, w_hh [H, 4H])``, optionally
    site-batched ``[S, ...]`` of stride 0; ``h02, c02 [2, B, H]`` (zeros by
    default). Returns ``(hs_f [B, T, H], hs_r [B, T, H] in x-time, (hT2,
    cT2) [2, B, H] f32)`` at x's dtype. Without gradients, K3 alone."""
    return _model_layout("seq", True, x, params_fwd, params_rev, h02, c02, compute_dtype)


def bilstm_pool_forward_fused(x, params_fwd, params_rev, h02=None, c02=None,
                              compute_dtype=None):
    """Model-layout wrapper over :class:`BiLSTMPool` (JAX's
    ``bilstm_pool_forward_fused``), arguments as
    :func:`bilstm_forward_fused`. Returns ``(pooled [B, 2H] f32, (hT2, cT2)
    [2, B, H] f32)``. Unbatched weights run K3 (and K4 backward),
    site-batched ones K5 and K6; without gradients the unbatched forward
    writes no residual streams."""
    return _model_layout("pool", True, x, params_fwd, params_rev, h02, c02, compute_dtype)


def bilstm_pool_forward_plain(x, params_fwd, params_rev, h02=None, c02=None,
                              compute_dtype=None):
    """:func:`bilstm_pool_forward_fused` through the plain versions on any
    device: the reference that the card's kernel path is held against."""
    return _model_layout("pool", False, x, params_fwd, params_rev, h02, c02, compute_dtype)
