"""The fused LSTM recurrence, forward and backward: CUDA kernels for the
card, their plain PyTorch versions beside them.

Counterpart of the JAX package's ``ops/lstm_pallas.py`` single-direction
path (``_fwd_fused_kernel`` and ``_bwd_kernel`` behind
``lstm_recurrence_fused`` and ``lstm_forward_fused``), with the same
signatures and layouts:

- ``x [T, B, D]`` raw per-step inputs: K1 computes the i2h projection
  itself, as the TPU kernel does (here in a launch of its own);
- ``wih4 [4, D, H]``, ``b4 [4, H]``, ``whh4 [4, H, H]``, gates in the order
  i, f, o, g (not ``torch.nn.LSTM``'s i, f, g, o);
- ``h0, c0 [B, H]`` f32.

Kernel sources: ``csrc/lstm_fwd.cu`` (K1) and ``csrc/lstm_bwd.cu`` (K2).
:func:`lstm_recurrence_fused` and :func:`lstm_bwd_fused` launch them for
CUDA tensors and raise on anything they do not take; for CPU tensors, and
only for them, they run :func:`lstm_recurrence_plain` and
:func:`lstm_bwd_plain`. ``LAUNCHES`` and ``BWD_LAUNCHES`` count K1 and K2
calls, so a run can show that it went through the kernels.

K1 is two device launches a call. The i2h projection ``xp = x W_ih + b``
(:func:`lstm_proj_fused`, ``PROJ_LAUNCHES``) fills an f32 scratch ``[T, B,
4H]``; the recurrence over it runs on one of two routes, chosen by shape
before any launch (:func:`k1_geometry`): over a thread-block cluster that
holds W_hh in shared memory (``K1_CLUSTER_CALLS``), or, for a W_hh whose
slice fits no cluster of 8, streaming W_hh from L2 every step
(``K1_STREAM_CALLS``).

K2 takes one of two routes the same way (:func:`bwd_geometry`): a cluster
BPTT whose blocks hold their rows of W_hhᵀ in shared memory and
reduce-scatter dh through distributed shared memory
(``csrc/lstm_bwd_cluster.cuh``, ``BWD_CLUSTER_CALLS``; f32 on a SIMT
kernel, bf16 on the tensor cores), or the first design, streaming W_hhᵀ
from L2 every step (``BWD_STREAM_CALLS``).

:class:`LSTMRecurrence` is the differentiable recurrence: K1 with its
residual streams forward, K2 and the weight-gradient products backward, as
the JAX ``custom_vjp``. Its weights may carry a leading site axis
``[S, ...]`` of stride 0 (every site holds the same values): the rows of
``x`` are then ``S`` blocks of ``B / S`` rows, one block per site, the
kernels run once over all rows, and the weight gradients come back per
site, as the JAX ``custom_vmap`` fold computes them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: K1 calls since the counter was last set to 0
LAUNCHES = 0
#: K1 calls whose recurrence took the cluster route / the streaming route
K1_CLUSTER_CALLS = 0
K1_STREAM_CALLS = 0
#: launches of K1's projection kernel
PROJ_LAUNCHES = 0
#: K2 launches since the counter was last set to 0
BWD_LAUNCHES = 0
#: K2 launches on the cluster route / the stream route
BWD_CLUSTER_CALLS = 0
BWD_STREAM_CALLS = 0

_entries: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "lstm_proj": ("lstm_fwd", [_I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _P, _I, _I, _I, _I, _P]),
    "lstm_rec": ("lstm_fwd", [_I, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _P, _P, _P]),
    "lstm_max_active_clusters": ("lstm_fwd", [_I, _I, _I, _P, _P]),
    "lstm_proj_mma": ("lstm_fwd", [_P, _L, _L, _P, _L, _P, _P, _I, _I, _I, _I, _P]),
    "lstm_bwd": ("lstm_bwd", [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _L, _L,
                              _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]),
    "lstm_bwd_max_active_clusters": ("lstm_bwd", [_I, _I, _I, _P, _P]),
}


def _kernel(name: str):
    """``(entry, error_string)`` of C entry ``dn_<name>``, its source built
    on first use."""
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


# ---------------------------------------------------------------------------
# K1's launch geometry (pure shape arithmetic, tested on the CPU)

#: cluster sizes of K1's recurrence, smallest first (8 is the portable most)
K1_CLUSTER_SIZES = (2, 4, 8)
#: the dynamic shared memory a block may opt in to on an H100
SMEM_OPTIN = 232448
#: ints of the geometry record ``csrc/lstm_fwd.cu`` reads (kGeomLen)
_GEOM_LEN = 17
#: static shared memory of the cluster kernel beside its dynamic share
#: (the column map and the owner of each unit, 548 bytes), kept free of the
#: opt-in
_CLUSTER_STATIC_SMEM = 1024
#: the widest H the cluster kernel takes (its owner table, kMaxClusterH)
K1_CLUSTER_MAX_H = 512


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k1_column_map(H: int, C: int) -> list[int]:
    """``j0``: rank ``k`` of a cluster of ``C`` owns hidden units ``[j0[k],
    j0[k + 1])`` and all four gates of them; the first ``H % C`` ranks own
    one unit more."""
    base, extra = divmod(H, C)
    return [k * base + min(k, extra) for k in range(C + 1)]


def _cluster_config(R: int, H: int, C: int, es: int, smem_optin: int, pool: bool = False,
                    cols_a_thread: int = 1, rpts=(8, 4, 2, 1), max_threads: int = 1024) -> dict | None:
    """Threads and shared memory of a cluster block that carries ``R`` rows,
    or None if none fits: ``threads = cp · row_groups`` (``cp``, the own
    gate columns ``4·smax`` over ``cols_a_thread`` columns a thread, rounded
    up to a warp; each thread ``rpt`` rows), shared memory the layout the
    kernel carves: the W_hh slice ``[H, 4·smax]`` at the operand type, then
    f32 h of all units ``[H, rp]``, the own h slice double-buffered ``[2,
    smax, rp | 1]``, ``pre [rp, 4·smax]``, the carry ``[rp, smax]`` and, with
    ``pool``, the pool sums ``[rp, smax]``. Of the rows a thread may carry
    (``rpts``), the one that pads the fewest rows. K1: one column a thread,
    no pool; K3/K5 (``ops/bilstm_cuda.py``) take two columns a thread."""
    if H > K1_CLUSTER_MAX_H:
        return None
    smax = _cdiv(H, C)
    wst = 4 * smax
    cp = _cdiv(_cdiv(wst, cols_a_thread), 32) * 32
    best = None
    for rpt in rpts:
        rg = _cdiv(R, rpt)
        rp, threads = rg * rpt, cp * rg
        smem = (_cdiv(H * wst * es, 16) * 16
                + 4 * (H * rp + 2 * smax * (rp | 1) + rp * wst + rp * smax * (2 if pool else 1)))
        fits = smem + _CLUSTER_STATIC_SMEM <= smem_optin
        if threads <= max_threads and fits and (best is None or rp < best["rp"]):
            best = {"rpt": rpt, "row_groups": rg, "rp": rp, "threads": threads, "smem": smem,
                    "smax": smax}
    return best


def k1_cluster_geometry(rows: int, H: int, C: int, R: int, dtype=None,
                        smem_optin: int = SMEM_OPTIN, slots: int | None = None) -> dict | None:
    """The cluster route's geometry for clusters of ``C`` blocks of ``R``
    rows each, or None if such a block does not fit; ``slots`` is the
    clusters the card runs at once (for ``waves``)."""
    cfg = _cluster_config(R, H, C, 2 if dtype == torch.bfloat16 else 4, smem_optin)
    if cfg is None:
        return None
    clusters = _cdiv(rows, R)
    return {"route": "cluster", "C": C, "R": R, **cfg, "j0": k1_column_map(H, C),
            "clusters": clusters, "blocks": clusters * C,
            "waves": _cdiv(clusters, slots) if slots else None}


def k1_geometry(rows: int, H: int, dtype=None, sms: int = 132,
                smem_optin: int = SMEM_OPTIN, cluster_slots: dict | None = None) -> dict:
    """The launch geometry of K1's recurrence for ``rows`` rows of width
    ``H`` at the operand dtype (None: f32; ``torch.bfloat16``) on a card of
    ``sms`` SMs whose blocks may opt in to ``smem_optin`` bytes;
    ``cluster_slots`` maps a cluster size to the clusters the card runs at
    once (``cudaOccupancyMaxActiveClusters``; default ``sms // C``).

    Cluster route: the smallest cluster size ``C`` (2, 4, 8) whose block
    fits with ``R``, the rows a cluster, the fewest that keep the clusters
    within one wave; failing that, the smallest ``C`` that fits a row at
    all, with as many rows a cluster as fit (several waves). Streaming
    route, for a W_hh whose slice fits no cluster of 8: 1, 2, 4 or 8 rows a
    block, the fewest that keep the blocks within one wave. Returns a dict
    with ``route`` and the numbers the C entry takes."""
    slots = {C: (cluster_slots or {}).get(C, sms // C) for C in K1_CLUSTER_SIZES}
    sizes = [C for C in K1_CLUSTER_SIZES if C <= H and slots[C] >= 1]
    for wave_only in (True, False):
        for C in sizes:
            R = _cdiv(rows, slots[C])
            g = k1_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C])
            while g is None and not wave_only and R > 1:
                R = R // 2 if R > 64 else R - 1
                g = k1_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C])
            if g is not None:
                return g
    return k1_stream_geometry(rows, H, sms, smem_optin)


def k1_stream_geometry(rows: int, H: int, sms: int = 132, smem_optin: int = SMEM_OPTIN) -> dict:
    """The streaming route's geometry: ``R`` of 1, 2, 4, 8 rows a block, the
    fewest that keep the blocks within one wave, each block's h, carry and
    pre-activations f32 in shared memory. :func:`k1_geometry` takes it only
    for a W_hh that fits no cluster; measurements may ask for it."""
    R = 1
    while R < 8 and _cdiv(rows, R) > sms:
        R *= 2
    while R > 1 and 4 * R * 6 * H > smem_optin:
        R //= 2
    if 4 * R * 6 * H > smem_optin:
        raise ValueError(f"K1 takes no H of {H}: one row needs {4 * 6 * H} bytes of shared memory")
    blocks = _cdiv(rows, R)
    return {"route": "stream", "R": R, "threads": min(1024, _cdiv(4 * H, 32) * 32),
            "smem": 4 * R * 6 * H, "blocks": blocks, "waves": _cdiv(blocks, sms)}


def _geom_ints(g: dict):
    """The geometry record the C entry reads (see ``csrc/lstm_fwd.cu``)."""
    v = [0] * _GEOM_LEN
    if g["route"] == "cluster":
        v[:8] = [1, g["C"], g["R"], g["rpt"], g["row_groups"], g["threads"], g["smem"], g["smax"]]
        v[8:9 + g["C"]] = g["j0"]
    else:
        v[2], v[5], v[6] = g["R"], g["threads"], g["smem"]
    return (ctypes.c_int * _GEOM_LEN)(*v)


_limits: dict = {}


def device_limits(device) -> tuple[int, int]:
    """``(SMs, opt-in shared memory a block)`` of a CUDA device, read once."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _limits:
        p = torch.cuda.get_device_properties(idx)
        _limits[idx] = (p.multi_processor_count,
                        getattr(p, "shared_memory_per_block_optin", SMEM_OPTIN))
    return _limits[idx]


def settle_geometry(pick, occupancy) -> dict:
    """The geometry ``pick(slots)`` gives once ``slots`` (cluster size →
    clusters the card runs at once) holds what ``occupancy(g)``
    (``cudaOccupancyMaxActiveClusters`` of a cluster geometry) says: a GPC
    holds whole clusters only, so fewer than ``SMs // C``. The geometry is
    worked out again until all its clusters (``blocks // C``) fit that
    count, or no other cluster size is left to ask."""
    slots: dict = {}
    g = pick(None)
    while g["route"] == "cluster" and g["C"] not in slots:
        n = occupancy(g)
        slots[g["C"]] = n
        if n >= g["blocks"] // g["C"]:
            return {**g, "waves": 1}
        g = pick(slots)
    return g


_geometries: dict = {}


def device_geometry(device, rows: int, H: int, compute_dtype=None) -> dict:
    """:func:`k1_geometry` on ``device``'s SM count and shared memory, with
    the clusters the card runs at once from ``cudaOccupancyMaxActiveClusters``
    (:func:`settle_geometry`). Worked out once per device and shape."""
    dev = torch.device(device)
    key = (dev, rows, H, compute_dtype == torch.bfloat16)
    if key not in _geometries:
        sms, optin = device_limits(dev)
        _geometries[key] = settle_geometry(
            lambda slots: k1_geometry(rows, H, compute_dtype, sms, optin, slots),
            lambda g: k1_max_active_clusters(dev, rows, H, compute_dtype, g))
    return _geometries[key]


_occupancy: dict = {}


def cluster_occupancy(entry, key, *args) -> int:
    """``cudaOccupancyMaxActiveClusters`` through the C entry ``entry =
    (fn, error_string)``, called as ``fn(*args, &out)`` on the current
    device; asked once per ``key``."""
    if key not in _occupancy:
        fn, err_str = entry
        out = ctypes.c_int(0)
        err = fn(*args, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {err_str(err).decode()}")
        _occupancy[key] = out.value
    return _occupancy[key]


def k1_max_active_clusters(device, rows: int, H: int, compute_dtype=None,
                           geometry: dict | None = None) -> int | None:
    """``cudaOccupancyMaxActiveClusters`` of K1's cluster recurrence at this
    geometry, asked once per device and configuration; None on the
    streaming route."""
    g = geometry or device_geometry(device, rows, H, compute_dtype)
    if g["route"] != "cluster":
        return None
    dev = torch.device(device)
    code = 0 if compute_dtype is None else 1
    geom = _geom_ints(g)
    with torch.cuda.device(dev):
        return cluster_occupancy(_kernel("lstm_max_active_clusters"),
                                 ("k1", dev, code, rows, H, tuple(geom)), code, rows, H, geom)


# ---------------------------------------------------------------------------
# The cluster BPTT's launch geometry, K2's and (``dirs=2``) K6's (pure shape
# arithmetic, tested on the CPU)

#: the most threads of a block of the cluster BPTT: the SIMT kernel, the
#: tensor-core kernel (``csrc/lstm_bwd_cluster.cuh``: kBwdSimtThreads,
#: kBwdMmaThreads)
_BWD_SIMT_THREADS, _BWD_MMA_THREADS = 512, 384
#: the most 16-row m-tiles of a tensor-core block (the kernel's instances)
_MMA_M_TILES = 3


def _bwd_simt_config(R: int, H: int, C: int, smem_optin: int) -> dict | None:
    """Threads and shared memory of a block of the f32 cluster BPTT
    (``bwd_smem_bytes``) that carries ``R`` rows, or None if none fits, all
    f32: the W_hhᵀ slice ``[4·smax, hw]`` (``hw`` = H rounded up to even),
    dp transposed ``[4·smax, rp]``, the partials ``[2, R, hw]`` and the dc
    carry ``[R, smax]``. Each thread a tile of 2 output columns by ``rpt``
    rows: ``cp`` = H/2 column pairs rounded up to a warp, ``threads = cp ·
    row_groups``. Of 8, 4, 2, 1 rows a thread, the one that pads the fewest
    rows within the kernel's thread bound."""
    smax = _cdiv(H, C)
    hw = H + (H & 1)
    cp = _cdiv(_cdiv(H, 2), 32) * 32
    best = None
    for rpt in (8, 4, 2, 1):
        rg = _cdiv(R, rpt)
        rp, threads = rg * rpt, cp * rg
        smem = 4 * (4 * smax * hw + 4 * smax * rp + 2 * R * hw + R * smax)
        fits = smem + _CLUSTER_STATIC_SMEM <= smem_optin
        if threads <= _BWD_SIMT_THREADS and fits and (best is None or rp < best["rp"]):
            best = {"rpt": rpt, "row_groups": rg, "rp": rp, "threads": threads, "smem": smem,
                    "smax": smax}
    return best


def _bwd_mma_config(R: int, H: int, C: int, smem_optin: int) -> dict | None:
    """Threads and shared memory of a block of the tensor-core cluster BPTT
    (``bwd_mma_smem_bytes``), or None if none fits: the W_hhᵀ slice as the
    ``.col`` operand ``[nb, ks]`` bf16 (``nb`` = H rounded up to 8, ``ks`` =
    4·smax rounded up to 16, plus 8), dp as the row-major operand ``[rp,
    ks]`` bf16 (``rp`` = R rounded up to 16, at most 3 tiles), the f32
    partials ``[2, R, hst]`` (``hst`` = nb rounded up to 16, plus 8) and the
    dc carry; a warp for each pair of 8-column n-tiles, at least 4 and at
    most 12 (a warp then takes several pairs)."""
    smax = _cdiv(H, C)
    nb = _cdiv(H, 8) * 8
    ks = _cdiv(4 * smax, 16) * 16 + 8
    rp = _cdiv(R, 16) * 16
    hst = _cdiv(nb, 16) * 16 + 8
    if rp > 16 * _MMA_M_TILES:
        return None
    threads = 32 * min(_BWD_MMA_THREADS // 32, max(4, _cdiv(nb // 8, 2)))
    smem = (_cdiv(nb * ks * 2, 16) * 16 + _cdiv(rp * ks * 2, 16) * 16
            + 4 * (2 * R * hst + R * smax))
    if smem + _CLUSTER_STATIC_SMEM > smem_optin:
        return None
    return {"rpt": 16, "row_groups": rp // 16, "rp": rp, "threads": threads, "smem": smem,
            "smax": smax}


def bwd_cluster_geometry(rows: int, H: int, C: int, R: int, dtype=None,
                         smem_optin: int = SMEM_OPTIN, slots: int | None = None,
                         dirs: int = 1) -> dict | None:
    """The cluster BPTT's geometry for clusters of ``C`` blocks of ``R`` rows
    each, ``clusters`` of them a direction (``dirs`` 1: K2, 2: K6), or None
    if such a block does not fit; ``slots`` is the clusters the card runs at
    once (for ``waves``). f32: the SIMT kernel; bf16: the tensor cores."""
    if H > K1_CLUSTER_MAX_H:
        return None
    if dtype == torch.bfloat16:
        cfg = _bwd_mma_config(R, H, C, smem_optin)
    else:
        cfg = _bwd_simt_config(R, H, C, smem_optin)
    if cfg is None:
        return None
    clusters = _cdiv(rows, R)
    return {"route": "cluster", "C": C, "R": R, **cfg, "j0": k1_column_map(H, C),
            "clusters": clusters, "blocks": dirs * clusters * C, "dirs": dirs,
            "waves": _cdiv(dirs * clusters, slots) if slots else None}


def bwd_geometry(rows: int, H: int, dtype=None, sms: int = 132, smem_optin: int = SMEM_OPTIN,
                 cluster_slots: dict | None = None, dirs: int = 1) -> dict:
    """The launch geometry of K2 (``dirs=1``) or K6 (``dirs=2``) for ``rows``
    rows of width ``H`` at the operand dtype (None: f32;
    ``torch.bfloat16``) on a card of ``sms`` SMs whose blocks may opt in to
    ``smem_optin`` bytes; ``cluster_slots`` maps a cluster size to the
    clusters the card runs at once (``cudaOccupancyMaxActiveClusters``;
    default ``sms // C``).

    Cluster route: the directions' clusters share the card's slots. The
    smallest cluster size ``C`` (2, 4, 8) whose block fits with ``R``, the
    rows a cluster, the fewest that keep every cluster within one wave;
    failing that, the smallest ``C`` that fits a row at all, with as many
    rows a cluster as fit (several waves). Stream route, for a W_hhᵀ whose
    slice fits no cluster of 8: the first design
    (:func:`bwd_stream_geometry`). Returns a dict with ``route`` and the
    numbers the C entry takes."""
    slots = {C: (cluster_slots or {}).get(C, sms // C) for C in K1_CLUSTER_SIZES}
    sizes = [C for C in K1_CLUSTER_SIZES if C <= H and slots[C] >= dirs]
    for wave_only in (True, False):
        for C in sizes:
            R = _cdiv(rows, slots[C] // dirs)
            g = bwd_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C], dirs)
            while g is None and not wave_only and R > 1:
                R = R // 2 if R > 64 else R - 1
                g = bwd_cluster_geometry(rows, H, C, R, dtype, smem_optin, slots[C], dirs)
            if g is not None:
                return g
    return bwd_stream_geometry(rows, H, sms, dirs)


def bwd_stream_geometry(rows: int, H: int, sms: int = 132, dirs: int = 1) -> dict:
    """The stream route, the first design: blocks of ``R`` (1, 2, 4, 8) rows
    a direction, the fewest that keep every direction's blocks within its
    share of the SMs, each block's dp, partials and f32 carries in shared
    memory. The C entry launches the record's ``R``, threads and shared
    memory, and refuses a record whose threads or bytes differ from its
    own. Measurements may ask for it."""
    R = 1
    while R < 8 and _cdiv(rows, R) > max(1, sms // dirs):
        R *= 2
    blocks = dirs * _cdiv(rows, R)
    return {"route": "stream", "R": R, "threads": min(1024, _cdiv(4 * H, 32) * 32),
            "smem": 40 * R * H, "blocks": blocks, "dirs": dirs, "waves": _cdiv(blocks, sms)}


def device_bwd_geometry(device, rows: int, H: int, compute_dtype=None) -> dict:
    """:func:`bwd_geometry` of K2 on ``device``'s SM count and shared
    memory, with the clusters the card runs at once from
    ``cudaOccupancyMaxActiveClusters`` (:func:`settle_geometry`). Worked out
    once per device and shape."""
    dev = torch.device(device)
    key = ("bwd", dev, rows, H, compute_dtype == torch.bfloat16)
    if key not in _geometries:
        sms, optin = device_limits(dev)
        _geometries[key] = settle_geometry(
            lambda slots: bwd_geometry(rows, H, compute_dtype, sms, optin, slots),
            lambda g: bwd_max_active_clusters(dev, rows, H, compute_dtype, g))
    return _geometries[key]


def bwd_max_active_clusters(device, rows: int, H: int, compute_dtype=None,
                            geometry: dict | None = None) -> int | None:
    """``cudaOccupancyMaxActiveClusters`` of K2's cluster route at this
    geometry, asked once per device and configuration; None on the stream
    route."""
    g = geometry or device_bwd_geometry(device, rows, H, compute_dtype)
    if g["route"] != "cluster":
        return None
    dev = torch.device(device)
    code = 0 if compute_dtype is None else 1
    geom = _geom_ints(g)
    with torch.cuda.device(dev):
        return cluster_occupancy(_kernel("lstm_bwd_max_active_clusters"),
                                 ("k2", dev, code, rows, H, tuple(geom)), code, rows, H, geom)


def _stream_dtype(compute_dtype) -> torch.dtype:
    if compute_dtype is None:
        return torch.float32
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype!r}")


def lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, compute_dtype=None,
                          residuals=False):
    """Plain PyTorch version of the kernel: a loop over T with the same gate
    order and casts. Under ``compute_dtype=torch.bfloat16`` the operands of
    both products are rounded to bf16 and the products accumulate in f32;
    the streams are bf16 and the carries f32.

    Returns ``(hs, (hT, cT))``, or with ``residuals=True`` the kernel's
    eight outputs ``(hs, cs, i, f, o, g, hT, cT)``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, D = x.shape
    H = wih4.shape[-1]
    wih = wih4.to(sdt).float().permute(1, 0, 2).reshape(D, 4 * H)
    whh = whh4.to(sdt).float().permute(1, 0, 2).reshape(H, 4 * H)
    xp = torch.matmul(x.to(sdt).float(), wih)  # [T, B, 4H]
    b = b4.float().reshape(4 * H)
    h, c = h0.float(), c0.float()
    streams = [[] for _ in range(6)]
    for t in range(T):
        pre = xp[t] + torch.matmul(h.to(sdt).float(), whh) + b
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        o = torch.sigmoid(pre[:, 2 * H:3 * H])
        g = torch.tanh(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        for s, v in zip(streams, (h, c, i, f, o, g)):
            s.append(v)
    hs, cs, ai, af, ao, ag = (torch.stack(s).to(sdt) for s in streams)
    if residuals:
        return hs, cs, ai, af, ao, ag, h, c
    return hs, (h, c)


def _check(cond: bool, what: str, fn: str = "lstm_recurrence_fused") -> None:
    if not cond:
        raise ValueError(f"{fn}: {what}")


def lstm_proj_plain(x, wih4, b4, compute_dtype=None):
    """Plain PyTorch version of K1's projection: ``xp [T, B, 4H] = x W_ih +
    b`` in f32, gates side by side, from operands rounded to the compute
    dtype."""
    sdt = _stream_dtype(compute_dtype)
    T, B, D = x.shape
    H = wih4.shape[-1]
    wih = wih4.to(sdt).float().permute(1, 0, 2).reshape(D, 4 * H)
    return torch.matmul(x.to(sdt).float(), wih) + b4.float().reshape(4 * H)


def _operands(x, wih4, b4, whh4, compute_dtype, fn="lstm_recurrence_fused"):
    """Checks K1's operands (``whh4`` None: the projection's alone); returns
    them at the stream dtype."""
    _check(x.device.type == "cuda", f"unsupported device {x.device}", fn)
    sdt = _stream_dtype(compute_dtype)
    weights = (wih4,) if whh4 is None else (wih4, whh4)
    if compute_dtype is None:
        _check(all(a.dtype == torch.float32 for a in (x, *weights)),
               "x, wih4 and whh4 must be float32 when compute_dtype is None", fn)
    else:
        x, wih4 = x.to(sdt), wih4.to(sdt)
        whh4 = None if whh4 is None else whh4.to(sdt)
    _check(b4.dtype == torch.float32, "b4 must be float32", fn)
    _check(x.dim() == 3, f"x must be [T, B, D], got {tuple(x.shape)}", fn)
    T, B, D = x.shape
    H = wih4.shape[-1]
    _check(T >= 1 and B >= 1, "x needs at least one step and one row", fn)
    _check(tuple(wih4.shape) == (4, D, H), f"wih4 must be [4, {D}, {H}], got {tuple(wih4.shape)}", fn)
    _check(tuple(b4.shape) == (4, H), f"b4 must be [4, {H}], got {tuple(b4.shape)}", fn)
    _check(whh4 is None or tuple(whh4.shape) == (4, H, H),
           f"whh4 must be [4, {H}, {H}], got {None if whh4 is None else tuple(whh4.shape)}", fn)
    _check(all(a.device == x.device for a in (b4, *weights)), "all inputs must be on one device", fn)
    _check(all(a.stride(-1) == 1 for a in (x, b4, *weights)),
           "x, wih4, b4 and whh4 must be contiguous in their last axis", fn)
    return sdt, x, wih4, whh4


def _launch_proj(x, w, b, code: int):
    """One launch of the projection kernel: ``xp [T, B, G·H] = x W + b`` f32
    for ``w [G, D, H]``, ``b [G, H]`` (G = 4, or 8 for both directions of
    K3/K5), strided views contiguous in their last axis. ``code``: 0 f32, 1
    bf16 (SIMT FMAs, both; the C entry picks the f32 tiles by shape, the
    same sums in the same order)."""
    T, B, D = x.shape
    G, _, H = w.shape
    xp = torch.empty((T, B, G * H), dtype=torch.float32, device=x.device)
    fn, err_str = _kernel("lstm_proj")
    err = fn(code, G, x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(), w.stride(0),
             w.stride(1), b.data_ptr(), b.stride(0), xp.data_ptr(), T, B, D, H,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_proj kernel failed: {err_str(err).decode()} ({err})")
    return xp


def _launch_proj_mma(x, wt, b):
    """One launch of the bf16 projection on the tensor cores: ``xp [T, B, N]
    = x Wt^T + b`` f32 for ``x [T, B, D]`` and ``Wt [N, D]`` bf16 (rows and
    strides multiples of 8 values, 16-byte aligned), ``b [N]`` f32."""
    T, B, D = x.shape
    N = wt.shape[0]
    xp = torch.empty((T, B, N), dtype=torch.float32, device=x.device)
    fn, err_str = _kernel("lstm_proj_mma")
    err = fn(x.data_ptr(), x.stride(0), x.stride(1), wt.data_ptr(), wt.stride(0), b.data_ptr(),
             xp.data_ptr(), T, B, D, N, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_proj_mma kernel failed: {err_str(err).decode()} ({err})")
    return xp


def _k1_proj(x, wih4, b4, sdt):
    global PROJ_LAUNCHES
    xp = _launch_proj(x, wih4, b4, 0 if sdt == torch.float32 else 1)
    PROJ_LAUNCHES += 1
    return xp


def lstm_proj_fused(x, wih4, b4, compute_dtype=None):
    """K1's projection kernel alone: same arguments and return as
    :func:`lstm_proj_plain`; ``x`` and the weights may be strided views
    contiguous in their last axis."""
    if x.device.type == "cpu":
        return lstm_proj_plain(x, wih4, b4, compute_dtype)
    sdt, x, wih4, _ = _operands(x, wih4, b4, None, compute_dtype, "lstm_proj_fused")
    with torch.cuda.device(x.device):
        return _k1_proj(x, wih4, b4, sdt)


def lstm_recurrence_fused(x, wih4, b4, whh4, h0, c0, compute_dtype=None,
                          residuals=False, geometry=None):
    """K1: the LSTM forward, i2h projection and recurrence.

    Same arguments and returns as :func:`lstm_recurrence_plain`. The terminal
    carry ``(hT, cT)`` is always f32, written from the kernel's f32 carry and
    never from the stream dtype. The residual streams ``cs, i, f, o, g`` are
    written only when ``residuals=True``. ``x`` may be a strided view (any
    strides over T and B, contiguous over D); the weights need only their
    last axis contiguous, so model-layout views pass without a copy.

    Two device launches: the projection into an f32 scratch ``[T, B, 4H]``,
    then the recurrence on the route of :func:`k1_geometry` for this
    device, or of ``geometry`` (a :func:`k1_geometry` result, for
    measurements). A launch the card refuses raises; nothing falls back."""
    if x.device.type == "cpu":
        return lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, compute_dtype, residuals)
    return _k1(x, wih4, b4, whh4, h0, c0, compute_dtype, residuals, geometry)


def _k1(x, wih4, b4, whh4, h0, c0, compute_dtype, residuals, geometry, prof=None):
    sdt, x, wih4, whh4 = _operands(x, wih4, b4, whh4, compute_dtype)
    T, B, D = x.shape
    H = wih4.shape[-1]
    _check(all(a.dtype == torch.float32 for a in (h0, c0)), "h0 and c0 must be float32")
    _check(tuple(h0.shape) == (B, H) and tuple(c0.shape) == (B, H), f"h0 and c0 must be [{B}, {H}]")
    _check(h0.device == x.device and c0.device == x.device, "all inputs must be on one device")
    _check(h0.is_contiguous() and c0.is_contiguous(), "h0 and c0 must be contiguous")
    g = geometry or device_geometry(x.device, B, H, compute_dtype)

    def stream():
        return torch.empty((T, B, H), dtype=sdt, device=x.device)

    hs = stream()
    res = [stream() for _ in range(5)] if residuals else [None] * 5
    hT = torch.empty((B, H), dtype=torch.float32, device=x.device)
    cT = torch.empty_like(hT)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn, err_str = _kernel("lstm_rec")
    with torch.cuda.device(x.device):
        xp = _k1_proj(x, wih4, b4, sdt)
        err = fn(
            0 if sdt == torch.float32 else 1, xp.data_ptr(),
            whh4.data_ptr(), whh4.stride(0), whh4.stride(1),
            h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), *(ptr(r) for r in res), hT.data_ptr(), cT.data_ptr(),
            T, B, H, _geom_ints(g), ptr(prof), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_rec kernel ({g['route']} route) failed: "
                           f"{err_str(err).decode()} ({err})")
    global LAUNCHES, K1_CLUSTER_CALLS, K1_STREAM_CALLS
    LAUNCHES += 1
    if g["route"] == "cluster":
        K1_CLUSTER_CALLS += 1
    else:
        K1_STREAM_CALLS += 1
    if residuals:
        return (hs, *res, hT, cT)
    return hs, (hT, cT)


#: the phases of a step of the cluster recurrence, as its clock stamps them
K1_PHASES = ("gather", "product", "gates", "barrier")


def k1_phase_profile(x, wih4, b4, whh4, h0, c0, compute_dtype=None, geometry=None) -> dict:
    """One K1 call on the cluster route with its phase clock on: the mean
    µs a step of block 0 spends in each of :data:`K1_PHASES` (the h
    gather, the recurrent product, the gates and carries, the cluster
    barrier with the stream stores between its halves), from ``clock64``
    stamps converted by the global timer, and each phase's share of the
    step. For measurements; counts as a call."""
    T, B, _ = x.shape
    g = geometry or device_geometry(x.device, B, wih4.shape[-1], compute_dtype)
    _check(g["route"] == "cluster", "the phase clock is the cluster route's", "k1_phase_profile")
    prof = torch.zeros(5 * T + 2, dtype=torch.int64, device=x.device)
    _k1(x, wih4, b4, whh4, h0, c0, compute_dtype, False, g, prof)
    return phase_summary(prof, T)


def phase_summary(prof, T: int, names=K1_PHASES) -> dict:
    """The mean µs a step spends in each of the four phases ``names``
    (:data:`K1_PHASES`, or :data:`BWD_PHASES`), and each phase's share of
    the step, from a cluster kernel's phase clock ``prof [5 T + 2]``
    (``clock64`` stamps converted by the global timer)."""
    p = prof.cpu()
    stamps = p[:5 * T].reshape(T, 5).double()
    ns_per_cycle = float(p[5 * T + 1] - p[5 * T]) / float(stamps[-1, 4] - stamps[0, 0])
    phase_us = (stamps[:, 1:] - stamps[:, :-1]).mean(0) * ns_per_cycle / 1e3
    step_us = float(phase_us.sum())
    out = {f"{k}_us": float(v) for k, v in zip(names, phase_us)}
    out.update({f"{k}_share": float(v) / step_us for k, v in zip(names, phase_us)})
    out.update(step_us=step_us, ghz=1.0 / ns_per_cycle)
    return out


def lstm_bwd_plain(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype=None):
    """Plain PyTorch version of the backward kernel: the loop over T,
    backwards, of the JAX ``_bwd_kernel``. ``ai, af, ao, ag, cs`` are the
    forward's residual streams ``[T, B, H]``, ``dhs`` the cotangent of
    ``hs``, ``dhT, dcT [B, H]`` those of the terminal carry. Under
    ``compute_dtype=torch.bfloat16`` each dp is rounded to bf16 before the
    product with ``W_hhᵀ`` (also bf16) and the product accumulates in f32.

    Returns ``(dp [T, B, 4H] at the stream dtype, gates i, f, o, g side by
    side; dh0, dc0 [B, H] f32)``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, H = cs.shape
    wT = whh4.to(sdt).float().transpose(1, 2)  # W_hh[k]ᵀ, as _bwd_call:243
    i, f, o, g, c = (a.float() for a in (ai, af, ao, ag, cs))
    dh_c, dc_c = dhT.float(), dcT.float()
    dp = torch.empty((T, B, 4 * H), dtype=sdt, device=cs.device)
    for t in range(T - 1, -1, -1):
        c_prev = c[t - 1] if t > 0 else c0.float()
        dh = dhs[t].float() + dh_c
        tc = torch.tanh(c[t])
        dc = dh * o[t] * (1 - tc * tc) + dc_c
        dps = (dc * g[t] * i[t] * (1 - i[t]), dc * c_prev * f[t] * (1 - f[t]),
               dh * tc * o[t] * (1 - o[t]), dc * i[t] * (1 - g[t] * g[t]))
        dp[t] = torch.cat(dps, -1).to(sdt)
        ops = [d.to(sdt).float() for d in dps]
        dh_c = (((ops[0] @ wT[0]) + ops[1] @ wT[1]) + ops[2] @ wT[2]) + ops[3] @ wT[3]
        dc_c = dc * f[t]
    return dp, dh_c, dc_c


def lstm_bwd_fused(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype=None,
                   geometry=None):
    """LSTM backward through time in one kernel launch.

    Same arguments and returns as :func:`lstm_bwd_plain`. The streams must
    be contiguous at the stream dtype; ``dhs`` may be any view that is
    contiguous over H (the model layout hands over a transposed one).
    ``whh4`` is transposed once per call, outside the kernel. The route is
    :func:`device_bwd_geometry`'s, or ``geometry``'s (a :func:`bwd_geometry`
    result, for measurements); a launch the card refuses raises, nothing
    falls back."""
    if cs.device.type == "cpu":
        return lstm_bwd_plain(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype)
    return _k2(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype, geometry)


def _k2(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype, geometry, prof=None):
    def check(cond, what):
        _check(cond, what, "lstm_bwd_fused")

    check(cs.device.type == "cuda", f"unsupported device {cs.device}")
    sdt = _stream_dtype(compute_dtype)
    check(cs.dim() == 3, f"cs must be [T, B, H], got {tuple(cs.shape)}")
    T, B, H = cs.shape
    streams = (ai, af, ao, ag, cs, dhs)
    check(all(tuple(a.shape) == (T, B, H) and a.dtype == sdt for a in streams),
          f"ai, af, ao, ag, cs and dhs must be [{T}, {B}, {H}] {sdt}")
    check(all(a.is_contiguous() for a in streams[:5]), "ai, af, ao, ag and cs must be contiguous")
    check(dhs.stride(-1) == 1, "dhs must be contiguous in its last axis")
    check(tuple(whh4.shape) == (4, H, H), f"whh4 must be [4, {H}, {H}], got {tuple(whh4.shape)}")
    carries = (c0, dhT, dcT)
    check(all(tuple(a.shape) == (B, H) and a.dtype == torch.float32 and a.is_contiguous()
              for a in carries), f"c0, dhT and dcT must be contiguous [{B}, {H}] float32")
    check(all(a.device == cs.device for a in streams + carries + (whh4,)),
          "all inputs must be on one device")
    g = geometry or device_bwd_geometry(cs.device, B, H, compute_dtype)
    check(g.get("dirs", 1) == 1, "the geometry is K6's (two directions)")
    wT = whh4.to(sdt).transpose(1, 2).contiguous()
    dp = torch.empty((T, B, 4 * H), dtype=sdt, device=cs.device)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=cs.device)
    dc0 = torch.empty_like(dh0)
    fn, err_str = _kernel("lstm_bwd")
    with torch.cuda.device(cs.device):
        err = fn(
            0 if sdt == torch.float32 else 1,
            *(a.data_ptr() for a in streams[:5]), wT.data_ptr(), wT.stride(0), wT.stride(1),
            c0.data_ptr(), dhs.data_ptr(), dhs.stride(0), dhs.stride(1),
            dhT.data_ptr(), dcT.data_ptr(), dp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            T, B, H, _geom_ints(g), None if prof is None else prof.data_ptr(),
            torch.cuda.current_stream(cs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_bwd kernel ({g['route']} route) failed: "
                           f"{err_str(err).decode()} ({err})")
    global BWD_LAUNCHES, BWD_CLUSTER_CALLS, BWD_STREAM_CALLS
    BWD_LAUNCHES += 1
    if g["route"] == "cluster":
        BWD_CLUSTER_CALLS += 1
    else:
        BWD_STREAM_CALLS += 1
    return dp, dh0, dc0


#: the phases of a step of the cluster BPTT, as its clock stamps them: the
#: dh reduce over every rank's partials with the cotangents of the own
#: units, the block barrier after them, the partial product, the cluster
#: barrier
BWD_PHASES = ("cotangents", "sync", "product", "barrier")


def bwd_phase_profile(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype=None,
                      geometry=None) -> dict:
    """One K2 call on the cluster route with its phase clock on: the mean µs
    a step of block 0 spends in each of :data:`BWD_PHASES` and each phase's
    share of the step. For measurements; counts as a call."""
    T, B, H = cs.shape
    g = geometry or device_bwd_geometry(cs.device, B, H, compute_dtype)
    _check(g["route"] == "cluster", "the phase clock is the cluster route's", "bwd_phase_profile")
    prof = torch.zeros(5 * T + 2, dtype=torch.int64, device=cs.device)
    _k2(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype, g, prof)
    return phase_summary(prof, T, BWD_PHASES)


def _site_weight(w, sites: int):
    """The one weight block behind a site-batched ``[S, ...]`` view; every
    site must hold the same values, which a stride-0 site axis proves (one
    site holds one block at any stride)."""
    if not sites:
        return w
    _check(w.shape[0] == sites and (w.stride(0) == 0 or sites == 1),
           f"site-batched weights must be [{sites}, ...] views of stride 0, got shape "
           f"{tuple(w.shape)} strides {w.stride()}", "LSTMRecurrence")
    return w[0]


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable fused recurrence: ``apply(x, wih4, b4, whh4, h0,
    c0, compute_dtype, use_kernel) -> (hs, hT, cT)``.

    Forward: K1 with ``residuals=True`` (or its plain version when
    ``use_kernel`` is False). Backward: K2 (or its plain version), then
    the products that JAX's ``_vjp_fused_bwd`` computes outside its kernel
    (``dx = dp·W_ihᵀ``, ``dW_ih = xᵀ·dp``, ``db = Σ dp``, ``dW_hh =
    h_prevᵀ·dp`` with ``h_prev = [h0; hs[:-1]]``), each accumulated in f32
    from operands rounded to the compute dtype.

    Site-batched weights ``[S, 4, D, H]``, ``[S, 4, H]``, ``[S, 4, H, H]``
    of stride 0 over S: ``x [T, S·B, D]`` holds site s in rows ``s·B ..
    (s+1)·B``, each kernel launches once over all rows with the one
    weight block, and the weight gradients are split by rows per site."""

    @staticmethod
    def forward(ctx, x, wih4, b4, whh4, h0, c0, compute_dtype=None, use_kernel=True):
        sites = wih4.shape[0] if wih4.dim() == 4 else 0
        wih, b, whh = (_site_weight(w, sites) for w in (wih4, b4, whh4))
        fwd = lstm_recurrence_fused if use_kernel else lstm_recurrence_plain
        hs, cs, i, f, o, g, hT, cT = fwd(x, wih, b, whh, h0, c0, compute_dtype, residuals=True)
        ctx.save_for_backward(x, wih, whh, h0, c0, hs, cs, i, f, o, g)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        x, wih, whh, h0, c0, hs, cs, i, f, o, g = ctx.saved_tensors
        cdt_ = ctx.compute_dtype
        sdt = _stream_dtype(cdt_)
        T, R, D = x.shape
        H = cs.shape[-1]
        # hs feeds the loss; hT and cT do not in the mean-pooled model
        dhs = torch.zeros_like(hs) if dhs is None else dhs.to(sdt)
        zero = torch.zeros((R, H), dtype=torch.float32, device=x.device)
        dhT = zero if dhT is None else dhT.float().contiguous()
        dcT = zero if dcT is None else dcT.float().contiguous()
        bwd = lstm_bwd_fused if ctx.use_kernel else lstm_bwd_plain
        dp, dh0, dc0 = bwd(i, f, o, g, cs, whh, c0, dhs, dhT, dcT, cdt_)

        # operands rounded to the compute dtype, products accumulated in f32
        # (the JAX einsums' preferred_element_type=f32)
        cdt = cdt_ if cdt_ is not None else x.dtype
        dpf = dp.to(cdt).float()
        dx = None
        if ctx.needs_input_grad[0]:
            wih_cat = wih.permute(1, 0, 2).reshape(D, 4 * H).to(cdt).float()
            dx = torch.matmul(dpf, wih_cat.T).to(x.dtype)
        xf = x.to(cdt).float()
        h_prev = torch.cat([h0[None].to(hs.dtype), hs[:-1]], 0).to(cdt).float()
        if ctx.sites:
            S = ctx.sites
            dpv, xv, hv = (a.reshape(T, S, R // S, -1) for a in (dpf, xf, h_prev))
            dwih = torch.einsum("tsbd,tsbg->sdg", xv, dpv).reshape(S, D, 4, H).transpose(1, 2)
            db = dpv.sum((0, 2)).reshape(S, 4, H)
            dwhh = torch.einsum("tsbh,tsbg->shg", hv, dpv).reshape(S, H, 4, H).transpose(1, 2)
        else:
            dwih = torch.einsum("tbd,tbg->dg", xf, dpf).reshape(D, 4, H).transpose(0, 1)
            db = dpf.sum((0, 1)).reshape(4, H)
            dwhh = torch.einsum("tbh,tbg->hg", h_prev, dpf).reshape(H, 4, H).transpose(0, 1)
        return dx, dwih, db, dwhh, dh0, dc0, None, None


class _SiteSum(torch.autograd.Function):
    """``a + b`` of two stride-0 site-batched views, as a stride-0 view:
    each site's sum is the same, so it is computed once; the backward hands
    every site its own cotangent, to both operands."""

    @staticmethod
    def forward(ctx, a, b):
        for w in (a, b):
            _site_weight(w, a.shape[0])
        return (a[0] + b[0]).expand_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, g


def site_sum(a, b):
    """The combined bias ``b_ih + b_hh`` of stride-0 site-batched views,
    kept of stride 0 so that :class:`LSTMRecurrence` takes it."""
    return _SiteSum.apply(a, b)


def _model_layout(use_kernel, x, w_ih, b, w_hh, h0, c0, compute_dtype):
    B, T, D = x.shape
    H = w_hh.shape[-2]
    lead = tuple(w_ih.shape[:-2])  # () or (S,) for site-batched weights
    in_dtype = x.dtype
    x = x.to(compute_dtype if compute_dtype is not None else torch.float32)
    wih4 = w_ih.float().reshape(*lead, D, 4, H).transpose(-3, -2)
    b4 = b.float().reshape(*lead, 4, H)
    whh4 = w_hh.float().reshape(*lead, H, 4, H).transpose(-3, -2)
    args = (x.transpose(0, 1), wih4, b4, whh4, h0.float().contiguous(), c0.float().contiguous())
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        hs, hT, cT = LSTMRecurrence.apply(*args, compute_dtype, use_kernel)
    else:
        sites = lead[0] if lead else 0
        fwd = lstm_recurrence_fused if use_kernel else lstm_recurrence_plain
        hs, (hT, cT) = fwd(args[0], *(_site_weight(w, sites) for w in args[1:4]), *args[4:],
                           compute_dtype)
    return hs.transpose(0, 1).to(in_dtype), (hT, cT)


def lstm_forward_fused(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """Model-layout wrapper over the fused recurrence.

    ``x [B, T, D]``, ``w_ih [D, 4H]``, ``b [4H]`` (``b_ih + b_hh``),
    ``w_hh [H, 4H]``, ``h0, c0 [B, H]``; the weights may carry a leading
    stride-0 site axis (:class:`LSTMRecurrence`). Returns ``(hs [B, T, H]
    at x's dtype, (hT, cT) f32)``. With gradients enabled it runs
    :class:`LSTMRecurrence` (K1 with residuals, K2 backward); without, K1
    alone. The gate blocks and the time-major input are passed as strided
    views: nothing is copied to change layout, and rows need no padding."""
    return _model_layout(True, x, w_ih, b, w_hh, h0, c0, compute_dtype)


def lstm_forward_plain(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """:func:`lstm_forward_fused` through the plain versions on any device:
    the reference that the card's kernel path is held against."""
    return _model_layout(False, x, w_ih, b, w_hh, h0, c0, compute_dtype)
