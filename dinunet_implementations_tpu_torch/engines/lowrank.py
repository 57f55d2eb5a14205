"""Low-rank machinery of the rankDAD engine: the port of the JAX package's
``engines/lowrank.py``.

Knobs (the reference's ``compspec.json:236-238``): ``dad_reduction_rank``
(default 10), ``dad_num_pow_iters`` (5) and ``dad_tol`` (1e-3).

Matrix convention, as in JAX: a leaf with ndim ≥ 2 is reshaped to
``[prod(leading), last]`` of the JAX layout (Dense kernels ``[in, out]``);
ndim ≤ 1 leaves are "dense" and bypass compression. A port ``nn.Linear``
weight is ``[out, in]``, the transpose of that matrix: the rankDAD engine
factorizes its transposed view (``engines/rankdad.py``).

The power iteration itself, :func:`subspace_iteration_grouped`, runs each
rank class through ``ops/poweriter_cuda.py``: the hand-written kernel K7
for CUDA tensors, its plain PyTorch version for CPU tensors or when the
caller asks for the plain path (``use_kernel=False``). A class of more
than 16 shape buckets takes several launches of at most 16
(``poweriter_cuda.k7_launches``). A class that K7 does not take (rank
above 16, iterates over the shared-memory limit) goes to the plain
version on every device, a static route chosen by shape, as the JAX
engine sends such a class to its XLA loop; ``POWERITER_PLAIN_CLASSES``
counts those classes.
"""

from __future__ import annotations

import torch

#: rank classes sent to the plain power iteration because K7 does not take
#: them, since the counter was last set to 0
POWERITER_PLAIN_CLASSES = 0


def _matrix_shape(shape) -> tuple[int, int]:
    m = 1
    for d in shape[:-1]:
        m *= int(d)
    return m, int(shape[-1])


def jax_leaf_shape(name: str, shape, transposed) -> tuple[int, ...]:
    """One site's leaf shape in the JAX layout: reversed for a leaf named in
    ``transposed`` (a port ``nn.Linear`` weight ``[out, in]`` against the
    flax kernel ``[in, out]``), which must be 2-D."""
    shape = tuple(shape)
    if name in transposed:
        if len(shape) != 2:
            raise ValueError(f"transposed leaf {name!r} must be 2-D, got {shape}")
        return shape[::-1]
    return shape


def is_compressible(g, min_rank_dim: int = 2) -> bool:
    """Whether one site's leaf ``g`` (a tensor, or its shape) is factorized:
    ndim ≥ 2 and both matrix dims at least ``min_rank_dim``."""
    shape = tuple(getattr(g, "shape", g))
    return len(shape) >= 2 and min(_matrix_shape(shape)) >= min_rank_dim


def to_matrix(g):
    return g.reshape(_matrix_shape(g.shape))


def from_matrix(mat, like):
    return mat.reshape(like.shape).to(like.dtype)


def lowrank_rank_groups(grads: dict, rank: int) -> tuple:
    """``(groups, dense)``: ``groups`` is ``[(effective_rank, [(m, n), ...]),
    ...]`` sorted by rank class, ``dense`` the shapes of the leaves that
    are not factorized; leaves (tensors or shapes) are one site's, in JAX
    orientation."""
    groups: dict[int, list] = {}
    dense = []
    for g in grads.values():
        shape = tuple(getattr(g, "shape", g))
        if is_compressible(shape):
            m, n = _matrix_shape(shape)
            groups.setdefault(min(rank, m, n), []).append((m, n))
        else:
            dense.append(shape)
    return sorted(groups.items()), dense


def lp_matmul(a, b, dtype=None):
    """``a @ b``; with ``dtype=torch.bfloat16`` both operands are rounded to
    bf16 and the product accumulates in f32 (the JAX
    ``preferred_element_type=f32`` contraction: products of two bf16 values
    are exact in f32)."""
    if dtype is None:
        return a @ b
    return a.to(dtype).float() @ b.to(dtype).float()


def default_omega(G, r: int, device=None):
    """The per-shape default random init Ω ``[n, r]`` of an ``[m, n]``
    matrix (``G`` a tensor or its shape), drawn on the CPU from a
    ``torch.Generator`` seeded with ``m·1000003 + n`` and moved to
    ``device`` (``G``'s, for a tensor).

    JAX seeds ``jax.random.PRNGKey`` with the same integer; the two
    generators give different numbers, so the port's Ω is a random init of
    its own, like its weights. Tests hand JAX's Ω across as numpy."""
    m, n = (int(d) for d in tuple(getattr(G, "shape", G))[-2:])
    gen = torch.Generator().manual_seed(m * 1000003 + n)
    om = torch.randn((n, r), generator=gen, dtype=torch.float32)
    if device is None and torch.is_tensor(G):
        device = G.device
    return om if device is None else om.to(device)


def _normalize_cols(Y):
    """Column-normalize ``Y [..., m, r]``; exactly-zero columns take
    canonical basis vectors, so a zero input still yields an orthonormal
    Q (the JAX ``_normalize_cols``)."""
    nc = torch.linalg.vector_norm(Y, dim=-2)  # [..., r]
    fallback = torch.eye(Y.shape[-2], Y.shape[-1], dtype=Y.dtype, device=Y.device)
    Yn = torch.where((nc > 0)[..., None, :], Y / torch.clamp(nc, min=1e-30)[..., None, :],
                     fallback)
    return Yn, nc


def _cholqr_once(Y, shift: float):
    """One column-normalized shifted CholeskyQR round of ``Y [L, m, r]``:
    Gram + ``(shift·trace + 1e-30)·I``, Cholesky and a triangular inverse
    (LAPACK here, as the JAX package on the CPU), ``Q = Y·L⁻ᵀ``.

    A member whose f32 Cholesky breaks down (a non-positive pivot) takes
    its Gram again, accumulated in float64 and rounded to f32 once, and
    that Gram's f32 Cholesky. cuBLAS's f32 Gram over m = 1024 rows can be
    off by ~1e-6 in its smallest eigenvalue, as much as the second round's
    shift (1e-7 of the trace, which is r): the shifted Gram of a nearly
    rank-deficient iterate was then indefinite and its Cholesky NaN on the
    card (the multimodal model's ``mlp2`` leaves), where the JAX package's
    Gram of the same iterate on the CPU is within ~1e-7. Both Grams are
    formed for every member, so no value crosses to the host; a member
    whose f32 Cholesky holds is factored as before, bit for bit."""
    Yn, nc = _normalize_cols(Y)
    r = Yn.shape[-1]
    eye = torch.eye(r, dtype=Yn.dtype, device=Yn.device)

    def shifted(gram):
        tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
        return gram + (shift * tr + 1e-30)[..., None, None] * eye

    chol, info = torch.linalg.cholesky_ex(shifted(Yn.mT @ Yn))  # NaN in, NaN out: no raise
    Yd = Yn.double()
    chol64, _ = torch.linalg.cholesky_ex(shifted((Yd.mT @ Yd).to(Yn.dtype)))
    chol = torch.where((info > 0)[..., None, None], chol64, chol)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    return Yn @ linv.mT, nc


def _cholqr_multi(Ys):
    """Column-normalized shifted CholeskyQR2 of ``Ys [L, m, r]`` (shifts
    1e-6, then 1e-7) → ``(Q [L, m, r], colnorm [L, r])``; ``colnorm`` is
    the first round's pre-normalization column norms, the σ-scale
    convergence proxy. The shift keeps rank-deficient Gram matrices (a
    per-site gradient has rank ≤ its batch) positive definite."""
    Q1, colnorms = _cholqr_once(Ys, 1e-6)
    Q2, _ = _cholqr_once(Q1, 1e-7)
    return Q2, colnorms


def orthonormalize_many(Ps: list) -> list:
    """Orthonormal columns of each ``P [m_l, r]`` of one ``r`` (powerSGD's
    ``orth``), all in one shifted CholeskyQR2 of :func:`_cholqr_multi`: the
    matrices are stacked with zero rows below the shorter ones, which change
    neither a column's norm nor the Gram matrix, and each ``Q`` is its
    matrix's rows of the result. One call for the group keeps the host's
    launches per round few; nothing in it synchronizes the host."""
    Y = torch.nn.utils.rnn.pad_sequence(Ps, batch_first=True)  # [L, max m, r]
    Q, _ = _cholqr_multi(Y)
    return [Q[i, :P.shape[0]] for i, P in enumerate(Ps)]


def orthonormalize(P):
    """Orthonormal columns of one matrix ``P [m, r]``
    (:func:`orthonormalize_many` of one)."""
    return orthonormalize_many([P])[0]


def subspace_iteration_grouped(groups, num_iters: int, tol: float, matmul_dtype=None,
                               use_kernel: bool = True):
    """Rank-r factorizations ``G ≈ P @ Qᵀ`` for several same-rank groups.

    ``groups`` is a list of ``(Gs, rank, omegas)``: each ``G`` is one
    matrix ``[m, n]`` or a stack of members ``[L, m, n]`` (any strides
    with one matrix axis contiguous, e.g. a transposed view); the group
    shares ``r = min(rank, m, n)``. ``omegas`` holds per-entry warm starts
    ``[n, r]`` or ``[L, n, r]`` (``None`` entries, or ``omegas=None``,
    draw :func:`default_omega`, a cold start). Returns one ``[(P, Q),
    ...]`` list per group, ``P [.., m, r]``, ``Q [.., n, r]``, order and
    leading axes preserved.

    Each member iterates until its own relative σ-estimate change drops to
    ``tol`` or it has made ``num_iters`` refinements: the JAX shared loop
    freezes finished members, so results are the same member for member.
    Each group goes to ``ops.poweriter_cuda.poweriter_fused`` (one K7
    launch for CUDA tensors, or one for each 16 buckets; the plain version
    for CPU tensors), or to ``poweriter_plain`` with ``use_kernel=False`` or
    when the kernel does not take the class (``k7_launches``; counted in
    ``POWERITER_PLAIN_CLASSES``). ``matmul_dtype=
    torch.bfloat16`` runs the products ``G@Ω``, ``GᵀP``, ``G(GᵀP)`` with
    bf16 operands and f32 accumulation; normalization, Cholesky and σ stay
    f32."""
    from ..ops.poweriter_cuda import k7_launches, poweriter_fused, poweriter_plain

    global POWERITER_PLAIN_CLASSES
    out = []
    for Gs, rank, omegas in groups:
        r = min([rank] + [min(G.shape[-2:]) for G in Gs])
        if omegas is None:
            omegas = [None] * len(Gs)
        elif len(omegas) != len(Gs):
            raise ValueError(f"omegas has {len(omegas)} entries for {len(Gs)} matrices")
        stacks, oms = [], []
        for G, om in zip(Gs, omegas):
            G3 = (G if G.dim() == 3 else G[None]).float()
            if om is None:
                om = default_omega(G3.shape[-2:], r, G3.device)
            om = om.float()
            if om.dim() == 2:
                om = om[None].expand(G3.shape[0], *om.shape)
            stacks.append(G3)
            oms.append(om)
        launches = k7_launches(stacks, r) if use_kernel else None
        if use_kernel and launches is None:
            POWERITER_PLAIN_CLASSES += 1
        if launches is None:
            Ps, Qs, _ = poweriter_plain(stacks, oms, num_iters, tol, matmul_dtype)
        else:
            Ps, Qs = [None] * len(stacks), [None] * len(stacks)
            for ks in launches:
                P_, Q_, _ = poweriter_fused([stacks[k] for k in ks], [oms[k] for k in ks],
                                            num_iters, tol, matmul_dtype)
                for k, P, Q in zip(ks, P_, Q_):
                    Ps[k], Qs[k] = P, Q
        out.append([(P, Q) if G.dim() == 3 else (P[0], Q[0]) for G, P, Q in zip(Gs, Ps, Qs)])
    return out
