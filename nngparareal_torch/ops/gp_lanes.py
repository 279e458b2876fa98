"""Batched GP kernels with the candidate batch in the LAST axis.

Port of ``nngparareal_tpu/ops/gp_lanes.py``: the parts the nnGP runs (the
NLL, optionally scored in a lower precision, the leave-one-out score and
the Cholesky and LU posteriors), and the blocked NLL that GParareal's
``score_lanes=True`` runs at its Gram sizes (``nll_lanes_big``, with the
linear-scale kernel ``k_se_linear_lanes``). Matrices are stored (m, m, B) for B (theta, jitter)
candidates sharing one m x m squared-distance matrix; the Cholesky and the
substitutions are the same column loops as the JAX package, each step one
(*, B)-wide torch op.

The loops are deliberate, not ``torch.linalg.cholesky_ex``: a failed pivot
must give NaN exactly where the JAX package gives NaN. ``nll_lanes`` maps
non-finite values to +inf, which excludes a candidate; ``posterior_mean_
lanes`` keeps NaN, which makes the driver fall back to the bare parareal
correction. Both decide the iteration count.

Intermediates keep the JAX package's layouts (columns stacked on the
leading axis), so every sum runs over the leading axis in the same order.
"""

import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def pow10(x):
    """10**x elementwise, one rounding for every element.

    On the CPU torch's pow rounds a contiguous vector's body with SIMD
    (SLEEF) and its tail with ``std::pow``, so a candidate's kernel value
    would depend on its lane: the search and the posterior could factor
    the same theta differently, one of them failing at the singular
    boundary. A strided input keeps every element on ``std::pow``, which
    is what XLA computes on the CPU (bitwise). A card has one path.
    """
    if x.device.type != "cpu":
        return torch.pow(10.0, x)
    buf = x.new_empty(x.shape + (2,))
    buf[..., 0] = x
    return torch.pow(10.0, buf[..., 0])


def sum0(x):
    """Sum over the leading axis, one term after another, as XLA sums it
    on the CPU. ``torch.sum`` splits 8 or more terms over several
    accumulators, and a card's ``cumsum`` scans a (m, 1) tensor as its
    innermost axis, in a tree: either makes a lane's value depend on the
    other axes' sizes."""
    acc = x[0]
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
    return acc


def dot0(a, b):
    """sum_t a[t] * b[t] over the leading axis as XLA computes
    ``jnp.sum(a * b, axis=0)`` on the CPU: one fused multiply-add after
    another into a running sum (``addcmul`` is an FMA).

    The order decides the last bits, and on the ill-conditioned local
    Grams those decide whether a pivot fails; it also makes every lane's
    value independent of how many lanes a call has, so the search and the
    posterior factor the same candidate alike.
    """
    acc = a[0] * b[0]
    for t in range(1, a.shape[0]):
        acc = torch.addcmul(acc, a[t], b[t])
    return acc


def k_se_log10_lanes(sqd, theta):
    """SE kernel values for B candidate thetas at once.

    sqd: (m, m) shared squared distances; theta: (B, 2) log10-scale.
    Returns (m, m, B).
    """
    sx = theta[:, 0]
    sy = theta[:, 1]
    return pow10(sy) * torch.exp(-0.5 * pow10(-sx) * sqd[:, :, None])


def k_se_linear_lanes(sqd, theta):
    """Linear-parameterisation SE kernel (GParareal's) for B candidate
    thetas at once: sy^2 exp(-0.5 d2 / sx^2).

    sqd: (m, m) shared squared distances; theta: (B, 2) linear scale.
    Returns (m, m, B). The division is by the tensor sx^2 (a card would
    turn a division by a Python scalar into a product with its
    reciprocal)."""
    sx = theta[:, 0]
    sy = theta[:, 1]
    return (sy * sy) * torch.exp(-0.5 * sqd[:, :, None] / (sx * sx))


def masked_gram_lanes(K, mask, jitter_pow):
    """Masked Gram + jitter: K (m, m, B), mask (m,), jitter_pow (B,).
    Padded rows/cols become identity.

    The identity is f64 whatever K's type, as ``jnp.eye``'s default is in
    the JAX package's 64-bit mode: a Gram of f32 kernel values (the
    scoring's ``dtype``) comes out f64, and is factored in f64."""
    m = K.shape[0]
    m2 = (mask[:, None] * mask[None, :])[:, :, None]
    eye = torch.eye(m, dtype=torch.promote_types(K.dtype, torch.float64),
                    device=K.device)
    Km = K * m2 + (eye * (1.0 - mask)[None, :])[:, :, None]
    return Km + eye[:, :, None] * pow10(jitter_pow)[None, None, :]


def cholesky_lanes(A, pivot_floor=None, diag_ref=None):
    """Cholesky of A (m, m, B), one column at a time; all ops (*, B).

    Column j is A[:, j] less sum_t L[:, t] L[j, t] over t < j, summed as
    ``dot0`` sums: a running sum per column takes each new column's
    products as one FMA (right-looking, one op per column). Column j is
    stored at ``cols[j]`` (m, B), as in the JAX package's
    ``jnp.stack(cols, axis=0)``; the result is returned as (m, m, B).

    ``pivot_floor`` clamps pivot j at ``pivot_floor * diag_ref[j]`` (the
    diagonal of A (m, B) unless given: the blocked factor passes its
    original matrix's) before the square root, as the JAX package does.
    """
    m, _, B = A.shape
    if pivot_floor is not None and diag_ref is None:
        diag_ref = torch.diagonal(A, dim1=0, dim2=1).T
    cols = torch.empty((m, m, B), dtype=A.dtype, device=A.device)
    # acc[k]: the running sum of column k over the columns done so far
    acc = torch.empty_like(cols)
    rows = torch.arange(m, device=A.device)
    for j in range(m):
        s = A[:, j, :]
        if j:
            s = s - acc[j]
        sj = s[j]
        if pivot_floor is not None:
            sj = torch.maximum(sj, pivot_floor * diag_ref[j])
        d = torch.sqrt(sj)
        col = s / d[None, :]
        col[j] = d
        if j:
            col = torch.where((rows >= j)[:, None], col, 0.0)
        cols[j] = col
        if j + 1 < m:
            prod = (col[None, :, :], col[j + 1:, None, :])
            if j:
                acc[j + 1:].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[1:])
    return cols.permute(1, 0, 2)


def solve_lower_lanes(L, Y):
    """Solve L Z = Y; L (m, m, B), Y (m, r, B or 1) -> Z (m, r, B).

    Row j is (Y[j] - sum_t L[j, t] Z[t]) / L[j, j], the sum over t < j in
    increasing t as ``dot0`` sums it (one FMA per solved row into the
    running sums of the rows below)."""
    m, _, B = L.shape
    r = Y.shape[1]
    dt = torch.promote_types(L.dtype, Y.dtype)
    Z = torch.empty((m, r, B), dtype=dt, device=L.device)
    acc = torch.empty_like(Z)
    for j in range(m):
        a = Y[j] - acc[j] if j else Y[j]
        Z[j] = a / L[j, j][None, :]
        if j + 1 < m:
            prod = (Z[j][None], L[j + 1:, j, :][:, None, :])
            if j:
                acc[j + 1:].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[1:])
    return Z


def cholesky_lanes_blocked(A, block=16, pivot_floor=None):
    """Blocked lane-major Cholesky of A (m, m, B): right-looking, per
    block column a ``block``-column ``cholesky_lanes`` of the diagonal
    block, a ``block``-step triangular solve of the panel below it, and
    one batched product for the trailing update, as the JAX package's.

    m need not be a multiple of ``block``: A is padded with identity rows
    and columns to a whole number of blocks, which factor to I. In the
    diagonal block and the panel the sums run as XLA runs them on the CPU,
    an FMA after another over the columns done; the trailing update is one
    batched matrix product (``_sum_outer``), summed in the library's
    order. ``pivot_floor`` clamps each pivot against A's own diagonal, as
    in ``cholesky_lanes``.
    """
    m, _, B = A.shape
    b = min(block, m)
    nb = -(-m // b)
    mp = nb * b
    diagA = torch.diagonal(A, dim1=0, dim2=1).T  # (m, B)
    A = A.clone() if mp == m else _pad_identity(A, mp)
    if mp != m:
        diagA = torch.cat([diagA, diagA.new_ones((mp - m, B))])
    L = torch.zeros_like(A)
    for J in range(nb):
        lo, hi = J * b, (J + 1) * b
        Ljj = cholesky_lanes(A[lo:hi, lo:hi], pivot_floor=pivot_floor,
                             diag_ref=diagA[lo:hi])
        L[lo:hi, lo:hi] = Ljj
        if hi == mp:
            break
        # the panel A[hi:, lo:hi] Ljj^-T, a column at a time: column j is
        # (A[:, j] - sum_t P[:, t] Ljj[j, t]) / Ljj[j, j], its sum kept as
        # a running FMA per column
        acc = A[hi:, lo:hi].clone()  # (r, b, B)
        P = L[hi:, lo:hi]
        for j in range(b):
            P[:, j] = acc[:, j] / Ljj[j, j][None, :]
            if j + 1 < b:
                acc[:, j + 1:].addcmul_(P[:, j][:, None, :],
                                        -Ljj[j + 1:, j][None, :, :])
        # the trailing update A[hi:, hi:] -= P P^T
        A[hi:, hi:] -= _sum_outer(P)
    return L[:m, :m]


def _pad_identity(A, mp):
    """A (m, m, B) in the top-left corner of an (mp, mp, B) identity."""
    m, _, B = A.shape
    out = A.new_zeros((mp, mp, B))
    out[:m, :m] = A
    idx = torch.arange(m, mp, device=A.device)
    out[idx, idx] = 1.0
    return out


def _sum_outer(P):
    """P P^T over the middle axis of P (r, b, B), (r, r, B): one batched
    product over the lanes, as the JAX package's ``einsum('ikb,jkb->ijb')``
    (the library's sum order, not XLA's)."""
    Pb = P.permute(2, 0, 1)  # (B, r, b)
    return torch.matmul(Pb, Pb.transpose(1, 2)).permute(1, 2, 0)


def solve_lower_lanes_blocked(L, Y, block=16):
    """Blocked forward substitution: L Z = Y with L (m, m, B) lower,
    Y (m, r, B or 1) -> Z (m, r, B). Per block of ``block`` rows (the
    last one short when m is not a multiple): the rows solved so far
    enter as one product, summed an FMA after another over those rows,
    then the block's rows are solved one after another, each taking the
    rows above it off one FMA at a time (``_solve_lower_running``)."""
    m, _, B = L.shape
    b = min(block, m)
    zs = []
    for lo in range(0, m, b):
        hi = min(lo + b, m)
        acc = Y[lo:hi]
        if lo:
            Zprev = torch.cat(zs)  # (lo, r, B)
            Lrow = L[lo:hi, :lo]  # (bJ, lo, B)
            acc = acc - dot0(Lrow.transpose(0, 1)[:, :, None, :],
                             Zprev[:, None, :, :])
        zs.append(_solve_lower_running(L[lo:hi, lo:hi], acc, B))
    return torch.cat(zs)


def _solve_lower_running(L, Y, B):
    """Solve L Z = Y for one diagonal block, as the JAX package's blocked
    substitution does: row j starts from Y[j] and takes the solved rows'
    products off it one FMA at a time, then divides by L[j, j]."""
    m = L.shape[0]
    acc = Y.expand(-1, -1, B).clone()
    Z = torch.empty_like(acc)
    for j in range(m):
        Z[j] = acc[j] / L[j, j][None, :]
        if j + 1 < m:
            acc[j + 1:].addcmul_(Z[j][None], -L[j + 1:, j][:, None, :])
    return Z


def solve_upper_lanes(U, Y):
    """Solve U X = Y with U upper-triangular (m, m, B), Y (m, r, B).

    Rows are solved from the last up; row j's sum over the rows below it
    takes them in that order (the JAX package stacks them as solved), one
    FMA per solved row into the running sums of the rows above."""
    m, _, B = U.shape
    r = Y.shape[1]
    X = torch.empty((m, r, B), dtype=torch.promote_types(U.dtype, Y.dtype),
                    device=U.device)
    acc = torch.empty_like(X)
    for j in range(m - 1, -1, -1):
        a = Y[j] - acc[j] if j < m - 1 else Y[j]
        X[j] = a / U[j, j][None, :]
        if j:
            prod = (X[j][None], U[:j, j, :][:, None, :])
            if j < m - 1:
                acc[:j].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[:j])
    return X


def _cast(dtype, *xs):
    """The scoring inputs in ``dtype`` (None: as they are)."""
    if dtype is None:
        return xs
    return tuple(x.to(dtype) for x in xs)


def _targets(Y, mask):
    """Masked targets (m, r, 1) of Y (m, r), or (m, r, B) of Y (m, r, B)."""
    if Y.dim() == 2:
        return (Y * mask[:, None])[:, :, None]  # broadcasts over B
    return Y * mask[:, None, None]


def _f64_or_inf(x):
    """x in f64 (at least), non-finite values +inf."""
    x = x.to(torch.promote_types(x.dtype, torch.float64))
    return torch.where(torch.isfinite(x), x, torch.inf)


def nll_lanes(sqd, Y, theta, jitter_pow, mask, dtype=None):
    """Masked GP NLL for B (theta, jitter) candidates sharing one dataset.

    sqd: (m, m); Y: (m, r) targets (r coordinates) or (m, r, B) per-task;
    theta: (B, 2); jitter_pow: (B,); mask: (m,).
    Returns (r, B) NLL values (non-finite -> +inf) in f64.

    ``dtype`` (e.g. ``torch.float32``) down-casts the scoring inputs, as
    the JAX package does: the kernel values and the jitter's power are
    rounded to ``dtype``, the Gram they make is f64 (``masked_gram_lanes``)
    and so are the factor and the solve; the constant term is rounded to
    ``dtype``. The posterior stays f64. Every step here is an elementwise
    op or an FMA (no matrix product), so the TF32 setting of a card never
    applies.
    """
    sqd, Y, theta, jitter_pow, mask = _cast(dtype, sqd, Y, theta,
                                            jitter_pow, mask)
    K = k_se_log10_lanes(sqd, theta)
    Kj = masked_gram_lanes(K, mask, jitter_pow)
    L = cholesky_lanes(Kj)
    Z = solve_lower_lanes(L, _targets(Y, mask))  # (m, r, B)
    quad = 0.5 * dot0(Z, Z)  # (r, B)
    diag = torch.diagonal(L, dim1=0, dim2=1).T  # (m, B)
    logdet = sum0(torch.where(mask[:, None] > 0, torch.log(diag), 0.0))
    count = torch.sum(mask)
    return _f64_or_inf(quad + logdet[None, :] + 0.5 * count * _LOG_2PI)


def loo_lanes(sqd, Y, theta, jitter_pow, mask, dtype=None):
    """Masked leave-one-out squared-residual score for B candidates.

    Closed form (Rasmussen & Williams sec. 5.4.2): with alpha = K^-1 y and
    c = diag(K^-1), the LOO residual at point i is alpha_i / c_i. Returns
    the masked sum of squared LOO residuals, (r, B) in f64, non-finite ->
    +inf. Arguments as ``nll_lanes``.
    """
    sqd, Y, theta, jitter_pow, mask = _cast(dtype, sqd, Y, theta,
                                            jitter_pow, mask)
    K = k_se_log10_lanes(sqd, theta)
    Kj = masked_gram_lanes(K, mask, jitter_pow)
    L = cholesky_lanes(Kj)
    Z = solve_lower_lanes(L, _targets(Y, mask))
    alpha = solve_upper_lanes(L.transpose(0, 1), Z)  # (m, r, B)
    m = sqd.shape[0]
    eye = torch.eye(m, dtype=L.dtype, device=L.device)[:, :, None]
    W = solve_lower_lanes(L, eye.expand(L.shape))  # L^-1, (m, m, B)
    cdiag = dot0(W, W)  # diag(K^-1): the column sums of squares of L^-1
    resid = alpha / cdiag[:, None, :]
    # mask is 0 or 1: the products are exact, so this is XLA's FMA sum
    return _f64_or_inf(sum0((resid * resid) * mask[:, None, None]))


def posterior_mean_lanes(sqd, sqd_q, Y, theta, jitter_pow, mask):
    """Posterior means for B per-coordinate (theta, jitter) picks.

    sqd: (m, m); sqd_q: (m,); Y: (m, B) one target column per task;
    theta: (B, 2); jitter_pow: (B,). Returns (B,); NaN where the
    factorisation failed.
    """
    K = k_se_log10_lanes(sqd, theta)
    Kj = masked_gram_lanes(K, mask, jitter_pow)
    L = cholesky_lanes(Kj)
    Ym = (Y * mask[:, None])[:, None, :]  # (m, 1, B)
    Z = solve_lower_lanes(L, Ym)
    alpha = solve_upper_lanes(L.transpose(0, 1), Z)[:, 0, :]  # (m, B)
    k_star = k_se_log10_lanes(sqd_q[:, None], theta)[:, 0, :] * mask[:, None]
    return dot0(k_star, alpha)


def posterior_mean_lu(sqd, sqd_q, Y, theta, jitter_pow, mask):
    """Posterior means through a batched LU solve (partial pivoting) in
    place of the Cholesky: at the interpolation boundary (near-duplicate
    rows, a jitter below f64 resolution of the Gram) the factor fails but
    the system K alpha = y is still solvable, as the reference's
    ``np.linalg.solve`` solves it.

    Arguments as ``posterior_mean_lanes``; returns (B,). The solve is the
    library's (``torch.linalg.solve_ex``, on a card cuSOLVER's getrf; the
    JAX package's is ``jnp.linalg.solve``): a singular system gives
    non-finite values, with nothing read back.
    """
    K = k_se_log10_lanes(sqd, theta)
    A = masked_gram_lanes(K, mask, jitter_pow).permute(2, 0, 1)  # (B, m, m)
    y = (Y * mask[:, None]).T[:, :, None]  # (B, m, 1)
    alpha = torch.linalg.solve_ex(A, y)[0][:, :, 0]  # (B, m)
    k_star = k_se_log10_lanes(sqd_q[:, None], theta)[:, 0, :] * mask[:, None]
    return dot0(k_star, alpha.T)


def nll_lanes_big(sqd, Y, theta, jitter_pow, mask, kernel=k_se_log10_lanes,
                  dtype=None, pivot_floor=None, block=16):
    """Masked GP NLL for B candidates at Gram sizes past the column loop's
    reach: the contract of ``nll_lanes`` ((r, B) in f64, non-finite ->
    +inf), built on the blocked factor and substitution. ``kernel`` is
    ``k_se_log10_lanes`` or ``k_se_linear_lanes`` (GParareal's)."""
    sqd, Y, theta, jitter_pow, mask = _cast(dtype, sqd, Y, theta,
                                            jitter_pow, mask)
    K = kernel(sqd, theta)
    Kj = masked_gram_lanes(K, mask, jitter_pow)
    L = cholesky_lanes_blocked(Kj, block=block, pivot_floor=pivot_floor)
    Z = solve_lower_lanes_blocked(L, _targets(Y, mask), block=block)
    quad = 0.5 * dot0(Z, Z)  # (r, B)
    diag = torch.diagonal(L, dim1=0, dim2=1).T  # (m, B)
    logdet = sum0(torch.where(mask[:, None] > 0, torch.log(diag), 0.0))
    count = torch.sum(mask)
    return _f64_or_inf(quad + logdet[None, :] + 0.5 * count * _LOG_2PI)
