"""Dense linear algebra for small matrices (m <= 48), one column per step.

Port of ``nngparareal_tpu/ops/linalg_small.py``. The JAX package unrolls
the column recurrence at trace time into straight-line batched ops; here
each step is one batched torch op, and the leading axes are the batch.

Every sum runs as the jitted JAX function computes it on the CPU: one
fused multiply-add after another (``addcmul``), in the JAX loop's order,
kept as a running sum per output that each new column or solved entry
updates with one op (right-looking). A failed factorisation (a non-PSD
input) gives NaN, which propagates, as in the JAX package; the GP NLL
maps it to +inf.
"""

import torch


def cholesky_small(A):
    """Cholesky of A (..., m, m); the lower factor.

    Column j is s = A[:, j] - sum_{k<j} L[:, k] L[j, k] divided by
    sqrt(s[j]) (so the diagonal is s[j] / sqrt(s[j]), as in JAX), with its
    rows above j set to 0.
    """
    m = A.shape[-1]
    L = torch.empty_like(A)
    # acc[..., :, c]: column c's running sum over the columns done so far
    acc = torch.empty_like(A)
    rows = torch.arange(m, device=A.device)
    for j in range(m):
        s = A[..., :, j] - acc[..., :, j] if j else A[..., :, j]
        d = torch.sqrt(s[..., j])
        col = s / d[..., None]
        if j:
            col = torch.where(rows >= j, col, 0.0)
        L[..., :, j] = col
        if j + 1 < m:
            prod = (col[..., :, None], col[..., None, j + 1:])
            if j:
                acc[..., :, j + 1:].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[..., :, 1:])
    return L


def solve_lower_small(L, y):
    """Solve L z = y with L (..., m, m) lower-triangular, y (..., m)."""
    return solve_lower_small_mrhs(L, y[..., None])[..., 0]


def solve_upper_small(U, y):
    """Solve U x = y with U (..., m, m) upper-triangular, y (..., m).

    Row j is solved after the rows below it, its sum taken over them from
    the last row up, as the JAX package stacks them."""
    m = U.shape[-1]
    shape = torch.broadcast_shapes(U.shape[:-2], y.shape[:-1]) + (m,)
    dt = torch.promote_types(U.dtype, y.dtype)
    x = torch.empty(shape, dtype=dt, device=U.device)
    acc = torch.empty_like(x)
    for j in range(m - 1, -1, -1):
        a = y[..., j] - acc[..., j] if j < m - 1 else y[..., j]
        x[..., j] = a / U[..., j, j]
        if j:
            prod = (U[..., :j, j], x[..., j, None])
            if j < m - 1:
                acc[..., :j].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[..., :j])
    return x


def chol_solve_small(L, y):
    """Solve (L L^T) alpha = y."""
    z = solve_lower_small(L, y)
    return solve_upper_small(L.transpose(-1, -2), z)


def solve_lower_small_mrhs(L, Y):
    """Solve L Z = Y with L (..., m, m) lower-triangular, Y (..., m, r):
    one factorisation serves every right-hand side."""
    m = L.shape[-1]
    shape = torch.broadcast_shapes(L.shape[:-2], Y.shape[:-2]) + Y.shape[-2:]
    dt = torch.promote_types(L.dtype, Y.dtype)
    Z = torch.empty(shape, dtype=dt, device=L.device)
    acc = torch.empty_like(Z)
    for j in range(m):
        a = Y[..., j, :] - acc[..., j, :] if j else Y[..., j, :]
        Z[..., j, :] = a / L[..., j, j, None]
        if j + 1 < m:
            prod = (L[..., j + 1:, j, None], Z[..., j, None, :])
            if j:
                acc[..., j + 1:, :].addcmul_(*prod)
            else:
                torch.mul(*prod, out=acc[..., 1:, :])
    return Z
