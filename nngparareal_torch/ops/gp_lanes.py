"""Batched GP kernels with the candidate batch in the LAST axis.

Port of ``nngparareal_tpu/ops/gp_lanes.py`` (the parts the nnGP grid
search runs). Matrices are stored (m, m, B) for B (theta, jitter)
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


def k_se_log10_lanes(sqd, theta):
    """SE kernel values for B candidate thetas at once.

    sqd: (m, m) shared squared distances; theta: (B, 2) log10-scale.
    Returns (m, m, B).
    """
    sx = theta[:, 0]
    sy = theta[:, 1]
    return torch.pow(10.0, sy) * torch.exp(
        -0.5 * torch.pow(10.0, -sx) * sqd[:, :, None])


def masked_gram_lanes(K, mask, jitter_pow):
    """Masked Gram + jitter: K (m, m, B), mask (m,), jitter_pow (B,).
    Padded rows/cols become identity."""
    m = K.shape[0]
    m2 = (mask[:, None] * mask[None, :])[:, :, None]
    eye = torch.eye(m, dtype=K.dtype, device=K.device)
    Km = K * m2 + (eye * (1.0 - mask)[None, :])[:, :, None]
    return Km + eye[:, :, None] * torch.pow(10.0, jitter_pow)[None, None, :]


def cholesky_lanes(A):
    """Cholesky of A (m, m, B), one column at a time; all ops (*, B).

    Column j is stored at ``cols[j]`` (m, B), as in the JAX package's
    ``jnp.stack(cols, axis=0)``; the result is returned as (m, m, B).
    """
    m, _, B = A.shape
    cols = torch.empty((m, m, B), dtype=A.dtype, device=A.device)
    rows = torch.arange(m, device=A.device)
    for j in range(m):
        s = A[:, j, :]
        if j:
            prior = cols[:j]  # (j, m, B)
            Lj = prior[:, j, :]  # (j, B)
            s = s - torch.sum(prior * Lj[:, None, :], dim=0)
        d = torch.sqrt(s[j])
        col = s / d[None, :]
        col[j] = d
        if j:
            col = torch.where((rows >= j)[:, None], col, 0.0)
        cols[j] = col
    return cols.permute(1, 0, 2)


def solve_lower_lanes(L, Y):
    """Solve L Z = Y; L (m, m, B), Y (m, r, B or 1) -> Z (m, r, B)."""
    m, _, B = L.shape
    r = Y.shape[1]
    Z = torch.empty((m, r, B), dtype=torch.promote_types(L.dtype, Y.dtype),
                    device=L.device)
    for j in range(m):
        acc = Y[j]
        if j:
            Lrow = L[j, :j, :]  # (j, B)
            acc = acc - torch.sum(Z[:j] * Lrow[:, None, :], dim=0)
        Z[j] = acc / L[j, j][None, :]
    return Z


def solve_upper_lanes(U, Y):
    """Solve U X = Y with U upper-triangular (m, m, B), Y (m, r, B)."""
    m, _, B = U.shape
    r = Y.shape[1]
    X = torch.empty((m, r, B), dtype=torch.promote_types(U.dtype, Y.dtype),
                    device=U.device)
    # done[idx] holds row m-1-idx: the JAX package sums rows j+1.. in
    # reverse order (stacked as they were solved)
    done = torch.empty_like(X)
    for idx, j in enumerate(range(m - 1, -1, -1)):
        acc = Y[j]
        if idx:
            Urow = U[j, j + 1:, :].flip(0)  # (idx, B), rows m-1 .. j+1
            acc = acc - torch.sum(done[:idx] * Urow[:, None, :], dim=0)
        val = acc / U[j, j][None, :]
        done[idx] = val
        X[j] = val
    return X


def nll_lanes(sqd, Y, theta, jitter_pow, mask):
    """Masked GP NLL for B (theta, jitter) candidates sharing one dataset.

    sqd: (m, m); Y: (m, r) targets (r coordinates) or (m, r, B) per-task;
    theta: (B, 2); jitter_pow: (B,); mask: (m,).
    Returns (r, B) NLL values (non-finite -> +inf).
    """
    K = k_se_log10_lanes(sqd, theta)
    Kj = masked_gram_lanes(K, mask, jitter_pow)
    L = cholesky_lanes(Kj)
    if Y.dim() == 2:
        Ym = (Y * mask[:, None])[:, :, None]  # (m, r, 1), broadcasts over B
    else:
        Ym = Y * mask[:, None, None]
    Z = solve_lower_lanes(L, Ym)  # (m, r, B)
    quad = 0.5 * torch.sum(Z * Z, dim=0)  # (r, B)
    diag = torch.diagonal(L, dim1=0, dim2=1).T  # (m, B)
    logdet = torch.sum(
        torch.where(mask[:, None] > 0, torch.log(diag), 0.0), dim=0)
    count = torch.sum(mask)
    nll = quad + logdet[None, :] + 0.5 * count * _LOG_2PI
    return torch.where(torch.isfinite(nll), nll, torch.inf)


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
    return torch.sum(k_star * alpha, dim=0)
