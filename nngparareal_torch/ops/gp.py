"""Gaussian-process linear algebra for the GP models, batched and masked.

Port of ``nngparareal_tpu/ops/gp.py``. The distances use the EXACT
difference form, never the matmul expansion |x|^2+|y|^2-2xy (which
``torch.cdist`` switches to above 25 rows): the expansion's cancellation
error exceeds the true squared distances between a query and its own
convergence history at late iterations, and the JAX package measured it
inflating K (ops/gp.py there).

The kernel, Cholesky and NLL functions take a validity mask, so that a
dataset padded to a fixed size contributes only its valid rows: padded rows
become identity rows of the Gram and zeros of the targets. Where the JAX
package vmaps them, the port takes the batch as leading axes: a Gram
(..., M, M), targets (..., M), thetas (..., 2), jitter exponents (...);
the mask (M,) is shared, or (..., M) has batch axes of its own (each
chain of the time-augmented nnGP has its own rows). Up to ``SMALL_M``
rows the factorisation is ``ops.linalg_small``'s column loop; above it
``torch.linalg.cholesky_ex`` (on a card cuSOLVER's batched potrf), whose
failure is mapped to an all-NaN factor, as ``jnp.linalg.cholesky``
returns one, without reading anything back; an f32 NLL above it factors
in ``ops.chol_blocked``. A non-finite NLL is +inf: that is what excludes
a candidate from the search.
"""

import math

import torch

from nngparareal_torch.ops.chol_blocked import chol_diag_solve
from nngparareal_torch.ops.gp_lanes import dot0, pow10, sum0
from nngparareal_torch.ops.linalg_small import (
    chol_solve_small,
    cholesky_small,
    solve_lower_small,
)

_LOG_2PI = math.log(2 * math.pi)

# up to this many rows the column-loop Cholesky and solves of
# ops.linalg_small; above it the library factorisation
SMALL_M = 48

# rows of x per block: keeps the (rows, Ny, d) difference tensor near 64 MB
_BLOCK_ELEMS = 1 << 23


def pairwise_sq_dists(x, y):
    """Squared euclidean distances, (Nx, d) x (Ny, d) -> (Nx, Ny)."""
    Nx, d = x.shape
    Ny = y.shape[0]
    bs = max(1, _BLOCK_ELEMS // max(Ny * d, 1))
    blocks = []
    for lo in range(0, Nx, bs):
        diff = x[lo:lo + bs, None, :] - y[None, :, :]
        blocks.append(torch.sum(diff * diff, dim=-1))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def sq_dists_to(query, X):
    """Squared distances of each row of X (CAP, d) to a single query (d,)."""
    diff = X - query[None, :]
    return torch.sum(diff * diff, dim=-1)


def _theta_parts(theta, sqd):
    """sigma_x, sigma_y of thetas (..., 2), shaped to broadcast against
    ``sqd`` as (..., *sqd.shape)."""
    shape = theta.shape[:-1] + (1,) * sqd.dim()
    return theta[..., 0].reshape(shape), theta[..., 1].reshape(shape)


def k_se_log10(sqd, theta):
    """SE kernel in log10 parameterisation: 10^sy * exp(-0.5 * 10^-sx * d2)
    (the nnGP's); theta (..., 2) log10-scale -> (..., *sqd.shape)."""
    sx, sy = _theta_parts(theta, sqd)
    return pow10(sy) * torch.exp(-0.5 * pow10(-sx) * sqd)


def k_se_linear(sqd, theta):
    """SE kernel in linear parameterisation: sy^2 * exp(-0.5 d2 / sx^2)
    (GParareal's); theta (..., 2) -> (..., *sqd.shape). The division is by
    the tensor sx^2: a card would turn a division by a Python scalar into
    a product with its reciprocal."""
    sx, sy = _theta_parts(theta, sqd)
    return (sy * sy) * torch.exp(-0.5 * sqd / (sx * sx))


def _masked_gram_abs(K, mask, jitter_abs):
    """_masked_gram with the jitter given in absolute (linear) scale;
    ``jitter_abs`` is a number or a tensor of K's batch shape."""
    M = K.shape[-1]
    eye = torch.eye(M, dtype=K.dtype, device=K.device)
    m2 = mask[..., :, None] * mask[..., None, :]
    Km = K * m2 + torch.diag_embed(1.0 - mask)
    if torch.is_tensor(jitter_abs):
        jitter_abs = jitter_abs[..., None, None]
    return Km + jitter_abs * eye


def _masked_gram(K, mask, jitter_pow):
    """Zero the padded rows and columns of K (..., M, M), put ones on
    their diagonal, and add 10^jitter_pow on the whole diagonal."""
    return _masked_gram_abs(K, mask, _pow10(jitter_pow, K))


def _pow10(x, like):
    if not torch.is_tensor(x):
        x = torch.tensor(float(x), dtype=like.dtype)
    return pow10(x.to(device=like.device, dtype=like.dtype))


def cholesky_nan(A):
    """Lower Cholesky factor of A (..., M, M) from the library, all NaN
    where the factorisation failed (nothing is read back to the host)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _solve_lower(L, y):
    return torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]


def gp_fit(K, y, jitter_pow, mask):
    """Cholesky fit of a masked GP: returns (L, alpha), alpha solving
    (K_masked + 10^jitter I) alpha = y_masked; padded entries of alpha
    come out 0."""
    Kj = _masked_gram(K, mask, jitter_pow)
    ym = y * mask
    if K.shape[-1] <= SMALL_M:
        L = cholesky_small(Kj)
        return L, chol_solve_small(L, ym)
    L = cholesky_nan(Kj)
    z = _solve_lower(L, ym)
    alpha = torch.linalg.solve_triangular(
        L.transpose(-1, -2), z[..., None], upper=True)[..., 0]
    return L, alpha


def _sum_last(x):
    """Sum over the last axis; up to SMALL_M terms one after another, as
    the jitted JAX function sums a short row."""
    if x.shape[-1] <= SMALL_M:
        return sum0(x.movedim(-1, 0))
    return torch.sum(x, dim=-1)


def gp_nll(K, y, jitter_pow, mask, rel_floor=None):
    """Masked negative log marginal likelihood (non-finite -> +inf).

    nll = 0.5 ||L^-1 y||^2 + sum_valid log diag(L) + (count/2) log 2pi.
    ``rel_floor``: the jitter is max(10^jitter_pow, rel_floor * gersh(K)),
    gersh the Gershgorin bound on lambda_max (the largest masked absolute
    row sum): the f32 scoring's floor (ops/gp.py of the JAX package says
    why). An f32 Gram above SMALL_M rows factors in ops.chol_blocked.
    """
    jit_abs = _pow10(jitter_pow, K)
    m2 = mask[..., :, None] * mask[..., None, :]
    if rel_floor is not None:
        gersh = torch.amax(torch.sum(torch.abs(K) * m2, dim=-1), dim=-1)
        jit_abs = torch.maximum(jit_abs, rel_floor * gersh)
    Kj = _masked_gram_abs(K, mask, jit_abs)
    ym = y * mask
    count = torch.sum(mask, dim=-1)
    M = K.shape[-1]
    if M <= SMALL_M:
        L = cholesky_small(Kj)
        z = solve_lower_small(L, ym)
        quad = 0.5 * dot0(z.movedim(-1, 0), z.movedim(-1, 0))
        diagL = torch.diagonal(L, dim1=-2, dim2=-1)
    elif K.dtype == torch.float32:
        diagL, z = chol_diag_solve(Kj, ym)
        quad = 0.5 * torch.sum(z * z, dim=-1)
    else:
        L = cholesky_nan(Kj)
        z = _solve_lower(L, ym)
        quad = 0.5 * torch.sum(z * z, dim=-1)
        diagL = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = _sum_last(torch.where(mask > 0, torch.log(diagL[..., :M]), 0.0))
    nll = quad + logdet + 0.5 * count * _LOG_2PI
    return torch.where(torch.isfinite(nll), nll, torch.inf)


def gp_posterior_mean(k_star, alpha):
    """Posterior mean k(X, x*)^T alpha; k_star already mask-consistent."""
    return torch.sum(k_star * alpha, dim=-1)


def nll_from_sqd(sqd, y, theta, jitter_pow, mask, kernel, rel_floor=None):
    """NLL given a precomputed squared-distance matrix; theta (..., 2)."""
    return gp_nll(kernel(sqd, theta), y, jitter_pow, mask,
                  rel_floor=rel_floor)


def predict_mean_from_sqd(sqd_xx, sqd_xq, y, theta, jitter_pow, mask,
                          kernel):
    """Posterior mean at a query from precomputed squared distances:
    sqd_xx (M, M) train/train, sqd_xq (M,) train/query, y (..., M)."""
    K = kernel(sqd_xx, theta)
    _, alpha = gp_fit(K, y, jitter_pow, mask)
    k_star = kernel(sqd_xq, theta) * mask
    return gp_posterior_mean(k_star, alpha)
