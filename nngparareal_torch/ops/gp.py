"""Squared distances for the GP models.

Port of ``nngparareal_tpu/ops/gp.py:pairwise_sq_dists`` and
``sq_dists_to``. Both use the EXACT difference form, never the matmul
expansion |x|^2+|y|^2-2xy (which ``torch.cdist`` switches to above 25
rows): the expansion's cancellation error exceeds the true squared
distances between a query and its own convergence history at late
iterations, and the JAX package measured it inflating K (ops/gp.py there).
"""

import torch

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
