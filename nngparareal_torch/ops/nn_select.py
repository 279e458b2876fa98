"""Nearest-neighbour dataset selection.

Port of ``nngparareal_tpu/ops/nn_select.py``: masked squared distances to
every row of the padded dataset, then the m smallest. ``lax.top_k`` puts
the lower index first among equal distances, and duplicate dataset rows
are normal here (a frozen slice appends identical states), so the port
takes the first m of a *stable* ascending sort rather than ``torch.topk``,
which promises no order for ties.
"""

import torch


def nearest_neighbors(query, X, valid, m):
    """Indices of the m nearest valid rows of X to ``query``.

    query: (d,), X: (CAP, d), valid: (CAP,) float mask, m: int.
    Returns (idx (m,), sqd (m,)) nearest-first; invalid rows never win
    (their distance is +inf). If fewer than m rows are valid the trailing
    indices point at +inf rows: callers mask with ``sqd < inf``.
    """
    diff = X - query[None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid > 0, d2, torch.inf)
    sqd, idx = torch.sort(d2, stable=True)
    return idx[:m], sqd[:m]
