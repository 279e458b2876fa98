"""k-NN mean-of-neighbours comparison model.

Port of ``nngparareal_tpu/models/knn_mean.py``: the defect predicted as
the plain average of the m nearest dataset defects, the baseline of the
paper's Figure 2 (a local GP against naive neighbour averaging).
"""

import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops.gp_lanes import sum0
from nngparareal_torch.ops.nn_select import nearest_neighbors


class KNNMean(ModelBase):
    name = "kNN-mean"

    def __init__(self, n, N, nn=15):
        super().__init__(n, N)
        self.nn = nn
        self.k = 0

    def m_for(self, k):
        if isinstance(self.nn, str) and self.nn == "adaptive":
            return max(10, int(k) + 2)
        return int(self.nn)

    def fit(self, ds, k):
        self.k = int(k)
        return None

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        m = min(self.m_for(self.k), ds.capacity)
        idx, sqd_sel = nearest_neighbors(q, ds.X, ds.valid, m)
        ym = ds.D[idx]
        w = torch.isfinite(sqd_sel).to(ym.dtype)
        # the leading-axis sums in XLA's order (ops/gp_lanes.py:sum0)
        return sum0(ym * w[:, None]) / torch.clamp(sum0(w), min=1.0)
