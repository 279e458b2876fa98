"""ELM corrector: a random-feature extreme learning machine on an m-NN
subset.

Port of ``nngparareal_tpu/models/elm.py``: degree-2 polynomial features,
a fixed random projection (bias and weights uniform in [-1, 1], drawn
from ``numpy.random.default_rng(seed)`` in the JAX package's order), a
relu, tanh or radbas activation, and a weighted centred ridge regression
fitted on the m nearest dataset rows of each query.

The ridge system is (H_c^T H_c + (alpha + 1e-10) I) beta = H_c^T Y_c with
at most m rows of H against ``res_size`` columns: the directions H does
not span are fixed by the 1e-10 ridge alone, so the solve (the library's
``torch.linalg.solve_ex``; the JAX package's is ``jnp.linalg.solve``) is
near-singular there and two LU factorisations may part by far more than
one rounding in those directions. ``set_projection`` takes the JAX
model's arrays (``convert.elm_params_from_jax``).
"""

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops.nn_select import nearest_neighbors


def _poly2(x):
    """Degree-2 polynomial features of x (..., d) -> (..., 1 + d +
    d(d+1)/2): the constant, x, and x_i x_j for i <= j in row-major
    order (the set of sklearn's PolynomialFeatures(degree=2))."""
    d = x.shape[-1]
    iu = torch.triu_indices(d, d, device=x.device)
    quad = (x[..., :, None] * x[..., None, :])[..., iu[0], iu[1]]
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([ones, x, quad], dim=-1)


def n_poly2(d):
    return 1 + d + d * (d + 1) // 2


def _radbas(x):
    return torch.exp(-(x * x))


_LOSSES = {
    "relu": lambda x: torch.clamp(x, min=0.0),
    "tanh": torch.tanh,
    "radbas": _radbas,
    # the reference registers radbas under a misspelled key
    "radbad": _radbas,
}


class ELM(ModelBase):
    name = "ELM"

    def __init__(self, n, N, seed=47, res_size=20, loss="relu", M=1.0,
                 R=1.0, alpha=0.0, degree=2, m=4):
        super().__init__(n, N)
        if degree != 2:
            raise NotImplementedError("only degree-2 polynomial features")
        self.m = int(m)
        self.res_size = int(res_size)
        self.loss = _LOSSES[loss]
        self.M, self.R, self.alpha = float(M), float(R), float(alpha)
        rng = np.random.default_rng(seed)
        P = n_poly2(n)
        # host copies; the device copies are made once per device
        self._bias = rng.uniform(-1, 1, (self.res_size, 1))
        self._C = rng.uniform(-1, 1, (self.res_size, P))
        self._dev = {}
        self.k = 0

    def set_projection(self, bias, C):
        """Set the random projection from host arrays: bias (res_size, 1),
        C (res_size, P)."""
        bias = np.array(bias, dtype=np.float64)
        C = np.array(C, dtype=np.float64)
        if bias.shape != self._bias.shape or C.shape != self._C.shape:
            raise ValueError(f"projection shapes {bias.shape}, {C.shape}; "
                             f"expected {self._bias.shape}, {self._C.shape}")
        self._bias, self._C = bias, C
        self._dev = {}

    def _projection(self, device):
        """(bias (res,), R * C (res, P)) on ``device``."""
        p = self._dev.get(device)
        if p is None:
            bias = torch.as_tensor(self._bias[:, 0], device=device)
            # the reference overwrites the M * R scaling of the bias
            C = torch.as_tensor(self.R * self._C, device=device)
            p = self._dev[device] = (bias, C)
        return p

    def fit(self, ds, k):
        self.k = int(k)
        return None

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        m = min(self.m, ds.capacity)
        idx, _ = nearest_neighbors(q, ds.X, ds.valid, m)
        xm = ds.X[idx]  # (m, n)
        ym = ds.D[idx]  # (m, n)
        w = ds.valid[idx]  # (m,)
        bias, C = self._projection(q.device)

        H = self.loss(bias + _poly2(xm) @ C.T)  # (m, res)
        h_new = self.loss(bias + C @ _poly2(q))  # (res,)

        # weighted centred ridge (sklearn's Ridge fits an intercept)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        Hm = torch.sum(H * w[:, None], dim=0) / wsum
        Ym = torch.sum(ym * w[:, None], dim=0) / wsum
        Hc = (H - Hm) * w[:, None]
        Yc = (ym - Ym) * w[:, None]
        eye = torch.eye(H.shape[1], dtype=H.dtype, device=H.device)
        A = Hc.T @ Hc + (self.alpha + 1e-10) * eye
        # solve_ex: a singular system gives non-finite values (as the JAX
        # package's LU does) instead of a check that waits for the card
        beta = torch.linalg.solve_ex(A, Hc.T @ Yc)[0]  # (res, n)
        return Ym + (h_new - Hm) @ beta
