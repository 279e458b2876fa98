"""GParareal trained by scipy's Nelder-Mead, one task at a time: the host
oracle of the full-dataset GP.

Port of ``nngparareal_tpu/models/gp_scipy.py`` (numpy and scipy, so nearly
verbatim). One GP per state coordinate on the valid dataset rows,
linear-scale SE kernel sy^2 exp(-d^2 / (2 sx^2)), trained once per
iteration by ``scipy.optimize.minimize`` Nelder-Mead for each (coordinate,
jitter 10^{-20..-12}) warm-started from the previous optimum; a coordinate
whose best NLL is +inf gets random restarts theta ~ 10^U(-4, 1), for at
most 20 rounds of max(3, N/9) x 9 restarts. Prediction keeps one solve per
(theta, jitter, coordinate) for the iteration.

scipy's per-task early stop makes it about an order of magnitude faster on
one CPU core than the lockstep batched search of ``models/gp.py``: the CPU
oracle of the GP column. ``fit`` reads the dataset back to the host once
per iteration; ``predict_fn`` returns a tensor on the query's device.
"""

import numpy as np
import torch
from scipy.optimize import minimize

from nngparareal_torch.models.base import ModelBase


def _nll_gp(d2, y, theta, jitter):
    """The GP's NLL; a failed Cholesky (or a NaN) is +inf."""
    m = y.shape[0]
    sx, sy = theta
    K = (sy * sy) * np.exp(-0.5 * d2 / (sx * sx)) + np.eye(m) * 10.0 ** jitter
    try:
        L = np.linalg.cholesky(K)
    except np.linalg.LinAlgError:
        return np.inf
    al = np.linalg.solve(L.T, np.linalg.solve(L, y))
    val = (
        0.5 * y @ al
        + np.log(np.diag(L)).sum()
        + 0.5 * m * np.log(2 * np.pi)
    )
    return np.inf if np.isnan(val) else val


class GPScipy(ModelBase):
    name = "GP_scipy"

    def __init__(self, n, N, theta=None, fatol=None, xatol=None, seed=45):
        super().__init__(n, N)
        theta = [1.0, 1.0] if theta is None else theta
        self.theta0 = np.asarray(theta, float)
        self.thetas = [self.theta0.copy() for _ in range(self.n)]
        self.jitter_sel = [None] * self.n
        self.fatol = 1e-4 if fatol is None else float(fatol)
        self.xatol = 1e-4 if xatol is None else float(xatol)
        self.rng = np.random.default_rng(int(seed))
        self.seed = int(seed)
        self.k = 0
        self._jitters = np.arange(-20.0, -11.0)
        self._X = self._D = None
        self._d2 = None
        self._mem = {}

    def reset_rng(self):
        self.rng = np.random.default_rng(self.seed)

    def _minimize(self, d2, y, th0, jit):
        return minimize(
            lambda th: _nll_gp(d2, y, th, jit), th0, method="Nelder-Mead",
            options={"fatol": self.fatol, "xatol": self.xatol})

    def _train_coord_rnd(self, d2, y, depth=0):
        """Random-restart rescue of one coordinate, bounded recursion."""
        tot_rnd = max(3, int(self.N / 9))
        best = (np.inf, None, None)
        for _ in range(tot_rnd):
            for jit in self._jitters:
                res = self._minimize(d2, y, 10.0 ** self.rng.uniform(-4, 1, 2),
                                     jit)
                if res.fun < best[0]:
                    best = (res.fun, res.x, jit)
        if not np.isfinite(best[0]):
            if depth >= 20:
                raise RuntimeError("GP random-restart rescue failed")
            return self._train_coord_rnd(d2, y, depth + 1)
        return best

    def fit(self, ds, k):
        self.k = int(k)
        self._mem = {}
        valid = ds.valid.cpu().numpy() > 0
        self._X = ds.X.cpu().numpy()[valid]
        self._D = ds.D.cpu().numpy()[valid]
        X = self._X
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        self._d2 = d2
        for c in range(self.n):
            y = self._D[:, c]
            best = (np.inf, None, None)
            for jit in self._jitters:
                res = self._minimize(d2, y, self.thetas[c], jit)
                if res.fun < best[0]:
                    best = (res.fun, res.x, jit)
            if not np.isfinite(best[0]):
                best = self._train_coord_rnd(d2, y)
            _, th, jit = best
            self.thetas[c] = np.asarray(th, float)
            self.jitter_sel[c] = float(jit)

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        if self._X is None or self._X.shape[0] == 0:
            return uF_prev - uG_prev
        qn = q.cpu().numpy()
        d2q = ((self._X - qn[None, :]) ** 2).sum(-1)
        preds = np.empty(self.n)
        for c in range(self.n):
            sx, sy = self.thetas[c]
            jit = self.jitter_sel[c]
            key = (float(sx), float(sy), jit, c)
            if key not in self._mem:
                K = (sy * sy) * np.exp(-0.5 * self._d2 / (sx * sx))
                K = K + np.eye(K.shape[0]) * 10.0 ** jit
                L = np.linalg.cholesky(K)
                self._mem[key] = np.linalg.solve(
                    L.T, np.linalg.solve(L, self._D[:, c]))
            kq = (sy * sy) * np.exp(-0.5 * d2q / (sx * sx))
            preds[c] = kq @ self._mem[key]
        return torch.as_tensor(preds, dtype=q.dtype, device=q.device)
