"""nnGParareal with scipy's Nelder-Mead, one task at a time: the host
oracle of the nnGP.

Port of ``nngparareal_tpu/models/nngp_scipy.py`` (numpy and scipy, so
nearly verbatim), itself the reference's NNGP_p: for each prediction
point the m nearest dataset rows, then for every (coordinate x jitter x
restart) task one scipy Nelder-Mead NLL minimisation from a random
integer start in [-8, 0)^2, all starts drawn from one sequential stream,
and the prediction of each coordinate's best candidate, solved with
``np.linalg.solve``.

The neighbours are the first m of a *stable* argsort of the distances, as
in the JAX package (the reference's default introsort may order exactly
duplicated rows otherwise). ``record=True`` keeps each prediction's picks
in ``picks[(k, i)]``: (NLL, theta, jitter) per coordinate. ``fit`` reads
the dataset back to the host once per iteration; ``predict_fn`` returns a
tensor on the query's device.
"""

import numpy as np
import torch
from scipy.optimize import minimize

from nngparareal_torch.models.base import ModelBase


def _nll_np(d2, y, theta, jitter):
    """The local GP's NLL; a failed Cholesky (or a NaN) is +inf."""
    m = y.shape[0]
    K = 10.0 ** theta[1] * np.exp(-0.5 * 10.0 ** (-theta[0]) * d2)
    K = K + np.eye(m) * 10.0 ** jitter
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


class NNGPScipy(ModelBase):
    name = "NNGP_scipy"

    def __init__(self, n, N, nn="adaptive", n_restarts=1, seed=45,
                 fatol=None, xatol=None, record=False):
        super().__init__(n, N)
        self.nn = nn
        self.n_restarts = int(n_restarts)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.fatol = 1e-1 if fatol is None else float(fatol)
        self.xatol = 1e-1 if xatol is None else float(xatol)
        self.k = 0
        self._X = self._D = self._valid = None
        self.record = bool(record)
        self.picks = {}

    def m_for(self, k):
        if isinstance(self.nn, str) and self.nn == "adaptive":
            return max(10, int(k) + 2)
        return int(self.nn)

    def fit(self, ds, k):
        self.k = int(k)
        self._X = ds.X.cpu().numpy()
        self._D = ds.D.cpu().numpy()
        self._valid = ds.valid.cpu().numpy() > 0

    def reset_rng(self):
        self.rng = np.random.default_rng(self.seed)

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        nvalid = 0 if self._valid is None else int(self._valid.sum())
        if nvalid == 0:  # an empty dataset: the bare correction
            return uF_prev - uG_prev
        qn = q.cpu().numpy()
        bare = (uF_prev - uG_prev).cpu().numpy()

        m = min(self.m_for(self.k), nvalid)
        d2_all = ((self._X - qn[None, :]) ** 2).sum(axis=1)
        d2_all[~self._valid] = np.inf
        idx = np.argsort(d2_all, kind="stable")[:m]
        xm = self._X[idx]
        ym = self._D[idx]

        d2 = ((xm[:, None, :] - xm[None, :, :]) ** 2).sum(-1)
        d2q = ((xm - qn[None, :]) ** 2).sum(-1)

        jitters = np.arange(-20.0, -11.0)
        # the task order and the stream of starts of the reference:
        # product(coords, jitters, restarts), one integer start each
        tasks = [(c, jit) for c in range(self.n) for jit in jitters
                 for _ in range(self.n_restarts)]
        starts = [self.rng.integers(-8, 0, 2) for _ in tasks]

        preds = np.empty(self.n)
        best = [(np.inf, None, None) for _ in range(self.n)]
        for (c, jit), th0 in zip(tasks, starts):
            y = ym[:, c]
            res = minimize(
                lambda th: _nll_np(d2, y, th, jit),
                th0.astype(float),
                method="Nelder-Mead",
                options={"fatol": self.fatol, "xatol": self.xatol},
            )
            if res.fun < best[c][0]:
                best[c] = (res.fun, res.x, jit)
        if self.record:
            self.picks[(self.k, int(i))] = [
                (float(b[0]), None if b[1] is None else np.array(b[1]),
                 b[2]) for b in best
            ]
        for c in range(self.n):
            fv, th, jit = best[c]
            if th is None or not np.isfinite(fv):
                # every task failed (an all-inf NLL): the bare correction
                preds[c] = bare[c]
                continue
            K = 10.0 ** th[1] * np.exp(-0.5 * 10.0 ** (-th[0]) * d2)
            K = K + np.eye(m) * 10.0 ** jit
            kq = 10.0 ** th[1] * np.exp(-0.5 * 10.0 ** (-th[0]) * d2q)
            preds[c] = kq @ np.linalg.solve(K, ym[:, c])
        return torch.as_tensor(preds, dtype=q.dtype, device=q.device)
