"""nnGParareal with time augmentation: the research variant "NNGPtime" of
the reference's nnGPara_with_time.py.

Port of ``nngparareal_tpu/models/nngp_time.py``. Every dataset row also
carries its slice index and its iteration index, both mapped to [-1, 1];
the GP kernel is an SE kernel on the state times SE factors on the two
indices, with four log10 hyperparameters (``k_se_time``). The padded
dataset's row kk*N + ii holds slice ii of iteration kk, so the indices
are arithmetic on the row number.

The neighbours are refined by kernel similarity: ``reps`` chains per
coordinate start from random rows; each of ``nn_iters`` rounds runs one
batched Nelder-Mead over every (chain x task) simplex in 4-d (9 jitters x
``n_restarts`` random starts and one start at ones, per chain), keeps
each chain's best, and re-selects each chain's m rows most similar to the
query under that chain's hyperparameters. The best chain of each
coordinate predicts.

On a CUDA card each round's search runs as CUDA graphs
(``ops/optim.py:NelderMeadGraphs``, one set per (m, simplexes)), replayed
until every simplex has frozen, bitwise the eager search; a failed
capture raises. Ties in the random pick and in the similarity re-pick go
to the lower row, as ``lax.top_k`` orders them (a stable sort).
"""

import math

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.models.nngp import NM_BLOCK
from nngparareal_torch.ops import gp as gpops
from nngparareal_torch.ops.gp_lanes import pow10
from nngparareal_torch.ops.optim import NelderMeadGraphs, nelder_mead_fixed


def _flush(x):
    """x with its subnormal values set to 0, as XLA's CPU code flushes
    them: the similarity re-pick orders kernel values that underflow, and
    among rows whose similarity is 0 the lower row wins."""
    return torch.where(torch.abs(x) < torch.finfo(x.dtype).tiny, 0.0, x)


# below this argument exp is subnormal or 0 in f64 (a margin of 1e-9 above
# log of the smallest normal number keeps exp of the floor itself normal)
_EXP_FLOOR = math.log(torch.finfo(torch.float64).tiny) + 1e-9


def _exp_ftz(x):
    """exp(x), 0 where it would be subnormal. exp never sees an argument
    below the floor: on the CPU a subnormal or underflowing result costs a
    slow path, 30-200x the time of the whole exp."""
    return torch.where(x < _EXP_FLOOR, 0.0,
                       torch.exp(torch.clamp(x, min=_EXP_FLOOR)))


def k_se_time(sqd_stack, theta):
    """Product kernel on stacked squared distances: space, slice index,
    iteration index. theta (..., 4) = (sigma_x, sigma_y, sigma_int,
    sigma_iters), log10 scale; sqd_stack (*batch, 3, *S) with as many
    batch axes as theta has (broadcasting against them). Returns
    (*batch, *S); an exp or a product below the smallest normal number
    is 0, as in the JAX package on the CPU (a card keeps subnormals)."""
    n_s = sqd_stack.dim() - theta.dim()
    shape = theta.shape[:-1] + (1,) * n_s
    sx, sy, s_int, s_it = (theta[..., j].reshape(shape) for j in range(4))
    s = [sqd_stack.select(-n_s - 1, j) for j in range(3)]
    expo = pow10(-sx) * s[0] + pow10(-s_int) * s[1] + pow10(-s_it) * s[2]
    return _flush(pow10(sy) * _exp_ftz(-0.5 * expo))


def _time_objective(pts, y_c, s_c, mask_c, jit_t):
    """NLL of (B, C, 4) candidates, B = chains x tasks per chain: the
    tasks of chain c score its targets ``y_c[c]`` (m,) on its rows'
    distance stack ``s_c[c]`` (3, m, m) and mask ``mask_c[c]``; task b
    has the jitter exponent ``jit_t[b]``. Returns (B, C)."""
    B, C, _ = pts.shape
    chains = y_c.shape[0]
    th = pts.reshape(chains, B // chains, C, 4)
    K = k_se_time(s_c[:, None, None], th)  # (chains, tpc, C, m, m)
    nll = gpops.gp_nll(K, y_c[:, None, None, :],
                       jit_t.reshape(chains, B // chains, 1),
                       mask_c[:, None, None, :])
    return nll.reshape(B, C)


def _first(x, m, **sort_kw):
    """Indices of the first m of each row of x under a stable sort: the
    lower index first among equal values, as ``lax.top_k`` orders them."""
    return torch.sort(x, dim=-1, stable=True, **sort_kw)[1][..., :m]


class NNGPTime(ModelBase):
    name = "NNGPtime"

    def __init__(self, n, N, nn="adaptive", n_restarts=1, seed=45,
                 fatol=None, xatol=None, nn_iters=5, reps=10,
                 nm_max_iters=150):
        super().__init__(n, N)
        self.nn = nn
        self.n_restarts = int(n_restarts)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.fatol = 1e-1 if fatol is None else float(fatol)
        self.xatol = 1e-1 if xatol is None else float(xatol)
        self.nn_iters = int(nn_iters)
        self.reps = int(reps)
        self.nm_max_iters = int(nm_max_iters)
        self.k = 0
        # per (coordinate, rep) chain: 9 jitters x (n_restarts random
        # starts + 1 start at ones)
        self.tasks_per_chain = 9 * (self.n_restarts + 1)
        self.chains = self.n * self.reps
        self._graphs = {}
        self._consts = {}
        # the searches of the run: each round's iterations until every
        # simplex froze, and on a card the graph replays
        self.nm_stats = {"iterations": [], "replays": 0}

    def m_for(self, k):
        if isinstance(self.nn, str) and self.nn == "adaptive":
            return max(10, int(k) + 2)
        return int(self.nn)

    def fit(self, ds, k):
        self.k = int(k)
        return None

    def reset_rng(self):
        self.rng = np.random.default_rng(self.seed)

    def sweep_aux(self, k, N, cap=None):
        """One sweep's draws from ``rng``, in the JAX package's order:
        theta0, integers in [-8, 0) of shape (N, chains x 9 x n_restarts,
        4); rand, uniform (N, chains, cap) scores of the round-0 pick; and
        kval, the iteration (N,)."""
        if cap is None:
            raise ValueError("NNGPTime needs the dataset capacity")
        n_rand = self.chains * 9 * self.n_restarts
        theta0 = self.rng.integers(-8, 0, size=(N, n_rand, 4)).astype(float)
        rand = self.rng.random((N, self.chains, cap))
        return {"theta0": theta0, "rand": rand,
                "kval": np.full((N,), float(k))}

    def get_times(self):
        out = super().get_times()
        out.update(nm_iterations=list(self.nm_stats["iterations"]),
                   nm_graph_replays=self.nm_stats["replays"])
        return out

    # ------------------------------------------------------------------

    def _index_coords(self, cap, device):
        """The slice and iteration index of every row, each in [-1, 1]
        (the iteration index over [0, k]; all 1 at k = 0), and the task
        jitters, made on the host in the JAX package's arithmetic and
        copied to ``device`` once per (capacity, k)."""
        key = (cap, self.k, device)
        c = self._consts.get(key)
        if c is None:
            self._consts.clear()
            N, k = self.N, self.k
            row = np.arange(cap)
            ii_n = 2.0 * (row % N) / (N - 1) - 1.0
            kk_n = (np.ones(cap) if k < 0.5
                    else 2.0 * (row // N) / max(float(k), 1.0) - 1.0)
            jit = np.tile(np.repeat(np.arange(-20.0, -11.0),
                                    self.n_restarts + 1), self.chains)
            c = self._consts[key] = tuple(
                torch.as_tensor(a, device=device) for a in (ii_n, kk_n, jit))
        return c

    def _search(self, x0, data, graphed=None):
        """One round's batched Nelder-Mead: (thetas (B, 4), fvals (B,)).
        ``graphed``: the captured graphs (default on a CUDA card) or eager
        launches with the same early stop."""
        dev = x0.device
        if graphed is None:
            graphed = dev.type == "cuda"
        if not graphed:
            stats = {}
            out = nelder_mead_fixed(
                lambda pts: _time_objective(pts, *data), x0,
                iters=self.nm_max_iters, fatol=self.fatol, xatol=self.xatol,
                stats=stats)
            self.nm_stats["iterations"].append(stats["run"])
            return out
        key = (dev, data[0].shape[1])
        nmg = self._graphs.get(key)
        if nmg is None:
            nmg = self._graphs[key] = NelderMeadGraphs(
                _time_objective, data, x0.shape[0], 4, self.nm_max_iters,
                self.fatol, self.xatol, block=NM_BLOCK)
        out = nmg.run(x0, *data)
        self.nm_stats["iterations"].append(nmg.last["live"])
        self.nm_stats["replays"] += nmg.last["replays"]
        return out

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        """The predicted defect (n,) at ``q`` for interval i; ``aux_i`` is
        the interval's row of the ``sweep_aux`` draws."""
        n, N, R = self.n, self.N, self.reps
        m = min(self.m_for(self.k), ds.capacity)
        chains, tpc = self.chains, self.tasks_per_chain
        ii_n, kk_n, task_jit = self._index_coords(ds.capacity, ds.X.device)
        valid = ds.valid
        q_int = 2.0 * i / (N - 1) - 1.0
        q_iter = 1.0  # the query's iteration is the newest

        d_int = ii_n - q_int
        d_it = kk_n - q_iter
        stack_all = torch.stack([gpops.sq_dists_to(q, ds.X), d_int * d_int,
                                 d_it * d_it])  # (3, cap)

        def gather(idx):
            """The rows idx (b, m): targets, mask, distance stack
            (b, 3, m, m) and query distance stack (b, 3, m)."""
            xm = ds.X[idx]
            iim, kkm = ii_n[idx], kk_n[idx]
            dx = xm[:, :, None, :] - xm[:, None, :, :]
            di = iim[:, :, None] - iim[:, None, :]
            dk = kkm[:, :, None] - kkm[:, None, :]
            s = torch.stack([torch.sum(dx * dx, dim=-1), di * di, dk * dk],
                            dim=1)
            dq = xm - q
            qi, qk = iim - q_int, kkm - q_iter
            qs = torch.stack([torch.sum(dq * dq, dim=-1), qi * qi, qk * qk],
                             dim=1)
            return ds.D[idx], valid[idx], s, qs

        # round 0: random rows (invalid rows never win)
        idx_cur = _first(torch.where(valid > 0, aux_i["rand"], torch.inf), m)
        # Nelder-Mead starts: n_restarts random and one at ones per
        # (chain, jitter)
        th_rand = aux_i["theta0"].reshape(chains, 9, self.n_restarts, 4)
        th_ones = torch.ones((chains, 9, 1, 4), dtype=th_rand.dtype,
                             device=th_rand.device)
        x0 = torch.cat([th_rand, th_ones], dim=2).reshape(-1, 4)
        chain_ids = torch.arange(chains, device=q.device)
        coord_of_chain = chain_ids // R

        best_fv = torch.full((chains,), torch.inf, dtype=q.dtype,
                             device=q.device)
        best_th = torch.ones((chains, 4), dtype=q.dtype, device=q.device)
        best_jit = torch.full((chains,), -16.0, dtype=q.dtype,
                              device=q.device)
        best_idx = idx_cur
        jv_c = task_jit.reshape(chains, tpc)
        for rnd in range(self.nn_iters):
            ym_c, mask_c, s_c, _ = gather(idx_cur)
            y_c = ym_c[chain_ids, :, coord_of_chain]  # (chains, m)
            th, fv = self._search(x0, (y_c, s_c, mask_c, task_jit))
            fv_c = fv.reshape(chains, tpc)
            th_c = th.reshape(chains, tpc, 4)
            b = torch.argmin(fv_c, dim=1)
            fv_b = fv_c[chain_ids, b]
            th_b = th_c[chain_ids, b]
            improve = fv_b < best_fv
            best_fv = torch.where(improve, fv_b, best_fv)
            best_th = torch.where(improve[:, None], th_b, best_th)
            best_jit = torch.where(improve, jv_c[chain_ids, b], best_jit)
            best_idx = torch.where(improve[:, None], idx_cur, best_idx)
            if rnd + 1 < self.nn_iters:
                # re-select by kernel similarity under this round's theta
                sims = k_se_time(stack_all[None], th_b)  # (chains, cap)
                sims = torch.where(valid > 0, sims, -torch.inf)
                idx_cur = _first(sims, m, descending=True)

        # per coordinate: the best of its chains
        rbest = torch.argmin(best_fv.reshape(n, R), dim=1)
        sel = torch.arange(n, device=q.device) * R + rbest
        ym_s, mask_s, s_s, q_s = gather(best_idx[sel])
        coords = torch.arange(n, device=q.device)
        return gpops.predict_mean_from_sqd(
            s_s, q_s, ym_s[coords, :, coords], best_th[sel], best_jit[sel],
            mask_s, k_se_time)
