"""nnGParareal: per-query nearest-neighbour local GPs (the paper's method).

Port of ``nngparareal_tpu/models/nngp.py``. For every prediction point the
m nearest dataset rows (squared euclidean) form a local GP per state
coordinate (log10-scale SE kernel); the hyperparameters minimise the
Cholesky NLL over (coordinate x 9 jitters x ``n_restarts``) tasks, and the
posterior mean of each coordinate's best task is the prediction.

Two searches, as in the JAX package:

* ``optimizer='nm'`` (the default): one batched lockstep Nelder-Mead over
  all tasks (``ops/optim.py``), from random integer starts in [-8, 0)
  drawn per interval by ``sweep_aux``, for at most ``nm_max_iters``
  iterations with scipy's fatol/xatol test; raw inputs, no rescaling. On a
  CUDA card the search runs as CUDA graphs replayed until every simplex
  has frozen (``ops/optim.py:NelderMeadGraphs``), on the CPU eagerly with
  the same early stop; both are bitwise the full fixed-iteration loop.
* ``optimizer='grid'``: the deterministic dense (theta x jitter) grid of
  NLL scores on globally rescaled targets, a walk and halving refinement
  (``grid_walk``, ``grid_refine``, gated by ``fatol``), a jitter re-scan
  and one polish round; or, with ``grid_polish`` > 0, a fixed-iteration
  Nelder-Mead from each jitter's best grid point instead.

Not ported (refused, ROADMAP.md): the ``strategy`` variants,
``selector='loo'``, ``posterior='lu'`` and ``score_dtype``.

Apart from the Nelder-Mead search's convergence checks, every step queues
torch ops on the dataset's device and reads nothing back to the host.
"""

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops import gp as gpops
from nngparareal_torch.ops import gp_lanes as gplanes
from nngparareal_torch.ops.nn_select import nearest_neighbors
from nngparareal_torch.ops.optim import NelderMeadGraphs, nelder_mead_fixed

_UNPORTED = "not ported yet (ROADMAP.md, modules still to port)"
# Nelder-Mead iterations per captured graph: the host reads whether every
# simplex has frozen after each replay
NM_BLOCK = 8


def _nm_objective(pts, sqd, y_tasks, mask, jitter):
    """Lane-major NLL of (B, C, 2) candidate thetas: task b scores its
    target column ``y_tasks[:, b]`` with jitter exponent ``jitter[b]``."""
    B, C, _ = pts.shape
    m = y_tasks.shape[0]
    th_flat = pts.reshape(-1, 2)
    jit_flat = jitter[:, None].expand(B, C).reshape(-1)
    y_flat = y_tasks[:, :, None].expand(m, B, C).reshape(m, 1, B * C)
    return gplanes.nll_lanes(sqd, y_flat, th_flat, jit_flat,
                             mask)[0].reshape(B, C)


class NNGParareal(ModelBase):
    name = "NNGP"

    def __init__(
        self,
        n,
        N,
        nn="adaptive",
        n_restarts=1,
        seed=45,
        fatol=None,
        xatol=None,
        nm_max_iters=200,
        optimizer="nm",
        grid_refine=2,
        grid_walk=4,
        grid_polish=0,
        strategy="nn",
        score_dtype=None,
        selector="nll",
        posterior="chol",
    ):
        super().__init__(n, N)
        if optimizer not in ("nm", "grid"):
            raise ValueError(f"unknown nnGP optimizer {optimizer!r}")
        for key, val, ported in (("strategy", strategy, "nn"),
                                 ("selector", selector, "nll"),
                                 ("posterior", posterior, "chol"),
                                 ("score_dtype", score_dtype, None)):
            if val != ported:
                raise NotImplementedError(
                    f"NNGParareal {key}={val!r} is {_UNPORTED}")
        self.nn = nn
        self.n_restarts = int(n_restarts)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        # kept so checkpoints carry the JAX package's model state (its
        # 'col+rnd' strategy draws from it)
        self.rng2 = np.random.default_rng(self.seed)
        self.fatol = 1e-1 if fatol is None else float(fatol)
        self.xatol = 1e-1 if xatol is None else float(xatol)
        self.nm_max_iters = int(nm_max_iters)
        self.optimizer = str(optimizer)
        self.grid_refine = int(grid_refine)
        self.grid_walk = int(grid_walk)
        self.grid_polish = int(grid_polish)
        self.k = 0
        # the task order (coord, jitter, restart), coord-major
        n_rest = self.n_restarts if self.optimizer == "nm" else 1
        self.per = 9 * n_rest  # tasks per coordinate
        self.B = self.n * self.per
        self._graphs = {}
        # the Nelder-Mead searches of the run: their iterations until every
        # simplex froze, and on a card the graph replays
        self.nm_stats = {"iterations": [], "replays": 0}

    # --- model protocol ---

    def m_for(self, k):
        if isinstance(self.nn, str) and self.nn == "adaptive":
            return max(10, int(k) + 2)
        return int(self.nn)

    def fit(self, ds, k):
        # lazy: the data lives in ds
        self.k = int(k)
        return None

    def reset_rng(self):
        self.rng = np.random.default_rng(self.seed)

    def sweep_aux(self, k, N, cap=None):
        """The Nelder-Mead starts of one sweep, theta0 ~ integers[-8, 0)
        per (interval, task): one (N, B, 2) draw from the model's
        generator, as the JAX package draws it. The grid search draws
        nothing (None)."""
        if self.optimizer == "grid":
            return None
        return self.rng.integers(-8, 0, size=(N, self.B, 2)).astype(float)

    def get_times(self):
        out = super().get_times()
        # per-interval wall time is not attributable without a host sync
        # per interval: estimate it from the aggregate model share of each
        # sweep over that iteration's active interval count
        tot_act = float(self.active_counts[: self.k + 1].sum())
        out.update(
            serial_train_time=self.pred_time,
            avg_serial_train_time=self.pred_time / tot_act if tot_act else 0.0,
        )
        if self.optimizer == "nm":
            out.update(nm_iterations=list(self.nm_stats["iterations"]),
                       nm_graph_replays=self.nm_stats["replays"])
        return out

    def _task_jitters(self, dtype, device):
        """(B,) jitter exponent of each task, coord-major."""
        jit = torch.arange(-20.0, -11.0, dtype=dtype, device=device)
        return jit.repeat_interleave(self.per // 9).repeat(self.n)

    # --- Nelder-Mead ---

    def _nm_search(self, sqd_xx, ym, mask, theta0, graphed=None):
        """Per-task Nelder-Mead: (thetas (B, 2), fvals (B,)). ``graphed``:
        run the captured graphs (default on a CUDA card) or eager launches
        with the same early stop."""
        dev, dt = sqd_xx.device, sqd_xx.dtype
        m = sqd_xx.shape[0]
        y_tasks = ym.repeat_interleave(self.per, dim=1)  # (m, B)
        data = (sqd_xx, y_tasks, mask, self._task_jitters(dt, dev))
        if graphed is None:
            graphed = dev.type == "cuda"
        if not graphed:
            stats = {}
            out = nelder_mead_fixed(
                lambda pts: _nm_objective(pts, *data), theta0,
                iters=self.nm_max_iters, fatol=self.fatol, xatol=self.xatol,
                stats=stats)
            self.nm_stats["iterations"].append(stats["run"])
            return out
        key = (dev, m)
        nmg = self._graphs.get(key)
        if nmg is None:
            nmg = self._graphs[key] = NelderMeadGraphs(
                _nm_objective, data, self.B, 2, self.nm_max_iters,
                self.fatol, self.xatol, block=NM_BLOCK)
        out = nmg.run(theta0, *data)
        self.nm_stats["iterations"].append(nmg.last["live"])
        self.nm_stats["replays"] += nmg.last["replays"]
        return out

    # --- the grid search ---

    def _grid_shared(self, sqd_xx, ym, mask, jitter_shift):
        """Dense (theta x jitter) grid search with factorization sharing.

        Each of the 64x9 (theta, jitter) combos is factorized once and
        scores all n coordinates. Returns per-task (thetas (B, 2), fvals
        (B,)) in coord-major layout.
        """
        n = self.n
        dev, dt = sqd_xx.device, sqd_xx.dtype
        g_vals = torch.arange(-8.0, 0.0, dtype=dt, device=dev)
        gx, gy = torch.meshgrid(g_vals, g_vals, indexing="xy")
        grid0 = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)  # (64, 2)
        jit9 = torch.arange(-20.0, -11.0, dtype=dt, device=dev) + jitter_shift
        combo_th = torch.repeat_interleave(grid0, 9, dim=0)  # (576, 2)
        combo_jit = jit9.repeat(grid0.shape[0])  # (576,)

        fv_all = gplanes.nll_lanes(sqd_xx, ym, combo_th, combo_jit, mask)
        if self.grid_polish > 0:
            return self._grid_polished(sqd_xx, ym, mask, jitter_shift,
                                       fv_all, grid0, jit9)
        best = torch.argmin(fv_all, dim=1)  # (n,)
        th_best = combo_th[best]
        jit_best = combo_jit[best]
        fv_best = torch.gather(fv_all, 1, best[:, None])[:, 0]

        y_rep9 = torch.repeat_interleave(ym, 9, dim=1)[:, None, :]  # (m,1,9n)
        # made on the device: a tensor built from a Python list would be a
        # host-to-device copy inside the sweep
        unit = torch.arange(-1.0, 2.0, dtype=dt, device=dev)

        def theta_round(th_best, jit_best, fv_best, step, gate):
            """3x3 theta neighbourhood, jitter locked; move if the gain
            beats ``gate``."""
            offs = step * unit  # [-step, 0, step]
            ox, oy = torch.meshgrid(offs, offs, indexing="xy")
            neigh = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=1)
            cands = (th_best[:, None, :] + neigh[None]).reshape(-1, 2)
            jit_c = torch.repeat_interleave(jit_best, 9)
            fv_r = gplanes.nll_lanes(sqd_xx, y_rep9, cands, jit_c,
                                     mask)[0].reshape(n, 9)
            b = torch.argmin(fv_r, dim=1)
            th_new = torch.gather(cands.reshape(n, 9, 2), 1,
                                  b[:, None, None].expand(n, 1, 2))[:, 0]
            fv_new = torch.gather(fv_r, 1, b[:, None])[:, 0]
            improve = fv_new < fv_best - gate
            th_best = torch.where(improve[:, None], th_new, th_best)
            fv_best = torch.where(improve, fv_new, fv_best)
            return th_best, fv_best

        def jitter_rescan(th_best, jit_best, fv_best, gate):
            """Re-select the jitter with theta fixed (accepted only past
            ``gate``)."""
            cands = torch.repeat_interleave(th_best, 9, dim=0)
            jit_c = jit9.repeat(n)
            fv_r = gplanes.nll_lanes(sqd_xx, y_rep9, cands, jit_c,
                                     mask)[0].reshape(n, 9)
            b = torch.argmin(fv_r, dim=1)
            jit_new = jit9[b]
            fv_new = torch.gather(fv_r, 1, b[:, None])[:, 0]
            improve = fv_new < fv_best - gate
            jit_best = torch.where(improve, jit_new, jit_best)
            fv_best = torch.where(improve, fv_new, fv_best)
            return jit_best, fv_best

        # walk (integer steps toward the local optimum) then refine
        # (halving steps)
        schedule = [(1.0, self.fatol)] * self.grid_walk
        s = 0.5
        for _ in range(self.grid_refine):
            schedule.append((s, 0.0))
            s *= 0.5
        for step, gate in schedule:
            th_best, fv_best = theta_round(th_best, jit_best, fv_best, step,
                                           gate)
        # final noise-floor re-selection + one polish round
        jit_best, fv_best = jitter_rescan(th_best, jit_best, fv_best,
                                          self.fatol)
        th_best, fv_best = theta_round(th_best, jit_best, fv_best, 0.5, 0.0)
        return self._to_tasks(th_best, jit_best, fv_best, jitter_shift)

    def _grid_polished(self, sqd_xx, ym, mask, jitter_shift, fv_all, grid0,
                       jit9):
        """``grid_polish`` > 0: per (coordinate x jitter), a fixed-iteration
        Nelder-Mead from that jitter's best grid point; the argmin of the
        polished NLLs over the jitters wins."""
        n, nj = self.n, 9
        fv_gj = fv_all.reshape(n, grid0.shape[0], nj)
        b0 = torch.argmin(fv_gj, dim=1)  # (n, 9) best grid point per jitter
        th0 = grid0[b0.reshape(-1)]  # (n*9, 2) coord-major
        data = (sqd_xx, ym.repeat_interleave(nj, dim=1), mask, jit9.repeat(n))
        th_pol, fv_pol = nelder_mead_fixed(
            lambda pts: _nm_objective(pts, *data), th0,
            iters=self.grid_polish, fatol=self.fatol, xatol=self.xatol)
        fv_pol = fv_pol.reshape(n, nj)
        th_pol = th_pol.reshape(n, nj, 2)
        bj = torch.argmin(fv_pol, dim=1)  # (n,)
        th_best = torch.gather(th_pol, 1, bj[:, None, None].expand(n, 1, 2))
        fv_best = torch.gather(fv_pol, 1, bj[:, None])[:, 0]
        return self._to_tasks(th_best[:, 0], jit9[bj], fv_best, jitter_shift)

    def _to_tasks(self, th_best, jit_best, fv_best, jitter_shift):
        """Expand per-coordinate winners to the coord-major task layout:
        the winner sits in the task slot whose jitter matches, +inf
        elsewhere."""
        n = self.n
        jit_tasks = (self._task_jitters(th_best.dtype, th_best.device)
                     .reshape(n, self.per) + jitter_shift)
        fv_tasks = torch.where(jit_tasks == jit_best[:, None],
                               fv_best[:, None], torch.inf)
        th_tasks = th_best[:, None, :].expand(n, self.per, 2)
        return th_tasks.reshape(-1, 2), fv_tasks.reshape(-1)

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        """The predicted defect (n,) at ``q`` for interval i; ``aux_i``
        holds the interval's Nelder-Mead starts (B, 2)."""
        m = min(self.m_for(self.k), ds.capacity)
        idx, sqd_sel = nearest_neighbors(q, ds.X, ds.valid, m)
        sel_mask = torch.isfinite(sqd_sel).to(ds.valid.dtype)
        xm = ds.X[idx]  # (m, n)
        ym = ds.D[idx]  # (m, n)
        mask = sel_mask * ds.valid[idx]

        sqd_xx = gpops.pairwise_sq_dists(xm, xm)
        sqd_xq = gpops.sq_dists_to(q, xm)

        if self.optimizer == "grid":
            # targets divided by ONE global rms scale; the jitter exponents
            # shift by -2 log10(scale) so the ABSOLUTE jitter grid is
            # unchanged
            count = torch.clamp(torch.sum(mask), min=1.0)
            ymm = ym * mask[:, None]
            power = torch.sum(ymm * ymm, dim=0) / count  # (n,)
            glob = torch.max(power)
            y_scale = torch.where(glob > 0, torch.sqrt(glob), 1.0)
            jitter_shift = -2.0 * torch.log10(y_scale)
            ym_fit = ym / y_scale
            thetas, fvals = self._grid_shared(sqd_xx, ym_fit, mask,
                                              jitter_shift)
        else:
            # Nelder-Mead on the raw inputs
            if aux_i is None:
                raise ValueError("optimizer='nm' needs the interval's "
                                 "starts (sweep_aux)")
            y_scale = 1.0
            ym_fit = ym
            thetas, fvals = self._nm_search(sqd_xx, ym, mask, aux_i)

        # per-coordinate NLL argmin over the task slots
        fv = fvals.reshape(self.n, self.per)
        th = thetas.reshape(self.n, self.per, 2)
        jv = self._task_jitters(fv.dtype, fv.device).reshape(self.n,
                                                              self.per)
        best = torch.argmin(fv, dim=1)
        th_best = torch.gather(th, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
        # the posterior deliberately fits with the UNSHIFTED jitter
        # exponent on the scaled targets (nngparareal_tpu/models/nngp.py
        # explains the choice)
        jv_best = torch.gather(jv, 1, best[:, None])[:, 0]

        # NaN where the factorisation fails: the driver then falls back
        # to the bare correction
        preds = gplanes.posterior_mean_lanes(
            sqd_xx, sqd_xq, ym_fit, th_best, jv_best, mask
        )
        return preds * y_scale
