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

The research options of the JAX package:

* ``strategy``: the neighbour-selection variants of the reference's
  nnGPara_with_time.py (``col_only``, ``col+rnd``, ``row_col``, ``row``,
  ``col_full``) in place of the nearest neighbours (``nn``). The padded
  dataset's row kk*N + ii holds slice ii of iteration kk, so each variant
  is a penalty over the row index and the m smallest penalties win, the
  lower row first among equal ones; ``col+rnd`` scores the rows off the
  query's column with uniform draws from ``rng2``, one (N, capacity) draw
  per sweep.
* ``selector='loo'`` (grid search): among the ``loo_top`` best NLL
  candidates of each coordinate within ``loo_window`` nats of the best,
  the one with the smallest leave-one-out residual wins the grid round.
* ``posterior='lu'``: the posterior mean from a partial-pivoted LU solve
  (the library's batched ``solve_ex``), taken where it is finite and
  within 10x the neighbours' largest defect, else the Cholesky one.
* ``score_dtype`` (e.g. ``torch.float32``): every scoring call of both
  searches in that precision; the posterior stays f64.

Apart from the Nelder-Mead search's convergence checks, every step queues
torch ops on the dataset's device and reads nothing back to the host.
"""

import functools

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops import gp as gpops
from nngparareal_torch.ops import gp_lanes as gplanes
from nngparareal_torch.ops.nn_select import nearest_neighbors
from nngparareal_torch.ops.optim import NelderMeadGraphs, nelder_mead_fixed

STRATEGIES = ("nn", "col_only", "col+rnd", "row_col", "row", "col_full")
# Nelder-Mead iterations per captured graph: the host reads whether every
# simplex has frozen after each replay
NM_BLOCK = 8


def _nm_objective(pts, sqd, y_tasks, mask, jitter, dtype=None):
    """Lane-major NLL of (B, C, 2) candidate thetas: task b scores its
    target column ``y_tasks[:, b]`` with jitter exponent ``jitter[b]``,
    in ``dtype`` (None: f64)."""
    B, C, _ = pts.shape
    m = y_tasks.shape[0]
    th_flat = pts.reshape(-1, 2)
    jit_flat = jitter[:, None].expand(B, C).reshape(-1)
    y_flat = y_tasks[:, :, None].expand(m, B, C).reshape(m, 1, B * C)
    return gplanes.nll_lanes(sqd, y_flat, th_flat, jit_flat, mask,
                             dtype=dtype)[0].reshape(B, C)


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
        loo_top=12,
        loo_window=3.0,
        posterior="chol",
        calc_detail_avg=False,
    ):
        super().__init__(n, N)
        for key, val, known in (("optimizer", optimizer, ("nm", "grid")),
                                ("strategy", strategy, STRATEGIES),
                                ("selector", selector, ("nll", "loo")),
                                ("posterior", posterior, ("chol", "lu"))):
            if val not in known:
                raise ValueError(f"unknown nnGP {key} {val!r}; known: "
                                 f"{list(known)}")
        if score_dtype is not None and not (
                isinstance(score_dtype, torch.dtype)
                and score_dtype.is_floating_point):
            raise ValueError(f"score_dtype={score_dtype!r}: a torch floating "
                             "dtype or None")
        self.strategy = str(strategy)
        if self.strategy != "nn":
            self.name = "NNGP" + self.strategy
        self.selector = str(selector)
        self.loo_top = int(loo_top)
        self.loo_window = float(loo_window)
        self.posterior = str(posterior)
        self.score_dtype = score_dtype
        self.nn = nn
        self.n_restarts = int(n_restarts)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        # the 'col+rnd' strategy's draws
        self.rng2 = np.random.default_rng(self.seed)
        self.fatol = 1e-1 if fatol is None else float(fatol)
        self.xatol = 1e-1 if xatol is None else float(xatol)
        self.nm_max_iters = int(nm_max_iters)
        self.optimizer = str(optimizer)
        self.grid_refine = int(grid_refine)
        self.grid_walk = int(grid_walk)
        self.grid_polish = int(grid_polish)
        self.k = 0
        # per-(iteration, interval) prediction walls: with the flag set the
        # driver's sweep waits for the card after each interval and hands
        # its wall to record_interval_time
        self.calc_detail_avg = bool(calc_detail_avg)
        self.detail_avg = np.zeros((N, N)) if self.calc_detail_avg else None
        self.tot_train_t = 0.0
        self.train_count = 0
        # the task order (coord, jitter, restart), coord-major
        n_rest = self.n_restarts if self.optimizer == "nm" else 1
        self.per = 9 * n_rest  # tasks per coordinate
        self.B = self.n * self.per
        self._graphs = {}
        # the Nelder-Mead searches of the run: their iterations until every
        # simplex froze, and on a card the graph replays
        self.nm_stats = {"iterations": [], "replays": 0}
        # posterior='lu': how many (interval, coordinate) predictions the
        # gate took from the LU solve (counted on the device) and in all
        self._lu_taken = None
        self._lu_total = 0

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
        """The draws of one sweep, as the JAX package makes them: the
        Nelder-Mead starts theta0 ~ integers[-8, 0) per (interval, task),
        one (N, B, 2) draw from ``rng`` (the grid search draws none); with
        ``col+rnd``, then the (N, cap) row scores from ``rng2``. Returns
        the starts alone as an array, a dict {"theta0", "rand"} with
        ``col+rnd``, or None when nothing is drawn."""
        theta0 = None
        if self.optimizer != "grid":
            theta0 = self.rng.integers(-8, 0, size=(N, self.B, 2)).astype(
                float)
        if self.strategy != "col+rnd":
            return theta0
        if cap is None:
            raise ValueError("col+rnd needs the dataset capacity")
        aux = {"rand": self.rng2.random((N, cap))}
        if theta0 is not None:
            aux["theta0"] = theta0
        return aux

    def record_interval_time(self, i, seconds):
        """One interval's measured wall (the sweep calls it with
        ``calc_detail_avg``)."""
        self.tot_train_t += seconds
        self.train_count += 1
        if self.calc_detail_avg and self.k < self.N and i < self.N:
            self.detail_avg[self.k, i] = seconds

    def get_times(self):
        out = super().get_times()
        if self.train_count:
            # measured interval by interval (calc_detail_avg)
            out.update(
                serial_train_time=self.tot_train_t,
                avg_serial_train_time=self.tot_train_t / self.train_count,
                calc_detail_avg=self.detail_avg[: self.k + 1],
            )
        else:
            # per-interval wall time is not attributable without a wait
            # per interval: estimate it from the aggregate model share of
            # each sweep over that iteration's active interval count
            tot_act = float(self.active_counts[: self.k + 1].sum())
            out.update(
                serial_train_time=self.pred_time,
                avg_serial_train_time=(self.pred_time / tot_act if tot_act
                                       else 0.0),
                calc_detail_avg=None,
                timing_detail_note=(
                    "serial_train_time/avg_serial_train_time are estimates "
                    "(aggregate sweep model time / active-interval counts); "
                    "per-(k,i) detail requires calc_detail_avg=True"),
            )
        if self.optimizer == "nm":
            out.update(nm_iterations=list(self.nm_stats["iterations"]),
                       nm_graph_replays=self.nm_stats["replays"])
        if self.posterior == "lu":
            taken = 0 if self._lu_taken is None else int(self._lu_taken)
            out.update(lu_taken=taken, chol_taken=self._lu_total - taken)
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
        objective = functools.partial(_nm_objective, dtype=self.score_dtype)
        if not graphed:
            stats = {}
            out = nelder_mead_fixed(
                lambda pts: objective(pts, *data), theta0,
                iters=self.nm_max_iters, fatol=self.fatol, xatol=self.xatol,
                stats=stats)
            self.nm_stats["iterations"].append(stats["run"])
            return out
        key = (dev, m)
        nmg = self._graphs.get(key)
        if nmg is None:
            nmg = self._graphs[key] = NelderMeadGraphs(
                objective, data, self.B, 2, self.nm_max_iters,
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

        dtype = self.score_dtype
        fv_all = gplanes.nll_lanes(sqd_xx, ym, combo_th, combo_jit, mask,
                                   dtype=dtype)
        if self.grid_polish > 0:
            return self._grid_polished(sqd_xx, ym, mask, jitter_shift,
                                       fv_all, grid0, jit9)
        if self.selector == "loo":
            th_best, jit_best, fv_best = self._loo_pick(
                sqd_xx, ym, mask, fv_all, combo_th, combo_jit)
        else:
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
            fv_r = gplanes.nll_lanes(sqd_xx, y_rep9, cands, jit_c, mask,
                                     dtype=dtype)[0].reshape(n, 9)
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
            fv_r = gplanes.nll_lanes(sqd_xx, y_rep9, cands, jit_c, mask,
                                     dtype=dtype)[0].reshape(n, 9)
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
            lambda pts: _nm_objective(pts, *data, dtype=self.score_dtype),
            th0,
            iters=self.grid_polish, fatol=self.fatol, xatol=self.xatol)
        fv_pol = fv_pol.reshape(n, nj)
        th_pol = th_pol.reshape(n, nj, 2)
        bj = torch.argmin(fv_pol, dim=1)  # (n,)
        th_best = torch.gather(th_pol, 1, bj[:, None, None].expand(n, 1, 2))
        fv_best = torch.gather(fv_pol, 1, bj[:, None])[:, 0]
        return self._to_tasks(th_best[:, 0], jit9[bj], fv_best, jitter_shift)

    def _loo_pick(self, sqd_xx, ym, mask, fv_all, combo_th, combo_jit):
        """selector='loo': per coordinate, the ``loo_top`` best grid
        candidates (the lower index first among equal NLLs), those within
        ``loo_window`` nats of the best, the smallest leave-one-out score
        wins. Returns (thetas (n, 2), jitters (n,), NLLs (n,))."""
        n = self.n
        S = min(self.loo_top, fv_all.shape[1])
        fv_sorted, order = torch.sort(fv_all, dim=1, stable=True)
        fv_cand, topidx = fv_sorted[:, :S], order[:, :S]  # (n, S)
        th_cand = combo_th[topidx]  # (n, S, 2)
        jit_cand = combo_jit[topidx]  # (n, S)
        y_rep = torch.repeat_interleave(ym, S, dim=1)  # (m, n*S)
        loo = gplanes.loo_lanes(
            sqd_xx, y_rep[:, None, :], th_cand.reshape(-1, 2),
            jit_cand.reshape(-1), mask, dtype=self.score_dtype,
        )[0].reshape(n, S)
        gate_ok = fv_cand <= fv_cand[:, :1] + self.loo_window
        bsel = torch.argmin(torch.where(gate_ok, loo, torch.inf), dim=1)
        th_best = torch.gather(th_cand, 1,
                               bsel[:, None, None].expand(n, 1, 2))[:, 0]
        jit_best = torch.gather(jit_cand, 1, bsel[:, None])[:, 0]
        fv_best = torch.gather(fv_cand, 1, bsel[:, None])[:, 0]
        return th_best, jit_best, fv_best

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

    def _select_neighbors(self, ds, q, m, i, aux_i):
        """The m neighbour rows of the query under the strategy, and their
        selection mask (0 for a row that only fills up the m)."""
        if self.strategy == "nn":
            idx, sqd_sel = nearest_neighbors(q, ds.X, ds.valid, m)
            return idx, torch.isfinite(sqd_sel).to(ds.valid.dtype)
        N, k, dev = self.N, self.k, ds.X.device
        row = torch.arange(ds.capacity, device=dev)
        kk = row // N
        ii = row % N
        colrank = torch.where(ii > i, 2 * (ii - i) - 1, 2 * (i - ii))
        if self.strategy == "col_only":
            pen = torch.where(ii == i, (k - kk).double(), torch.inf)
        elif self.strategy == "col+rnd":
            on_col = min(m, k + 1)
            in_col = (ii == i) & (kk >= k + 1 - on_col)
            pen = torch.where(in_col, -1.0 - kk.double(), aux_i["rand"])
        elif self.strategy == "row_col":
            dist = torch.abs(kk - k) + torch.abs(ii - i)
            # ties broken in the reference's flat (interval-major) order
            pen = (dist * N * (k + 3) + ii * (k + 2) + kk).double()
        elif self.strategy == "row":
            pen = ((k - kk) * (2 * N + 2) + colrank).double()
        else:  # col_full
            pen = (colrank * (k + 2) + (k - kk)).double()
        pen = torch.where(ds.valid > 0, pen, torch.inf)
        pen_sorted, order = torch.sort(pen, stable=True)
        return order[:m], torch.isfinite(pen_sorted[:m]).to(ds.valid.dtype)

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        """The predicted defect (n,) at ``q`` for interval i; ``aux_i``
        holds the interval's Nelder-Mead starts (B, 2), or its row of the
        ``sweep_aux`` dict with ``col+rnd``."""
        m = min(self.m_for(self.k), ds.capacity)
        idx, sel_mask = self._select_neighbors(ds, q, m, i, aux_i)
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
            theta0 = aux_i.get("theta0") if isinstance(aux_i, dict) else aux_i
            if theta0 is None:
                raise ValueError("optimizer='nm' needs the interval's "
                                 "starts (sweep_aux)")
            y_scale = 1.0
            ym_fit = ym
            thetas, fvals = self._nm_search(sqd_xx, ym, mask, theta0)

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
        if self.posterior == "lu":
            # the LU solve keeps the boundary interpolants the Cholesky
            # loses; a magnitude gate against the neighbours' defects
            # rejects a garbage solve in favour of the Cholesky posterior
            p_lu = gplanes.posterior_mean_lu(
                sqd_xx, sqd_xq, ym_fit, th_best, jv_best, mask
            )
            y_mag = torch.amax(torch.abs(ym_fit) * mask[:, None], dim=0)
            sane = torch.isfinite(p_lu) & (torch.abs(p_lu)
                                           <= 10.0 * y_mag + 1e-30)
            preds = torch.where(sane, p_lu, preds)
            taken = torch.sum(sane)
            self._lu_taken = (taken if self._lu_taken is None
                              else self._lu_taken + taken)
            self._lu_total += self.n
        return preds * y_scale
