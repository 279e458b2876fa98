"""GParareal: one full-dataset GP per state coordinate.

Port of ``nngparareal_tpu/models/gp.py``. Each parareal iteration fits n
single-output GPs (linear-scale SE kernel) on the whole accumulated
dataset, padded to a power-of-two bucket of rows. The hyperparameters of
each coordinate minimise the Cholesky NLL over a 9-point jitter grid
10^{-20..-12}: n x 9 tasks, coordinate-major. Two searches, as in the JAX
package:

* ``optimizer='nm'`` (the default): one batched lockstep Nelder-Mead over
  all tasks (``ops/optim.py``), warm-started from the previous optimum,
  for at most ``nm_max_iters`` iterations. On a CUDA card it runs as CUDA
  graphs replayed until every simplex has frozen
  (``ops/optim.py:NelderMeadGraphs``, one instance per bucket and task
  count), on the CPU eagerly with the same early stop; both are bitwise
  the full fixed-iteration loop. A capture that fails raises.
* ``optimizer='grid'``: a 13x13 log10 grid over the random-restart support
  10^U(-4, 1), then refine grids widened 1x, 4x and 16x around each task's
  winner, scored in batches bounded by a memory budget (the result does
  not depend on the batch sizes).

A coordinate whose best NLL is +inf gets random restarts drawn from the
model's numpy generator (``_rescue``, in the JAX package's order, on the
run's device). The winning (theta, jitter) of each coordinate is fit in
f64 once per iteration (alpha), and its solve is validated by its residual
(``_validate_alphas``): a failed one walks the grid's runner-up candidates,
then raises its jitter. A prediction is a kernel row against every
dataset row and a dot with alpha.

``score_dtype=torch.float32`` scores the candidates in f32 (the posterior
stays f64), with the JAX package's relative jitter floor and, above 48
rows, the IEEE-f32 blocked factorisation of ``ops/chol_blocked.py``.

``score_lanes=True`` scores the grid search's candidates through the
blocked lane-major NLL (``ops/gp_lanes.py:nll_lanes_big``, candidates in
the last axis) in place of one batched Cholesky per candidate; as in the
JAX package, without the f32 relative floor.

``mesh`` (a ``parallel.mesh.Mesh`` of more than one device) shards the
grid search's (coordinate x jitter) task pool: each call carries
``grid_task_chunk`` tasks per device, padded with dummy tasks to a whole
number of calls, each device scores its block against its own copy of the
fit's dataset, and the blocks gather in task order. The Nelder-Mead
search and the rescue are not sharded, as in the JAX package.
"""

import functools

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops import gp as gpops
from nngparareal_torch.ops import gp_lanes
from nngparareal_torch.ops.optim import NelderMeadGraphs, nelder_mead_fixed
# Nelder-Mead iterations per captured graph: the host reads whether every
# simplex has frozen after each replay
NM_BLOCK = 8
# elements of the Grams one batched NLL call keeps alive (2 GB in f64)
GRAM_BUDGET = 1 << 28
# elements of one (M, M, lanes) array of the blocked lane-major NLL (64 MB
# in f64; the factor keeps a few such arrays alive)
LANES_BUDGET = 1 << 23


def task_nll(pts, sqd, Y, mask, jitter, rel_floor=None, score_dtype=None):
    """NLL of (B, C, 2) candidate thetas: task b scores its target row
    ``Y[b]`` (M,) at jitter exponent ``jitter[b]`` against the shared
    squared distances ``sqd`` (M, M); returns (B, C) in f64, +inf where
    the factorisation failed. Scored in ``score_dtype`` where given, in
    batches of at most GRAM_BUDGET Gram elements. Queues device work only,
    so a CUDA graph can capture it."""
    B, C, _ = pts.shape
    M = sqd.shape[-1]
    th = pts.reshape(B * C, 2)
    y = Y[:, None, :].expand(B, C, M).reshape(B * C, M)
    jit = jitter[:, None].expand(B, C).reshape(B * C)
    if score_dtype is not None:
        th, y, jit, sqd, mask = (t.to(score_dtype)
                                 for t in (th, y, jit, sqd, mask))
    step = max(1, GRAM_BUDGET // (M * M))
    parts = [gpops.nll_from_sqd(sqd, y[lo:lo + step], th[lo:lo + step],
                                jit[lo:lo + step], mask, gpops.k_se_linear,
                                rel_floor=rel_floor)
             for lo in range(0, B * C, step)]
    return torch.cat(parts).reshape(B, C).to(torch.float64)


def task_nll_lanes(pts, sqd, Y, mask, jitter):
    """``task_nll`` through the blocked lane-major NLL: the (task,
    candidate) pairs in the lane axis, each lane its own target column and
    jitter, in batches of at most LANES_BUDGET Gram elements; (B, C) in
    f64, +inf where the factorisation failed."""
    B, C, _ = pts.shape
    M = sqd.shape[-1]
    th = pts.reshape(B * C, 2)
    jit = jitter[:, None].expand(B, C).reshape(B * C)
    Ylanes = Y.T[:, None, :].expand(M, C, B).transpose(1, 2)  # (M, B, C)
    Ylanes = Ylanes.reshape(M, 1, B * C)
    step = max(1, LANES_BUDGET // (M * M))
    parts = [gp_lanes.nll_lanes_big(sqd, Ylanes[:, :, lo:lo + step],
                                    th[lo:lo + step], jit[lo:lo + step], mask,
                                    kernel=gp_lanes.k_se_linear_lanes)[0]
             for lo in range(0, B * C, step)]
    return torch.cat(parts).reshape(B, C)


class GParareal(ModelBase):
    name = "GP"

    def __init__(
        self,
        n,
        N,
        theta=None,
        fatol=None,
        xatol=None,
        nm_max_iters=400,
        seed=45,
        score_dtype=None,
        optimizer="nm",
        grid_chunk=None,
        grid_task_chunk=None,
        grid_logs=None,
        score_lanes=False,
        mesh=None,
        alpha_res_tol=1e-6,
        fit_rows_cap=16384,
        score_rows_cap=4096,
    ):
        super().__init__(n, N)
        if optimizer not in ("nm", "grid"):
            raise ValueError(f"unknown GParareal optimizer {optimizer!r}")
        if score_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"score_dtype must be None, torch.float32 or "
                             f"torch.float64, not {score_dtype!r}")
        theta = (np.array([1.0, 1.0]) if theta is None
                 else np.asarray(theta, float))
        self.theta0 = theta
        self.score_dtype = score_dtype
        self.thetas = np.tile(theta, (self.n, 1))  # warm starts per coord
        self.jitter_sel = np.full(self.n, np.nan)
        self.fatol = 1e-4 if fatol is None else float(fatol)
        self.xatol = 1e-4 if xatol is None else float(xatol)
        self.nm_max_iters = int(nm_max_iters)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.hyp = np.ones((self.n, theta.shape[0], self.N))
        self.k = 0
        self.state = None
        self.fvals = None
        self._jitters = np.arange(-20.0, -11.0)
        self.optimizer = optimizer
        # 13x13 log10 grid over the restart support 10^U(-4, 1), half-decade
        # steps, 10^0 (the warm start [1, 1]) among them
        self._grid_logs = (np.linspace(-4.5, 1.5, 13) if grid_logs is None
                           else np.asarray(grid_logs, float))
        self._refine_half_span = 0.45
        # candidates per batched NLL call in the grid search, and tasks per
        # call (None: sized by the memory budget, as the JAX package sizes
        # them)
        self.grid_chunk = None if grid_chunk is None else int(grid_chunk)
        self.grid_task_chunk = (None if grid_task_chunk is None
                                else int(grid_task_chunk))
        # the grid search's NLL through the blocked lane-major factor
        self.score_lanes = bool(score_lanes)
        # the grid search's task pool over a mesh of more than one device
        self.mesh = (mesh if mesh is not None and mesh.devices.size > 1
                     else None)
        # the residual below which a posterior solve is usable
        self.alpha_res_tol = float(alpha_res_tol)
        # fit on at most this many of the newest valid rows
        self.fit_rows_cap = None if fit_rows_cap is None else int(fit_rows_cap)
        # grid search only: score on at most this many newest valid rows
        # (the posterior keeps the whole fit window)
        self.score_rows_cap = (None if score_rows_cap is None
                               else int(score_rows_cap))
        self.alpha_rejects = []  # (k, coord, rel, to) audit trail
        # fits whose posterior stayed unusable after the walk
        self.alpha_unusable = []
        self._graphs = {}
        # per fit: its bucket of rows, and the Nelder-Mead searches'
        # iterations until every simplex froze and (on a card) replays
        self.fit_buckets = []
        self.nm_stats = {"iterations": [], "replays": 0}

    def _rel_floor(self):
        # f32 scoring: a relative jitter floor (x the Gershgorin bound), as
        # in the JAX package (its ops/gp.py gp_nll says why)
        if self.score_dtype == torch.float32:
            return 4.0 * float(np.finfo(np.float32).eps)
        return None

    def _jitter_tensor(self, like):
        return torch.arange(-20.0, -11.0, dtype=torch.float64,
                            device=like.device)

    # --- the searches ---

    def _search(self, key, x0, data, rel_floor, graphed=None):
        """Nelder-Mead over the tasks of ``data`` = (sqd, Y, mask,
        jitter) from x0 (T, 2): (thetas (T, 2), fvals (T,)). On a card
        (``graphed`` None) as CUDA graphs, one instance per ``key``; the
        graphs of another bucket are dropped first."""
        obj = functools.partial(task_nll, rel_floor=rel_floor,
                                score_dtype=self.score_dtype)
        if graphed is None:
            graphed = x0.device.type == "cuda"
        if not graphed:
            stats = {}
            out = nelder_mead_fixed(
                lambda pts: obj(pts, *data), x0, iters=self.nm_max_iters,
                fatol=self.fatol, xatol=self.xatol, stats=stats)
            self.nm_stats["iterations"].append(stats["run"])
            return out
        nmg = self._graphs.get(key)
        if nmg is None:
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[1] == key[1]}
            nmg = self._graphs[key] = NelderMeadGraphs(
                obj, data, x0.shape[0], 2, self.nm_max_iters, self.fatol,
                self.xatol, block=NM_BLOCK)
        out = nmg.run(x0, *data)
        self.nm_stats["iterations"].append(nmg.last["live"])
        self.nm_stats["replays"] += nmg.last["replays"]
        return out

    def _fit_warm(self, X, D, valid, x0, graphed=None):
        """The Nelder-Mead fit of every (coordinate, jitter) task from the
        warm starts x0 (n*9, 2), coordinate-major; returns each
        coordinate's best (theta (n, 2), jitter exponent (n,), NLL (n,))."""
        n, nj = self.n, len(self._jitters)
        jitters = self._jitter_tensor(X)
        sqd = gpops.pairwise_sq_dists(X, X)
        Y = D.T.repeat_interleave(nj, dim=0)  # (n*nj, M)
        data = (sqd, Y, valid, jitters.repeat(n))
        th, fv = self._search(("fit", X.shape[0], n * nj), x0, data,
                              self._rel_floor(), graphed)
        fv = fv.reshape(n, nj)
        th = th.reshape(n, nj, 2)
        best = torch.argmin(fv, dim=1)
        rows = torch.arange(n, device=X.device)
        return th[rows, best], jitters[best], fv[rows, best]

    def _fit_grid(self, X, Ycols, valid, grids, jp):
        """Dense theta search over a slice of the task pool: Ycols (Tc, M)
        per-task targets, grids (Tc, G, 2) linear-scale candidates, jp
        (Tc,) per-task jitter exponents; (thetas (Tc, 2), NLLs (Tc,)).
        The candidates are scored ``chunk`` at a time (a Gram budget of
        2^28 elements, or ``grid_chunk``)."""
        M = X.shape[0]
        G = grids.shape[1]
        chunk = max(1, min(G, int(2 ** 28 // max(M * M, 1))))
        if self.grid_chunk is not None:
            chunk = max(1, min(G, self.grid_chunk))
        sqd = gpops.pairwise_sq_dists(X, X)
        if self.score_lanes:
            # no f32 floor on this path, as in the JAX package
            score = functools.partial(task_nll_lanes, sqd=sqd, Y=Ycols,
                                      mask=valid, jitter=jp)
        else:
            score = functools.partial(task_nll, sqd=sqd, Y=Ycols, mask=valid,
                                      jitter=jp, rel_floor=self._rel_floor(),
                                      score_dtype=self.score_dtype)
        f = torch.cat([score(grids[:, lo:lo + chunk])
                       for lo in range(0, G, chunk)], dim=1)
        i = torch.argmin(f, dim=1)
        rows = torch.arange(f.shape[0], device=f.device)
        return grids[rows, i], f[rows, i]

    def _fit_grid_search(self, dsX, dsD, dsV):
        """One coarse 13x13 log grid over the restart support, then refine
        grids of the same shape around each task's winner, widened 4x and
        16x while a coordinate has no finite NLL; such a coordinate comes
        back with +inf (fit() rescues it). Returns each coordinate's best
        (theta, jitter exponent, NLL) as numpy, and the per-jitter
        candidate table (None with f32 scoring). With a mesh, block j of
        each call's tasks is scored on the mesh's device j, every block
        queued before any result is read."""
        n = self.n
        # f32 scoring: the relative floor lies above every grid jitter, so
        # the 9 jitter tasks would score alike; one task per coordinate at
        # the grid's ceiling (-12) does the same search
        score_f32 = self.score_dtype == torch.float32
        jit_tasks = np.array([-12.0]) if score_f32 else self._jitters
        nj = len(jit_tasks)
        T = n * nj
        logs = self._grid_logs
        base = np.stack(np.meshgrid(logs, logs, indexing="ij"),
                        -1).reshape(-1, 2)  # (G, 2) log10
        G = base.shape[0]
        cap = int(dsX.shape[0])
        tc = self.grid_task_chunk
        if tc is None:
            tc = max(1, min(T, (18 * 256 * 256) // max(cap * cap, 1)))
        dev = dsX.device
        # with a mesh each call carries tc tasks per device, and dummy
        # tasks (zero targets, jitter 10^-12, theta 1) pad the pool to
        # whole calls; their NLLs are dropped
        devs = [dev] if self.mesh is None else list(self.mesh.devices)
        per_call = tc * len(devs)
        Tp = T if self.mesh is None else -(-T // per_call) * per_call
        Ycols = torch.cat([dsD.T.repeat_interleave(nj, dim=0),
                           dsD.new_zeros((Tp - T, cap))])  # (Tp, M)
        jp = np.concatenate([np.tile(jit_tasks, n), np.full(Tp - T, -12.0)])
        # each device's copy of the fit's data, made once per fit
        data = {d: tuple(x.to(d) for x in (dsX, Ycols, dsV,
                                           torch.as_tensor(jp, device=d)))
                for d in dict.fromkeys(devs)}

        def run_grid(g_full):
            g_full = np.concatenate([g_full, np.ones((Tp - T, G, 2))])
            gj = {d: torch.as_tensor(g_full, dtype=torch.float64, device=d)
                  for d in data}
            # every block is queued before any result is read
            th_parts, f_parts = [], []
            queued = dev.type == "cuda"
            for s in range(0, Tp, tc):
                d = devs[(s // tc) % len(devs)]
                X, Y, V, jpd = data[d]
                th_s, f_s = self._fit_grid(X, Y[s:s + tc], V, gj[d][s:s + tc],
                                           jpd[s:s + tc])
                th_parts.append(th_s.to(dev, non_blocking=queued))
                f_parts.append(f_s.to(dev, non_blocking=queued))
            return (torch.cat(th_parts)[:T].cpu().numpy(),
                    torch.cat(f_parts)[:T].cpu().numpy())

        th1, f1 = run_grid(np.broadcast_to(10.0 ** base, (T, G, 2)))
        hs = self._refine_half_span
        r = np.linspace(-hs, hs, len(logs))
        offs = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
        # a non-finite winner refines around the warm start instead
        centre = np.where(np.isfinite(f1)[:, None],
                          np.log10(np.maximum(th1, 1e-300)), 0.0)
        th, fv = th1, f1
        for widen in (1.0, 4.0, 16.0):
            th2, f2 = run_grid(10.0 ** (centre[:, None, :]
                                        + widen * offs[None]))
            better = f2 < fv
            th = np.where(better[:, None], th2, th)
            fv = np.minimum(fv, f2)
            if np.all(np.isfinite(fv)):
                break
        fv = fv.reshape(n, nj)
        th = th.reshape(n, nj, 2)
        best = np.argmin(fv, axis=1)
        th_best = np.take_along_axis(th, best[:, None, None], 1)[:, 0, :]
        fv_best = np.take_along_axis(fv, best[:, None], 1)[:, 0]
        cand = None if score_f32 else (th, fv)
        return th_best, np.asarray(jit_tasks[best], float), fv_best, cand

    # --- the posterior ---

    def _alphas(self, X, D, valid, th, jv):
        """The f64 posterior weights (n, M) of each coordinate's (theta,
        jitter exponent), in batches of coordinates within the budget."""
        sqd = gpops.pairwise_sq_dists(X, X)
        M = X.shape[0]
        step = max(1, GRAM_BUDGET // (M * M))
        parts = []
        for lo in range(0, self.n, step):
            K = gpops.k_se_linear(sqd, th[lo:lo + step])
            parts.append(gpops.gp_fit(K, D.T[lo:lo + step], jv[lo:lo + step],
                                      valid)[1])
        return torch.cat(parts)

    def _alpha_resid(self, X, D, valid, th, jv, alpha):
        """Relative residual ||(K + jI) a - y|| / ||y|| per coordinate, as
        numpy: a backward-stable solve keeps it at O(m eps) whatever the
        conditioning, so it separates a usable posterior from a failed
        factorisation (NaN, or finite garbage from a near-zero pivot)."""
        sqd = gpops.pairwise_sq_dists(X, X)
        out = []
        for c in range(self.n):
            K = gpops.k_se_linear(sqd, th[c])
            Kj = gpops._masked_gram(K, valid, jv[c])
            ym = D[:, c] * valid
            r = Kj @ alpha[c] - ym
            out.append(torch.sqrt(torch.sum(r * r)) / torch.clamp(
                torch.sqrt(torch.sum(ym * ym)), min=1e-300))
        return torch.stack(out).cpu().numpy()

    # --- model protocol ---

    @staticmethod
    def _bucket(rows, cap):
        """Smallest power of two >= rows, capped."""
        b = 1
        while b < rows:
            b *= 2
        return min(b, cap)

    @staticmethod
    def _window(X, D, valid, rows, cap, bucket_cap):
        """The newest ``cap`` valid rows of the first ``rows``, gathered
        into a bucket: (X, D, valid, the gathered row indices)."""
        vmask = valid[:rows].cpu().numpy() > 0
        idx = np.where(vmask)[0][-cap:]
        B = GParareal._bucket(max(idx.size, 1), bucket_cap)
        sel = np.zeros(B, np.int64)  # dummy slots gather row 0, masked
        sel[: idx.size] = idx
        sel = torch.as_tensor(sel, device=X.device)
        v = torch.as_tensor((np.arange(B) < idx.size).astype(np.float64),
                            device=X.device)
        return X[sel], D[sel], v, sel

    def fit(self, ds, k):
        self.k = int(k)
        nj = len(self._jitters)
        dev = ds.X.device
        # occupied rows are [0, (k+1)*N); train on the smallest bucket
        rows = min((k + 1) * self.N, ds.capacity)
        scatter_idx = None
        if self.fit_rows_cap is not None and rows > self.fit_rows_cap:
            dsX, dsD, dsV, scatter_idx = self._window(
                ds.X, ds.D, ds.valid, rows, self.fit_rows_cap,
                self.fit_rows_cap)
            B = dsX.shape[0]
        else:
            B = self._bucket(rows, ds.capacity)
            dsX, dsD, dsV = ds.X[:B], ds.D[:B], ds.valid[:B]
        self.fit_buckets.append(B)

        cand = None
        if self.optimizer == "grid":
            sX, sD, sV = dsX, dsD, dsV
            if self.score_rows_cap is not None and B > self.score_rows_cap:
                # score on the newest rows; the posterior keeps the window
                sX, sD, sV, _ = self._window(dsX, dsD, dsV, B,
                                             self.score_rows_cap,
                                             self.score_rows_cap)
            th, jv, fv, cand = self._fit_grid_search(sX, sD, sV)
        else:
            x0 = np.repeat(self.thetas, nj, axis=0)  # (n*nj, 2)
            th, jv, fv = self._fit_warm(
                dsX, dsD, dsV, torch.as_tensor(x0, device=dev))
            th, jv, fv = (t.cpu().numpy() for t in (th, jv, fv))
        bad = np.where(~np.isfinite(fv))[0]
        if bad.size:
            th, jv, fv = self._rescue(dsX, dsD, dsV, th, jv, fv, bad)

        alpha = self._alphas(dsX, dsD, dsV, torch.as_tensor(th, device=dev),
                             torch.as_tensor(jv, device=dev))
        n_valid = int(dsV.sum().item())
        if n_valid:
            th, jv, fv, alpha = self._validate_alphas(
                dsX, dsD, dsV, th, jv, np.asarray(fv, float), alpha, cand,
                n_valid=n_valid)
        # an all-invalid dataset: the masked Gram is the identity and y is
        # zero, so the residual check is vacuous and is skipped
        self.thetas = th
        self.jitter_sel = jv
        self.fvals = fv
        self.hyp[..., min(k + 1, self.N - 1)] = th
        # alpha back at the dataset's rows: padded rows get 0
        alpha_full = torch.zeros((self.n, ds.capacity), dtype=torch.float64,
                                 device=dev)
        if scatter_idx is None:
            alpha_full[:, :B] = alpha
        else:
            # add: dummy slots alias row 0 but carry masked-zero alpha
            alpha_full.index_add_(1, scatter_idx, alpha * dsV[None, :])
        self.state = (torch.as_tensor(th, device=dev),
                      torch.as_tensor(jv, device=dev), alpha_full)
        return None

    def _validate_alphas(self, dsX, dsD, dsV, th, jv, fv, alpha, cand=None,
                         n_valid=None):
        """Reject posterior solves the corrector would silently discard.

        A theta whose scored NLL is finite can still give a Gram that the
        f64 factorisation fails on (NaN alpha): every prediction would then
        fall back to the bare correction. A solve whose relative residual
        is not below ``alpha_res_tol`` is unusable. Its coordinate first
        walks the grid's per-jitter candidates by NLL (``cand``), then
        raises its jitter by 100x at a time up to 10^-4. th, jv, fv are
        numpy arrays, changed in place; returns (th, jv, fv, alpha).
        """
        tol = self.alpha_res_tol
        jit_cap = -4.0
        nj = len(self._jitters)
        dev = dsX.device

        def fit_alphas():
            return self._alphas(dsX, dsD, dsV, torch.as_tensor(th, device=dev),
                                torch.as_tensor(jv, device=dev))

        def bad_coords(a):
            rel = self._alpha_resid(dsX, dsD, dsV,
                                    torch.as_tensor(th, device=dev),
                                    torch.as_tensor(jv, device=dev), a)
            return np.where(~(rel < tol))[0], rel  # NaN counts as bad

        bad, rel = bad_coords(alpha)
        if not bad.size:
            return th, jv, fv, alpha

        # phase 1: the next-best grid candidates by NLL (rank 0 is the
        # pick that failed)
        if cand is not None:
            th_nj, fv_nj = cand
            order = np.argsort(fv_nj, axis=1)
            for rank in range(1, nj):
                for c in bad:
                    j = order[c, rank]
                    if np.isfinite(fv_nj[c, j]):
                        self.alpha_rejects.append(dict(
                            k=self.k, coord=int(c), rel=float(rel[c]),
                            to=(float(self._jitters[j]),
                                th_nj[c, j].tolist())))
                        th[c] = th_nj[c, j]
                        jv[c] = self._jitters[j]
                        fv[c] = fv_nj[c, j]
                alpha = fit_alphas()
                bad, rel = bad_coords(alpha)
                if not bad.size:
                    return th, jv, fv, alpha

        # phase 2: raise the jitter past the grid's ceiling, per
        # coordinate (one at the cap does not stop the others)
        while bad.size:
            esc = bad[jv[bad] < jit_cap]
            if not esc.size:
                break
            for c in esc:
                self.alpha_rejects.append(dict(
                    k=self.k, coord=int(c), rel=float(rel[c]),
                    to=(float(jv[c]) + 2.0, th[c].tolist())))
                jv[c] = jv[c] + 2.0
            alpha = fit_alphas()
            bad, rel = bad_coords(alpha)

        if bad.size:
            self.alpha_unusable.append(dict(
                k=self.k, coords=bad.tolist(),
                rel=[float(r) for r in rel[bad]], n_valid=n_valid))
            print(f"[gp] WARNING: k={self.k} posterior solve unusable on "
                  f"coords {bad.tolist()} (rel res {rel[bad].tolist()}, "
                  f"{n_valid} valid rows) after candidate walk + jitter "
                  f"escalation; the sweep's finite-guard will fall back "
                  f"to plain parareal there")
        return th, jv, fv, alpha

    def _rescue(self, dsX, dsD, dsV, th, jv, fv, bad, max_attempts=20):
        """Random restarts for the +inf coordinates ``bad``: up to
        ``max_attempts`` rounds of max(3, N/9) x 9 Nelder-Mead searches
        each, starts 10^U(-4, 1) from the model's generator, jitters tiled;
        raises when a coordinate finds no finite NLL. th, jv, fv are numpy
        arrays, changed in place."""
        nj = len(self._jitters)
        tot_rnd = max(3, int(self.N / 9))
        dev = dsX.device
        sqd = gpops.pairwise_sq_dists(dsX, dsX)
        jit_tasks = self._jitter_tensor(dsX).repeat(tot_rnd)
        T = tot_rnd * nj
        for j in bad:
            y = dsD[:, int(j)]
            data = (sqd, y[None, :].expand(T, -1).contiguous(), dsV,
                    jit_tasks)
            for _ in range(max_attempts):
                starts = 10.0 ** self.rng.uniform(-4, 1, (T, 2))
                # the rescue scores without the f32 floor, as in JAX
                th_r, fv_r = self._search(
                    ("rescue", dsX.shape[0], T),
                    torch.as_tensor(starts, device=dev), data, None)
                fv_r = fv_r.cpu().numpy()
                best = int(np.argmin(fv_r))
                if np.isfinite(fv_r[best]):
                    th[int(j)] = th_r[best].cpu().numpy()
                    jv[int(j)] = float(jit_tasks[best])
                    fv[int(j)] = fv_r[best]
                    break
            else:
                raise RuntimeError(
                    f"GP random-restart rescue failed for coordinate "
                    f"{int(j)}: no finite NLL after {max_attempts} rounds")
        return th, jv, fv

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        """The predicted defect (n,) at ``q``: each coordinate's kernel row
        against every dataset row (invalid rows masked) dotted with its
        alpha. A NaN alpha gives NaN, which the driver's finite guard turns
        into the bare correction."""
        th, _, alpha = self.state
        sqd_q = gpops.sq_dists_to(q, ds.X)  # (CAP,)
        k_star = gpops.k_se_linear(sqd_q, th) * ds.valid  # (n, CAP)
        return gpops.gp_posterior_mean(k_star, alpha)

    # --- timings and checkpoints ---

    def get_times(self):
        # counts, not the audit dicts: what a guard keys on
        out = super().get_times()
        out.update(alpha_rejects=len(self.alpha_rejects),
                   alpha_unusable=len(self.alpha_unusable),
                   gp_buckets=list(self.fit_buckets))
        if self.optimizer == "nm" or self.nm_stats["iterations"]:
            out.update(nm_iterations=list(self.nm_stats["iterations"]),
                       nm_graph_replays=self.nm_stats["replays"])
        return out

    def get_ckpt_state(self):
        out = super().get_ckpt_state()
        out.update(
            thetas=self.thetas,
            jitter_sel=self.jitter_sel,
            hyp=self.hyp,
            k=self.k,
            alpha_rejects=self.alpha_rejects,
            alpha_unusable=self.alpha_unusable,
        )
        return out

    def set_ckpt_state(self, state):
        super().set_ckpt_state(state)
        self.thetas = np.array(state["thetas"], dtype=float)
        self.jitter_sel = np.array(state["jitter_sel"], dtype=float)
        self.hyp = np.array(state["hyp"], dtype=float)
        self.k = int(state["k"])
        self.alpha_rejects = list(state.get("alpha_rejects", []))
        self.alpha_unusable = list(state.get("alpha_unusable", []))
