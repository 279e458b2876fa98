"""nnGParareal: per-query nearest-neighbour local GPs (the paper's method).

Port of ``nngparareal_tpu/models/nngp.py`` with a fixed neighbour count
``nn``, the deterministic grid hyperparameter search (``optimizer='grid'``),
NLL selection and the Cholesky posterior. For every prediction point the m
nearest dataset rows (squared euclidean) form a local GP per state
coordinate (log10-scale SE kernel); hyperparameters come from a dense
(theta x jitter) grid of NLL scores, a walk and halving refinement, a
jitter re-scan and one polish round. A caller names the search: the JAX
package defaults to Nelder-Mead, which the port does not have yet, so a
call without ``optimizer`` is refused (``check_optimizer``).

Every step queues torch ops on the dataset's device and reads nothing back
to the host, so the driver's sweep over intervals never waits on the card.
"""

import numpy as np
import torch

from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.ops import gp as gpops
from nngparareal_torch.ops import gp_lanes as gplanes
from nngparareal_torch.ops.nn_select import nearest_neighbors

# the grid search's settings, as the JAX package's defaults fix them: the
# gain a walk step must beat, and the number of walk and halving rounds
_FATOL = 0.1
_GRID_WALK = 4
_GRID_REFINE = 2


class NNGParareal(ModelBase):
    name = "NNGP"

    def __init__(self, n, N, nn, seed=45, optimizer=None):
        super().__init__(n, N)
        self.check_optimizer(optimizer)
        self.nn = int(nn)
        self.seed = int(seed)
        # host generators kept only so checkpoints carry the same model
        # state as the JAX package's (the grid search draws nothing)
        self.rng = np.random.default_rng(self.seed)
        self.rng2 = np.random.default_rng(self.seed)
        self.k = 0

    @staticmethod
    def check_optimizer(optimizer):
        """Refuse every search but the grid. The JAX package's default,
        Nelder-Mead (``optimizer='nm'``), waits for later work, so a call
        that names no optimizer raises instead of running the grid search
        under the JAX default's name."""
        if optimizer is None:
            raise NotImplementedError(
                "NNGParareal needs optimizer='grid': the JAX package's "
                "default, optimizer='nm' (Nelder-Mead), is not ported yet "
                "(ROADMAP.md, modules still to port, item 4)")
        if optimizer != "grid":
            raise NotImplementedError(
                f"NNGParareal optimizer={optimizer!r} is not ported yet "
                "(ROADMAP.md, modules still to port, item 4)")

    # --- model protocol ---

    def fit(self, ds, k):
        # lazy: the data lives in ds
        self.k = int(k)
        return None

    def reset_rng(self):
        self.rng = np.random.default_rng(self.seed)

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
        return out

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
        schedule = [(1.0, _FATOL)] * _GRID_WALK
        s = 0.5
        for _ in range(_GRID_REFINE):
            schedule.append((s, 0.0))
            s *= 0.5
        for step, gate in schedule:
            th_best, fv_best = theta_round(th_best, jit_best, fv_best, step,
                                           gate)
        # final noise-floor re-selection + one polish round
        jit_best, fv_best = jitter_rescan(th_best, jit_best, fv_best,
                                          _FATOL)
        th_best, fv_best = theta_round(th_best, jit_best, fv_best, 0.5, 0.0)

        # expand back to the coord-major per-task layout: the winner sits
        # in the task slot whose jitter matches, +inf elsewhere
        jit_tasks = self._jitter_grid(dt, dev) + jitter_shift
        fv_tasks = torch.where(jit_tasks == jit_best[:, None],
                               fv_best[:, None], torch.inf)
        th_tasks = th_best[:, None, :].expand(n, 9, 2)
        return th_tasks.reshape(-1, 2), fv_tasks.reshape(-1)

    def _jitter_grid(self, dtype, device):
        """(n, 9) unshifted jitter exponents -20..-12 per coordinate."""
        return torch.arange(-20.0, -11.0, dtype=dtype,
                            device=device).repeat(self.n, 1)

    def predict_fn(self, ds, q, uF_prev, uG_prev, i):
        m = min(self.nn, ds.capacity)
        idx, sqd_sel = nearest_neighbors(q, ds.X, ds.valid, m)
        sel_mask = torch.isfinite(sqd_sel).to(ds.valid.dtype)
        xm = ds.X[idx]  # (m, n)
        ym = ds.D[idx]  # (m, n)
        mask = sel_mask * ds.valid[idx]

        sqd_xx = gpops.pairwise_sq_dists(xm, xm)
        sqd_xq = gpops.sq_dists_to(q, xm)

        # targets divided by ONE global rms scale; the jitter exponents
        # shift by -2 log10(scale) so the ABSOLUTE jitter grid is unchanged
        count = torch.clamp(torch.sum(mask), min=1.0)
        ymm = ym * mask[:, None]
        power = torch.sum(ymm * ymm, dim=0) / count  # (n,)
        glob = torch.max(power)
        y_scale = torch.where(glob > 0, torch.sqrt(glob), 1.0)
        jitter_shift = -2.0 * torch.log10(y_scale)
        ym_fit = ym / y_scale

        thetas, fvals = self._grid_shared(sqd_xx, ym_fit, mask, jitter_shift)

        # per-coordinate NLL argmin over the task slots
        fv = fvals.reshape(self.n, 9)
        th = thetas.reshape(self.n, 9, 2)
        jv = self._jitter_grid(fv.dtype, fv.device)
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
