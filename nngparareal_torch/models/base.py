"""Correction-model interface.

Port of ``nngparareal_tpu/models/base.py``. A model provides

* ``fit(ds, k)``         once per parareal iteration;
* ``sweep_aux(k, N, cap)`` once per sweep: a host draw (numpy) whose
                           row i the driver hands interval i, or None;
* ``predict_fn(ds, q, uF_prev, uG_prev, i, aux_i)``  the correction for
                           one interval, called by the driver's corrector
                           sweep; it queues device work (the Nelder-Mead
                           search alone reads its convergence back).

The dataset is a fixed-capacity padded buffer (``Dataset``) with a
validity mask, as in the JAX package; the port appends rows in place.
"""

from dataclasses import dataclass

import numpy as np
import torch

from nngparareal_torch.utils.device import resolve_device


@dataclass
class Dataset:
    """Padded (state, defect) training set.

    X, D: (CAP, n); valid: (CAP,) float mask (1.0 = real row). Rows are
    appended N at a time per parareal iteration; rows belonging to already
    converged slices are masked out.
    """

    X: torch.Tensor
    D: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self):
        return int(self.X.shape[0])

    @property
    def dim(self):
        return int(self.X.shape[1])

    @staticmethod
    def empty(capacity, n, dtype=torch.float64, device=None):
        """A dataset of ``capacity`` zero rows of width ``n`` on ``device``
        (None: the card, as every entry point; it raises without one)."""
        device = resolve_device(device)
        return Dataset(
            X=torch.zeros((capacity, n), dtype=dtype, device=device),
            D=torch.zeros((capacity, n), dtype=dtype, device=device),
            valid=torch.zeros((capacity,), dtype=dtype, device=device),
        )

    def append_(self, newX, newD, new_valid, offset):
        """Write a block of rows at ``offset``, in place."""
        rows = int(newX.shape[0])
        self.X[offset:offset + rows] = newX
        self.D[offset:offset + rows] = newD
        self.valid[offset:offset + rows] = new_valid

    def grown(self, new_capacity):
        cap, n = self.capacity, self.dim
        out = Dataset.empty(new_capacity, n, self.X.dtype, self.X.device)
        out.X[:cap] = self.X
        out.D[:cap] = self.D
        out.valid[:cap] = self.valid
        return out


class ModelBase:
    name = "Model"
    needs_dataset = True

    def __init__(self, n, N):
        self.n = int(n)
        self.N = int(N)
        # wall-clock accounting filled in by the driver
        self.train_time = 0.0
        self.pred_time = 0.0
        self.pred_times = np.zeros(self.N)
        # per-iteration count of active (predicted) intervals
        self.active_counts = np.zeros(self.N)
        self.time_k = 0

    # --- to override ---

    def fit(self, ds, k):
        """Per-iteration training."""
        return None

    def predict_fn(self, ds, q, uF_prev, uG_prev, i, aux_i=None):
        """Correction prediction for interval i.

        q: (n,) current iterate at the interval's left node;
        uF_prev/uG_prev: (n,) fine/coarse values from the previous
        iteration at the right node; aux_i: row i of ``sweep_aux``'s
        draw. Returns the predicted defect (n,).
        """
        raise NotImplementedError

    def sweep_aux(self, k, N, cap=None):
        """Per-sweep random draw (N, ...) or None (no draw)."""
        return None

    def reset_rng(self):
        """Re-seed any host RNG."""
        return None

    # --- timing bookkeeping ---

    def add_train_time(self, k, seconds):
        self.time_k = k
        self.train_time += seconds
        self.pred_times[k] += seconds

    def add_pred_time(self, k, seconds, n_active=None):
        self.pred_time += seconds
        self.pred_times[k] += seconds
        if n_active is not None and k < self.N:
            self.active_counts[k] = n_active

    def get_times(self):
        return {
            "mdl_train_t": self.train_time,
            "mdl_pred_t": self.pred_time,
            "mdl_tot_t": self.train_time + self.pred_time,
            "by_iter": self.pred_times[: self.time_k + 1],
        }

    # --- checkpoint support (same layout as the JAX package's) ---

    _RNG_ATTRS = ("rng", "rng2")

    def get_ckpt_state(self):
        rngs = {}
        for a in self._RNG_ATTRS:
            g = getattr(self, a, None)
            if isinstance(g, np.random.Generator):
                rngs[a] = g.bit_generator.state
        return {
            "train_time": self.train_time,
            "pred_time": self.pred_time,
            "pred_times": self.pred_times,
            "active_counts": self.active_counts,
            "time_k": self.time_k,
            "rng_state": rngs,
        }

    def set_ckpt_state(self, state):
        self.train_time = float(state["train_time"])
        self.pred_time = float(state["pred_time"])
        self.pred_times = np.array(state["pred_times"], dtype=float)
        self.active_counts = np.array(
            state.get("active_counts", np.zeros_like(self.pred_times)),
            dtype=float,
        )
        self.time_k = int(state["time_k"])
        rngs = state.get("rng_state")
        if rngs is None:
            self.reset_rng()
        else:
            for a, s in rngs.items():
                g = getattr(self, a, None)
                if isinstance(g, np.random.Generator):
                    g.bit_generator.state = s
