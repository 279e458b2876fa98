"""Coarse/fine propagators.

Port of ``nngparareal_tpu/solver.py:RKSolver``:

* ``run_F`` / ``run_G`` integrate one slice;
* ``run_F_batch`` integrates all slices at once: the fine fan-out;
* ``run_G_chain`` runs the sequential coarse initialisation over all slices;
* ``coarse_step_raw`` is the coarse solve the corrector sweep calls for
  each interval.

Step counts Ng/Nf are per slice. The fine fan-out runs as the CUDA kernel
(ops/rk_cuda.py) or as the plain torch f64 integrator (ops/rk.py), chosen
by ``fine`` (see ``select_fine_mode``).
"""

import torch

from nngparareal_torch.ops.butcher import get_tableau
from nngparareal_torch.ops.rk import (
    integrate_last,
    make_batched_last_integrator,
    make_last_integrator,
)
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.utils.device import resolve_device


class SolverAbstr:
    def run_F(self, t0, t1, u0):
        raise NotImplementedError

    def run_G(self, t0, t1, u0):
        raise NotImplementedError


def select_fine_mode(device, has_device_field):
    """Pick the fine fan-out for ``device``: 'cuda' (the kernel) on a card,
    'torch' (the plain integrator) on the CPU.

    The port's counterpart of ``nngparareal_tpu/solver.py:select_fine_mode``.
    On a card a system without a device field has no fan-out yet: that
    raises rather than running the plain version on the main path."""
    if torch.device(device).type != "cuda":
        return "torch"
    if not has_device_field:
        raise NotImplementedError(
            "the CUDA fan-out kernel has no form of this system's field yet "
            "(ROADMAP.md, TPU kernels still to port, item 1); pass "
            "fine='torch' to run the plain integrator on the card"
        )
    return "cuda"


class RKSolver(SolverAbstr):
    def __init__(self, f, Ng, Nf, G="RK1", F="RK4", thresh=int(1e7),
                 fine="auto", device_field=None, device=None):
        """``fine``: 'auto' | 'cuda' | 'torch'. 'auto' resolves through
        ``select_fine_mode``; 'cuda' is the kernel, which needs
        ``device_field`` (``ode.get_device_field()``); 'torch' is the plain
        f64 integrator of ``f``. On CPU tensors the kernel's wrapper itself
        takes the plain version."""
        self.f = f
        self.Ng = int(Ng)
        self.Nf = int(Nf)
        self.G = get_tableau(G)
        self.F = get_tableau(F)
        self.thresh = int(thresh)
        self.device = resolve_device(device)
        self.device_field = device_field
        if fine not in ("auto", "cuda", "torch"):
            raise ValueError(f"fine={fine!r}")
        if fine == "auto":
            fine = select_fine_mode(self.device, device_field is not None)
        if fine == "cuda" and device_field is None:
            raise ValueError("fine='cuda' requires device_field")
        self.fine = fine

        self._coarse_last = make_last_integrator(f, self.G, self.Ng,
                                                 self.thresh)
        self._fine_last = make_last_integrator(f, self.F, self.Nf, self.thresh)
        self._fine_plain = make_batched_last_integrator(f, self.F, self.Nf,
                                                        self.thresh)

    def prepare(self):
        """Build the fine kernel now (outside any timed region)."""
        if self.fine == "cuda" and self.device.type == "cuda":
            rk_cuda.build()

    def _t(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    # --- single-slice API ---

    def run_F(self, t0, t1, u0):
        u0 = self._t(u0)
        if self.fine == "cuda":
            return self.run_F_batch(self._t([t0]), self._t([t1]), u0[None])[0]
        return self._fine_last(t0, t1, u0)

    def run_G(self, t0, t1, u0):
        return self._coarse_last(t0, t1, self._t(u0))

    # --- batched API ---

    @torch.inference_mode()
    def run_F_batch(self, t0s, t1s, U):
        """Fine-solve all slices at once: (B,), (B,), (B, n) -> (B, n)."""
        t0s = self._t(t0s).contiguous()
        t1s = self._t(t1s).contiguous()
        U = self._t(U).contiguous()
        if self.fine == "cuda":
            return rk_cuda.rk_fanout(t0s, t1s, U, self.F, self.Nf,
                                     self.device_field, self.f)
        return self._fine_plain(t0s, t1s, U)

    def coarse_step_raw(self, t0, dt_slice, u0):
        """One-slice coarse solve (called by the corrector sweep)."""
        dt = dt_slice / self.Ng
        return integrate_last(self.f, self.G, t0, dt, self.Ng, u0)

    @torch.inference_mode()
    def run_G_chain(self, t, u0):
        """Sequential coarse init over all N slices.

        t: (N+1,) uniform grid. Returns (N+1, n) with row 0 = u0.
        """
        t = torch.as_tensor(t, dtype=torch.float64)
        N = int(t.shape[0]) - 1
        t_host = t.tolist()
        dt_slice = (t_host[-1] - t_host[0]) / N
        u = self._t(u0)
        rows = [u]
        for i in range(N):
            u = self.coarse_step_raw(t_host[i], dt_slice, u)
            rows.append(u)
        return torch.stack(rows)
