"""Coarse/fine propagators.

Port of ``nngparareal_tpu/solver.py:RKSolver``:

* ``run_F`` / ``run_G`` integrate one slice;
* ``run_F_batch`` integrates all slices at once: the fine fan-out
  (``fine_batch_raw`` the same on its inputs' own device, for a mesh);
* ``run_G_chain`` runs the sequential coarse initialisation over all slices;
* ``coarse_step_raw`` is the coarse solve the corrector sweep calls for
  each interval, ``fine_step_raw`` its fine twin;
* ``run_F_full`` / ``run_G_full`` return a slice's whole trajectory, and
  the ``*_timed`` methods return (result, seconds).

``ScipySolver`` is the host validation path: an adaptive scipy fine solve
per slice, the coarse side delegated to an ``RKSolver``.

Step counts Ng/Nf are per slice. The fine fan-out runs as the CUDA kernel
(ops/rk_cuda.py) or as the plain torch f64 integrator (ops/rk.py), chosen
by ``fine`` (see ``select_fine_mode``), or when asked for in double-single
arithmetic: the plain ds integrator (ops/rk_ds.py, ``fine='ds'``) or the
ds kernel (ops/rk_cuda_ds.py, ``fine='pallas'``). On a card, an ODE's
coarse solves (``coarse_step_raw``, ``run_G_chain``) launch the f64
kernel at B=1 with the coarse tableau: one launch per solve in place of
a host loop of torch ops per RK step. The PDE fields keep the torch
coarse step, and the CPU runs keep it for every system.
"""

import torch

from nngparareal_torch.ops.butcher import get_tableau
from nngparareal_torch.ops.rk import (
    integrate_last,
    make_batched_last_integrator,
    make_last_integrator,
    make_traj_integrator,
)
from nngparareal_torch.ops import ds32, rk_cuda
from nngparareal_torch.ops.rk_cuda_ds import make_cuda_fanout_ds
from nngparareal_torch.ops.rk_ds import (
    integrate_last_ds,
    make_batched_last_integrator_ds,
)
from nngparareal_torch.systems.base import numpy_field
from nngparareal_torch.utils.device import resolve_device
from nngparareal_torch.utils.timing import wall_timed


class SolverAbstr:
    def run_F(self, t0, t1, u0):
        raise NotImplementedError

    def run_G(self, t0, t1, u0):
        raise NotImplementedError

    def run_F_full(self, t0, t1, u0):
        raise NotImplementedError

    def run_G_full(self, t0, t1, u0):
        raise NotImplementedError

    def run_F_timed(self, t0, t1, u0):
        return wall_timed(self.run_F)(t0, t1, u0)

    def run_G_timed(self, t0, t1, u0):
        return wall_timed(self.run_G)(t0, t1, u0)

    def run_F_full_timed(self, t0, t1, u0):
        return wall_timed(self.run_F_full)(t0, t1, u0)

    def run_G_full_timed(self, t0, t1, u0):
        return wall_timed(self.run_G_full)(t0, t1, u0)


def select_fine_mode(device, has_device_field):
    """Pick the fine fan-out for ``device``: 'cuda' (the f64 kernel) on a
    card, 'torch' (the plain f64 integrator) on the CPU.

    The port's counterpart of ``nngparareal_tpu/solver.py:select_fine_mode``.
    That one picks double-single ('ds', or 'pallas' for d >= 64) on a TPU,
    because the TPU has no f64 units: XLA emulates f64 in software, and
    compensated f32 pairs were faster there. An H100 has IEEE f64 units,
    so f64 is both the reference's arithmetic and the faster one, and
    'auto' never picks double-single here (``fine='ds'`` or ``'pallas'``
    asks for it). On a card a system without a device field has no
    fan-out: that raises rather than running the plain version on the
    main path."""
    if torch.device(device).type != "cuda":
        return "torch"
    if not has_device_field:
        raise NotImplementedError(
            "the CUDA fan-out kernel has no form of this system's field yet "
            "(ROADMAP.md, TPU kernels still to port, item 1); pass "
            "fine='torch' to run the plain integrator on the card"
        )
    return "cuda"


FINE_MODES = ("auto", "f64", "ds", "pallas", "cuda", "torch")


class RKSolver(SolverAbstr):
    def __init__(self, f, Ng, Nf, G="RK1", F="RK4", thresh=int(1e7),
                 fine=None, device_field=None, device=None, fine_ds=None,
                 fine_pallas=False):
        """``fine``, the fine fan-out:

        * 'auto' (the default): ``select_fine_mode``, 'cuda' on a card and
          'torch' on the CPU;
        * 'f64': the same f64 fan-out ('auto' never picks anything else);
        * 'cuda': the f64 kernel (ops/rk_cuda.py), which needs
          ``device_field`` (``ode.get_device_field()``); on CPU tensors its
          wrapper takes its plain version;
        * 'torch': the plain f64 integrator of ``f``, on any device;
        * 'ds': the plain double-single integrator (ops/rk_ds.py) of
          ``fine_ds``, on any device, only when asked for;
        * 'pallas': the double-single kernel (ops/rk_cuda_ds.py), the
          counterpart of the JAX package's Pallas kernel; it needs
          ``fine_ds`` and ``device_field``, slices of one width and an
          autonomous field; on CPU tensors it takes its plain version.

        ``fine_ds`` is the double-single field
        (``ode.get_ds_vector_field()``); 'ds' and 'pallas' raise without
        it. ``fine_pallas=True`` with no ``fine`` means 'pallas', as in
        the JAX package. In the double-single modes the fine fan-out,
        ``run_F`` and ``fine_step_raw`` compute in double-single; the
        trajectories and every coarse solve stay f64."""
        self.f = f
        self.Ng = int(Ng)
        self.Nf = int(Nf)
        self.G = get_tableau(G)
        self.F = get_tableau(F)
        self.thresh = int(thresh)
        self.device = resolve_device(device)
        self.device_field = device_field
        self.fine_ds = fine_ds
        if fine is None:
            fine = "pallas" if fine_pallas else "auto"
        if fine not in FINE_MODES:
            raise ValueError(f"fine={fine!r}")
        if fine in ("ds", "pallas") and fine_ds is None:
            raise ValueError(f"fine={fine!r} requires fine_ds "
                             "(ode.get_ds_vector_field())")
        if fine in ("auto", "f64"):
            fine = select_fine_mode(self.device, device_field is not None)
        if fine in ("cuda", "pallas") and device_field is None:
            raise ValueError(f"fine={fine!r} requires device_field")
        self.fine = fine
        self.fine_pallas = fine == "pallas"
        # the coarse solves through the f64 kernel: an ODE field on a card
        self.coarse_kernel = (fine in ("cuda", "pallas")
                              and self.device.type == "cuda"
                              and isinstance(device_field, rk_cuda.OdeField))
        self._coarse_bounds = {}

        self._coarse_last = make_last_integrator(f, self.G, self.Ng,
                                                 self.thresh)
        self._fine_last = make_last_integrator(f, self.F, self.Nf, self.thresh)
        # the fan-out of every mode but 'cuda' (which fine_batch_raw calls
        # itself)
        if fine == "ds":
            self._fine_fanout = make_batched_last_integrator_ds(
                fine_ds, self.F, self.Nf, self.thresh)
        elif fine == "pallas":
            self._fine_fanout = make_cuda_fanout_ds(fine_ds, self.F, self.Nf,
                                                    device_field)
        else:
            self._fine_fanout = make_batched_last_integrator(
                f, self.F, self.Nf, self.thresh)
        self._fine_traj = make_traj_integrator(f, self.F, self.Nf)
        self._coarse_traj = make_traj_integrator(f, self.G, self.Ng)

    def prepare(self):
        """Build the fine kernels now (outside any timed region): both
        libraries, the f64 fan-out's and the double-single one's."""
        if self.fine in ("cuda", "pallas") and self.device.type == "cuda":
            rk_cuda.build()

    def _t(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    # --- single-slice API ---

    def run_F(self, t0, t1, u0):
        u0 = self._t(u0)
        if self.fine != "torch":
            return self.run_F_batch(self._t([t0]), self._t([t1]), u0[None])[0]
        return self._fine_last(t0, t1, u0)

    def run_G(self, t0, t1, u0):
        return self._coarse_last(t0, t1, self._t(u0))

    def run_F_full(self, t0, t1, u0):
        """The fine trajectory of one slice, (Nf+1, d), as torch ops on the
        solver's device (the kernel keeps no trajectory); with (B, 1) t0
        and t1 and a (B, d) u0, (Nf+1, B, d). The bounds become tensors on
        the device first, so that the step width is divided there, as the
        batched fan-out divides it."""
        return self._fine_traj(self._t(t0), self._t(t1), self._t(u0))

    def run_G_full(self, t0, t1, u0):
        """The coarse trajectory, (Ng+1, d), as ``run_F_full``."""
        return self._coarse_traj(self._t(t0), self._t(t1), self._t(u0))

    def fine_step_raw(self, t0, dt_slice, u0):
        """One-slice fine solve as torch ops, in the solver's fine
        arithmetic: double-single in the 'ds' and 'pallas' modes (the
        kernel's plain arithmetic, as the JAX package's), f64 otherwise."""
        dt = dt_slice / self.Nf
        if self.fine in ("ds", "pallas"):
            uh, ul = ds32.ds_from_f64(u0)
            oh, ol = integrate_last_ds(self.fine_ds, self.F, t0, dt, self.Nf,
                                       uh, ul)
            return ds32.ds_to_f64(oh, ol)
        return integrate_last(self.f, self.F, t0, dt, self.Nf, u0)

    # --- batched API ---

    @torch.inference_mode()
    def run_F_batch(self, t0s, t1s, U):
        """Fine-solve all slices at once: (B,), (B,), (B, n) -> (B, n)."""
        return self.fine_batch_raw(self._t(t0s).contiguous(),
                                   self._t(t1s).contiguous(),
                                   self._t(U).contiguous())

    @torch.inference_mode()
    def fine_batch_raw(self, t0s, t1s, U):
        """``run_F_batch`` on the inputs' own device (f64, contiguous): the
        solver's fine arithmetic, the f64 kernel when ``fine`` is 'cuda'
        and the double-single kernel when it is 'pallas' (on a CPU tensor
        each takes its plain version), or the plain f64 or double-single
        integrator, wherever the batch lies. A device mesh runs each of its
        blocks through it (``parallel/mesh.py:shard_fine_fanout``): a
        slice is integrated alone, so the blocks give the unsharded
        values."""
        if self.fine == "cuda":
            return rk_cuda.rk_fanout(t0s, t1s, U, self.F, self.Nf,
                                     self.device_field, self.f)
        return self._fine_fanout(t0s, t1s, U)

    def coarse_step_raw(self, t0, dt_slice, u0):
        """One-slice coarse solve (called by the corrector sweep).

        Through the kernel, the slice runs from 0 to dt_slice (the fields
        are autonomous), so that its step is dt_slice / Ng as in the torch
        integrator; those bounds are made on the card once per dt_slice."""
        if not self.coarse_kernel:
            dt = dt_slice / self.Ng
            return integrate_last(self.f, self.G, t0, dt, self.Ng, u0)
        bounds = self._coarse_bounds.get(dt_slice)
        if bounds is None:
            bounds = self._coarse_bounds[dt_slice] = (
                self._t([0.0]), self._t([dt_slice]))
        return rk_cuda.rk_fanout(*bounds, u0[None], self.G, self.Ng,
                                 self.device_field, self.f)[0]

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


class ScipySolver(SolverAbstr):
    """Adaptive scipy fine solver for host-side validation: each fine
    solve is ``scipy.integrate.solve_ivp`` on the host, one slice after
    another, its field evaluated through torch (on ``device``, one round
    trip per evaluation); Nf is a soft limit. The coarse solves delegate
    to an ``RKSolver`` with the plain integrator on ``device``, and the
    results come back as tensors there."""

    _MAP = {"RK2": "RK23", "RK4": "RK45", "RK8": "DOP853"}

    def __init__(self, f, Ng, Nf, G="RK1", F="RK45", device=None, **kwargs):
        self.f = f
        self.Ng = int(Ng)
        self.Nf = int(Nf)
        self.F = self._MAP.get(str(F).upper(), F)
        self.kwargs = kwargs
        self.device = resolve_device(device)
        self.rk = RKSolver(f, Ng, Nf, G=G, F="RK4", fine="torch",
                           device=self.device)
        self._f_np = numpy_field(f, self.device)

    def prepare(self):
        return None

    def run_F(self, t0, t1, u0):
        from scipy.integrate import solve_ivp

        t0, t1 = float(t0), float(t1)
        u0 = torch.as_tensor(u0, dtype=torch.float64).cpu().numpy()
        res = solve_ivp(
            self._f_np, [t0, t1], u0, method=self.F, t_eval=(t1,),
            max_step=(t1 - t0) / self.Nf, **self.kwargs,
        )
        if res.nfev > self.Nf * 1.5:
            print(
                f"Warning: F solver did {res.nfev / self.Nf:0.1f}x more steps "
                "than expected"
            )
        return torch.as_tensor(res.y.reshape(-1), device=self.device)

    def run_G(self, t0, t1, u0):
        return self.rk.run_G(t0, t1, u0)

    def run_F_batch(self, t0s, t1s, U):
        """The fine solves of all slices, one after another on the host."""
        t0s = torch.as_tensor(t0s, dtype=torch.float64).cpu().numpy()
        t1s = torch.as_tensor(t1s, dtype=torch.float64).cpu().numpy()
        U = torch.as_tensor(U, dtype=torch.float64).cpu()
        return torch.stack([self.run_F(a, b, u)
                            for a, b, u in zip(t0s, t1s, U)])

    def run_G_chain(self, t, u0):
        return self.rk.run_G_chain(t, u0)

    def coarse_step_raw(self, t0, dt_slice, u0):
        return self.rk.coarse_step_raw(t0, dt_slice, u0)

    def fine_step_raw(self, t0, dt_slice, u0):
        return self.rk.fine_step_raw(t0, dt_slice, u0)
