"""The parareal orchestrator (predictor-corrector sweep over time slices).

Port of ``nngparareal_tpu/driver.py:Parareal``. Each iteration does:

1. **fine fan-out** over the unconverged slices [I, N): one call of the
   solver's batched fine integrator (the CUDA kernel on a card);
2. **data append**: freeze slice I+1 and write the iteration's (state,
   defect) rows into the padded dataset, in place;
3. **corrector sweep** ``u_{i+1} = model(u_i) + G(u_i)`` over the intervals
   [I, N): a host loop that queues each interval's coarse step and model
   prediction on the device without waiting for it. The card is waited
   for once per iteration, at the convergence check.

The convergence bookkeeping (prefix freeze, err columns, early stop, the
finite guards and the iterate clipping) follows the JAX package exactly:
its iterations-to-convergence K are the acceptance oracle.

Left out: the JAX package's AOT/compile-cache machinery (torch has no
compile step here), its power-of-two fan-out buckets (the kernel takes
any batch, and frozen slices would recompute the same values), the 5e-9
``host_cpu`` router (the H100 has IEEE f64), mesh sharding, and the
debug/shadow-model harness, and the options no caller here sets.
"""

import os
import pickle
import time

import numpy as np
import torch

from nngparareal_torch.convert import from_jax_checkpoint, load_checkpoint
from nngparareal_torch.models import BareParareal, Dataset, NNGParareal
from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.solver import SolverAbstr
from nngparareal_torch.systems.base import ODE
from nngparareal_torch.utils.device import resolve_device
from nngparareal_torch.utils.timing import wall_timed

# run() keywords that configure the model; the rest go to the loop
_MODEL_KEYS = ("nn", "seed", "optimizer")


class Parareal:
    """Parareal(ode, solver, tspan, N, epsilon).run(model=..., ...)."""

    def __init__(self, ode, solver, tspan, N, epsilon=5e-7, verbose="v",
                 device=None):
        if not isinstance(ode, ODE):
            raise Exception("ode must be an instance of the ODE class")
        if not isinstance(solver, SolverAbstr):
            raise Exception("solver must be an instance of SolverAbstr")
        self.device = resolve_device(device)
        if solver.device != self.device or ode.device != self.device:
            raise ValueError(
                f"ode ({ode.device}), solver ({solver.device}) and Parareal "
                f"({self.device}) must share one device"
            )
        self.ode = ode
        self.solver = solver
        self.tspan = tuple(float(x) for x in tspan)
        self.N = int(N)
        self.epsilon = float(epsilon)
        self.verbose = verbose
        self.ode_name = ode.name
        self.n = ode.get_dim()
        self.u0 = ode.get_init_cond()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def run(self, model="parareal", **kwargs):
        """Run to convergence (or ``early_stop`` iterations); returns the
        JAX package's result dict: t, u, err, x, D, k, timings, converged,
        conv_int (and u_hist with ``keep_history``)."""
        mdl = self._make_model(model, kwargs)
        s_time = time.perf_counter()
        out = self._parareal(mdl, **kwargs)
        out["timings"]["total_wall"] = time.perf_counter() - s_time
        out["timings"]["runtime"] = out["timings"]["core_t"]
        if self.verbose == "v":
            print(f"Elapsed Parareal time: {out['timings']['runtime']:0.2f}s")
        return out

    def _make_model(self, model, kwargs):
        """The model for ``model`` (a ModelBase, or its name), taking the
        model's keywords out of ``kwargs``."""
        kw = {k: kwargs.pop(k) for k in _MODEL_KEYS if k in kwargs}
        if isinstance(model, ModelBase):
            return model
        key = str(model).lower()
        if key == "parareal":
            return BareParareal(n=self.n, N=self.N)
        if key in ("nngp", "nngparareal"):
            return NNGParareal(n=self.n, N=self.N, **kw)
        raise NotImplementedError(
            f"model {model!r} is not ported yet (ROADMAP.md, modules still "
            "to port)"
        )

    # ------------------------------------------------------------------
    # the corrector sweep
    # ------------------------------------------------------------------

    def _sweep(self, model, ds, I, u_init, uG_init, uF, uG, u_prev, clip):
        """Sequential corrector over the intervals [I, N).

        Frozen intervals keep u_init/uG_init. Every op is queued on the
        device; nothing here reads a value back to the host.
        """
        solver = self.solver
        N = self.N
        t0_glob = self.tspan[0]
        dt_slice = (self.tspan[1] - self.tspan[0]) / N
        u_rows = [u_init[i] for i in range(I + 1)]
        uG_rows = [uG_init[i] for i in range(I + 1)]
        for i in range(I, N):
            u_i = u_rows[i]
            uF_ip1, uG_ip1 = uF[i + 1], uG[i + 1]
            uGn = solver.coarse_step_raw(t0_glob + i * dt_slice, dt_slice, u_i)
            pred = model.predict_fn(ds, u_i, uF_ip1, uG_ip1, i)
            # a GP prediction can come out non-finite when a near-singular
            # local Gram loses its Cholesky to rounding: fall back to the
            # classic parareal correction for those coordinates
            pred = torch.where(torch.isfinite(pred), pred, uF_ip1 - uG_ip1)
            u_ip1 = pred + uGn
            # a diverged coarse solve resets the iterate to the last fine
            # value: always finite, convergence merely slows
            u_ip1 = torch.where(torch.isfinite(u_ip1), u_ip1, uF_ip1)
            uGn = torch.where(torch.isfinite(uGn), uGn, uF_ip1 - pred)
            if clip is not None:
                u_ip1 = torch.clamp(u_ip1, clip[0], clip[1])
            u_rows.append(u_ip1)
            uG_rows.append(uGn)
        u_next = torch.stack(u_rows)
        uG_next = torch.stack(uG_rows)
        err = torch.amax(torch.abs(u_next - u_prev), dim=1)
        err[I] = 0.0
        return u_next, uG_next, err

    # ------------------------------------------------------------------
    # the main loop
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _parareal(
        self,
        model,
        early_stop=None,
        store_int=False,
        keep_history=False,
        measure_serial_fine=True,
        int_dir="",
        _resume=None,
    ):
        N, n, eps = self.N, self.n, self.epsilon
        verbose = self.verbose
        solver = self.solver
        dev = self.device
        t_np = np.linspace(self.tspan[0], self.tspan[1], N + 1)
        t = torch.as_tensor(t_np, dtype=torch.float64, device=dev)

        collect_data = model.needs_dataset
        cap0 = N * min(N, 32)
        ds = Dataset.empty(cap0 if collect_data else N, n, device=dev)
        u0 = self.u0

        # trajectory-informed iterate bounds: the coarse-init range with a
        # 3x margin (garbage iterates far outside it would blow up both
        # solvers)
        uG_probe = solver.run_G_chain(t, u0)
        lo = torch.amin(uG_probe, dim=0)
        hi = torch.amax(uG_probe, dim=0)
        rng_ = torch.clamp(hi - lo, min=1e-6)
        clip = (lo - 3.0 * rng_, hi + 3.0 * rng_)

        # build the fine kernel outside the timed loop
        _, warmup_t = wall_timed(solver.prepare)()
        core_t0 = time.perf_counter()

        G_time = 0.0
        F_time = 0.0
        F_time_serial = 0.0
        sweep_time = 0.0

        # --- coarse init chain ---
        uG, g_chain_t = wall_timed(solver.run_G_chain)(t, u0)
        G_time += g_chain_t
        u = uG
        uF = uG.clone()  # rows > I are overwritten by the first fan-out
        I = 0
        k_done = 0
        converged = False
        err_cols = []
        conv_int = []
        hist_u = []
        per_slice_fine_t = None

        loop_start = 0
        if _resume is not None:
            (u, uG, uF, I, loop_start, err_cols, conv_int, ds,
             G_time, F_time, F_time_serial, sweep_time) = _resume
            if I >= N:
                raise Exception("System has already converged")

        if keep_history:
            hist_u.append(u.cpu().numpy())

        for k in range(loop_start, N):
            if verbose == "v":
                print(f"{self.ode_name} {model.name} iteration number "
                      f"(out of {N}): {k + 1} ")

            # --- 1. fine fan-out over the unconverged slices [I, N) ---
            sub, dt_fine = wall_timed(solver.run_F_batch)(
                t[I:N], t[I + 1:N + 1], u[I:N])
            F_time += dt_fine
            uF[I + 1:N + 1] = sub

            if measure_serial_fine and per_slice_fine_t is None:
                per_slice_fine_t = self._measure_serial_fine(t_np, u[0])
            if per_slice_fine_t is not None:
                F_time_serial += per_slice_fine_t

            # --- 2. freeze slice I+1; append (state, defect) rows ---
            uG_init = uG
            if collect_data and (k + 1) * N > ds.capacity:
                ds = ds.grown(2 * ds.capacity)
            u_init = u.clone()
            u_init[I + 1] = uF[I + 1]
            if collect_data:
                valid_new = (torch.arange(N, device=dev) >= I).to(ds.valid.dtype)
                ds.append_(u[:-1], uF[1:] - uG[1:], valid_new, k * N)
            I += 1

            # --- early stop: only one interval was missing ---
            if I == N:
                if verbose == "v":
                    print("WARNING: early stopping")
                err = torch.amax(torch.abs(u_init - u), dim=1).cpu().numpy()
                err[-1] = np.nextafter(eps, 0)
                err_cols.append(err)
                conv_int.append(I)
                u = u_init
                k_done = k + 1
                converged = True
                if keep_history:
                    hist_u.append(u.cpu().numpy())
                break

            # --- 3. model fit ---
            tic = time.perf_counter()
            model.fit(ds, k)
            model.add_train_time(k, time.perf_counter() - tic)

            # --- 4. corrector sweep ---
            tic = time.perf_counter()
            u_next, uG_next, err_dev = self._sweep(
                model, ds, I, u_init, uG_init, uF, uG, u, clip)
            # the iteration's one wait on the device: err goes to the host
            err = err_dev.cpu().numpy()
            dt_sweep = time.perf_counter() - tic
            sweep_time += dt_sweep
            # attribute the sweep wall between the coarse chain and the
            # model: estimate G from the measured init chain, prorated by
            # the active-slice fraction
            g_est = g_chain_t * (N - I) / N
            G_time += g_est
            model.add_pred_time(k, max(0.0, dt_sweep - g_est), n_active=N - I)

            # --- 5. convergence check + prefix freeze ---
            if np.isnan(err).any():
                raise Exception(
                    "NaN values in initial coarse solve - increase Ng!"
                )
            for p in range(I + 1, N + 1):
                if err[p] < eps:
                    I += 1
                else:
                    break
            if verbose == "v":
                print("--> Converged:", I)
            err_cols.append(err)
            conv_int.append(I)

            u, uG = u_next, uG_next
            k_done = k + 1
            if keep_history:
                hist_u.append(u.cpu().numpy())

            if store_int:
                self._store_int(
                    model, k, I, u, uG, uF, err_cols, conv_int, ds,
                    G_time, F_time, F_time_serial, sweep_time, int_dir,
                )

            if I == N:
                converged = True
                break
            if early_stop is not None and k == early_stop - 1:
                if verbose == "v":
                    print("Early stopping due to user condition.")
                break

        # --- outputs ---
        err_arr = (np.stack(err_cols, axis=1) if err_cols
                   else np.zeros((N + 1, 0)))
        if collect_data:
            mask = ds.valid.cpu().numpy() > 0
            x_out = ds.X.cpu().numpy()[mask]
            D_out = ds.D.cpu().numpy()[mask]
        else:
            x_out = np.zeros((0, n))
            D_out = np.zeros((0, n))

        timings = {
            "F_time": F_time,
            "G_time": G_time,
            "G_init_time": g_chain_t,
            "sweep_time": sweep_time,
            "F_time_serial_avg": F_time_serial,
            # one-time kernel build
            "warmup_t": warmup_t,
            # wall clock of the solve proper: coarse init + k-loop,
            # excluding the one-off serial-fine measurement
            "core_t": time.perf_counter() - core_t0 - (per_slice_fine_t or 0.0),
        }
        timings.update(model.get_times())
        timings["overhead_t"] = max(
            0.0,
            timings["core_t"] - F_time - g_chain_t - sweep_time
            - timings["mdl_train_t"],
        )

        out = {
            "t": t_np,
            "u": u.cpu().numpy(),
            "err": err_arr,
            "x": x_out,
            "D": D_out,
            "k": k_done,
            "timings": timings,
            "converged": converged,
            "conv_int": conv_int,
        }
        if keep_history:
            out["u_hist"] = np.stack(hist_u, axis=2)
        return out

    def _measure_serial_fine(self, t, u0):
        """One-off per-slice fine-cost estimate: a replicated micro-batch,
        min of two reps."""
        bm = 8 if self.n >= 64 else 64
        args = (np.full(bm, t[0]), np.full(bm, t[1]), u0[None, :].expand(bm, -1))
        return min(wall_timed(self.solver.run_F_batch)(*args)[1]
                   for _ in range(2))

    # ------------------------------------------------------------------
    # checkpoint / resume (the JAX package's file layout)
    # ------------------------------------------------------------------

    def _store_int(
        self, model, k, I, u, uG, uF, err_cols, conv_int, ds,
        G_time, F_time, F_time_serial, sweep_time, int_dir,
    ):
        name_base = f"{self.ode_name}_{self.N}_{model.name}_int"
        path = os.path.join(int_dir, name_base)
        os.makedirs(path, exist_ok=True)
        payload = {
            "k": k,
            "I": I,
            "u": u.cpu().numpy(),
            "uG": uG.cpu().numpy(),
            "uF": uF.cpu().numpy(),
            "err_cols": [np.asarray(e) for e in err_cols],
            "conv_int": list(conv_int),
            "ds_X": ds.X.cpu().numpy(),
            "ds_D": ds.D.cpu().numpy(),
            "ds_valid": ds.valid.cpu().numpy(),
            "G_time": G_time,
            "F_time": F_time,
            "F_time_serial": F_time_serial,
            "sweep_time": sweep_time,
            "model_name": model.name,
            "model_state": model.get_ckpt_state(),
            "tspan": self.tspan,
            "N": self.N,
            "epsilon": self.epsilon,
            "ode_name": self.ode_name,
        }
        with open(os.path.join(path, f"{name_base}_{k}"), "wb") as fh:
            pickle.dump(payload, fh, pickle.HIGHEST_PROTOCOL)

    def load_int_dump(self, ckpt_path, model="parareal", **kwargs):
        """Resume a run from a per-iteration checkpoint file, written by
        this package or by the JAX package."""
        p = from_jax_checkpoint(load_checkpoint(ckpt_path), device=self.device)
        if p["ode_name"] != self.ode_name or p["N"] != self.N:
            raise Exception("Checkpoint does not match this Parareal instance")
        mdl = self._make_model(model, kwargs)
        if mdl.name != p["model_name"]:
            raise Exception(
                f"Checkpoint was written by model {p['model_name']}, got {mdl.name}"
            )
        mdl.set_ckpt_state(p["model_state"])
        base_time = p["G_time"] + p["F_time"] + mdl.get_times()["mdl_tot_t"]
        ds = Dataset(p["ds_X"], p["ds_D"], p["ds_valid"])
        resume = (
            p["u"], p["uG"], p["uF"], p["I"], p["k"] + 1,
            p["err_cols"], p["conv_int"], ds,
            p["G_time"], p["F_time"], p["F_time_serial"], p["sweep_time"],
        )
        s_time = time.perf_counter()
        out = self._parareal(mdl, _resume=resume, **kwargs)
        out["timings"]["runtime"] = time.perf_counter() - s_time + base_time
        return out
