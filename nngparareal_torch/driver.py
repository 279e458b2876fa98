"""The parareal orchestrator (predictor-corrector sweep over time slices).

Port of ``nngparareal_tpu/driver.py:Parareal``. Each iteration does:

1. **fine fan-out** over the unconverged slices [I, N): one call of the
   solver's batched fine integrator (the CUDA kernel on a card); with
   ``run(mesh=...)`` the slices split into contiguous blocks over the
   mesh's devices (``parallel/mesh.py``), padded to a whole number of
   blocks by repeating the last slice, each block run by the solver's own
   fine arithmetic on its device;
2. **data append**: freeze slice I+1 and write the iteration's (state,
   defect) rows into the padded dataset, in place;
3. **corrector sweep** ``u_{i+1} = model(u_i) + G(u_i)`` over the intervals
   [I, N): a host loop that queues each interval's coarse step and model
   prediction on the device without waiting for it. The card is waited
   for at the convergence check (and, with the Nelder-Mead search, after
   each of its graph replays; in ``sync_mode="attrib"``, after the
   fan-out).

With ``debug`` (set by ``comp_models``) each iteration also integrates
every slice from the new iterate with one fine fan-out (the truth), and
records the corrected predictions' errors against it; each shadow model
of ``comp_models`` is fitted on the same dataset, draws its own
``sweep_aux`` and predicts every active interval after the sweep, its
errors going to ``debug_dict["err_store_mdls"]`` (the harness of the
reference's Figure 2).

The convergence bookkeeping (prefix freeze, err columns, early stop, the
finite guards and the iterate clipping) follows the JAX package exactly:
its iterations-to-convergence K are the acceptance oracle.

The loop takes the JAX package's options, with its defaults: ``cap_iters``
(the dataset's first capacity, in iterations), ``lag_k`` (the fit and the
sweep see only the rows of the last ``lag_k`` iterations, the dataset
keeps growing), ``clip_iterates``, ``int_name`` (the checkpoints'
directory and file names), a per-run ``verbose``, ``warmup``,
``sweep_mode`` and ``sync_mode``. Three of them map onto the port's one
sweep:

* ``sweep_mode`` ("auto", "scan", "host", "python"): the port has one
  sweep, a host loop that queues each interval's coarse step and
  prediction on the device (the JAX package's "host" sweep, un-jitted as
  its "python" one), whatever is asked; ``timings["sweep_mode"]`` records
  "host". The JAX package's "host_cpu" (the 5e-9 precision router that
  moves the sweep to the CPU's IEEE f64) is refused: the card's f64 is
  IEEE already.
* ``sync_mode``: "attrib" waits for the card after the fan-out and at the
  convergence check, so the fine, sweep and model times are each their
  own; "fast" drops the fan-out's wait and books the iteration's wall in
  ``fused_iter_t`` (the fine time then holds the launch alone), as the
  JAX package does; ``debug`` keeps "attrib". ``timings["sync_mode"]``
  records which ran.
* ``warmup``: the port builds one thing before the timed loop, the fine
  kernel (``solver.prepare()``), and always outside the timed region; the
  flag changes nothing.

With the nnGP's ``calc_detail_avg`` the sweep waits for the card after
each interval and records its wall (``timings["calc_detail_avg"]``).

``Parareal`` also keeps the JAX package's result surface: ``store``,
``build_cont_traj`` (every slice's fine trajectory, integrated as one
batch), ``clear_plot_obj`` and the reporting delegates ``print_times``,
``print_speedup``, ``plot`` and ``plot_all_err`` (reporting.py).
``PararealLight`` keeps no history and refuses checkpoints, as the JAX
package's does.

``mesh`` also reaches GParareal, which shards its grid search's task pool
over the same devices. With a mesh each block runs the solver's own fine
arithmetic (``RKSolver.fine_batch_raw``), f64 or double-single
(``fine='ds'`` or ``'pallas'``), as the JAX package threads its resolved
fine arithmetic into each shard. Left out: the "host_cpu" sweep (above),
its AOT/compile-cache machinery (torch has no compile step here; its
power-of-two fan-out buckets with it: the kernel takes any batch), and
the routing of the time-augmented nnGP's sweep to the CPU (a workaround
for a TPU toolchain fault).
"""

import os
import pickle
import time

import numpy as np
import torch

from nngparareal_torch.convert import from_jax_checkpoint, load_checkpoint
from nngparareal_torch.models import (
    ELM, BareParareal, Dataset, GParareal, GPScipy, KNNMean, NNGParareal,
    NNGPScipy, NNGPTime,
)
from nngparareal_torch.models.base import ModelBase
from nngparareal_torch.parallel.mesh import shard_fine_fanout
from nngparareal_torch.solver import SolverAbstr
from nngparareal_torch.systems.base import ODE
from nngparareal_torch.utils.device import resolve_device
from nngparareal_torch.utils.timing import _block, wall_timed

# run() keywords that configure each model; the union is taken out of
# run()'s keywords, each model gets its own, and the rest go to the loop
_NNGP_KEYS = ("nn", "n_restarts", "seed", "fatol", "xatol", "nm_max_iters",
              "optimizer", "posterior", "grid_refine", "grid_walk",
              "grid_polish", "score_dtype", "strategy", "calc_detail_avg")
_GP_KEYS = ("theta", "seed", "fatol", "xatol", "nm_max_iters", "optimizer",
            "score_dtype", "grid_chunk", "grid_task_chunk", "grid_logs",
            "score_lanes", "alpha_res_tol", "fit_rows_cap", "score_rows_cap")
_GP_SCIPY_KEYS = ("theta", "seed", "fatol", "xatol")
_NNGP_SCIPY_KEYS = ("nn", "n_restarts", "seed", "fatol", "xatol")
_NNGP_TIME_KEYS = ("nn", "n_restarts", "seed", "fatol", "xatol",
                   "nm_max_iters", "nn_iters", "reps")
_ELM_KEYS = ("seed", "res_size", "loss", "M", "R", "alpha", "degree", "m")
_MODEL_KEYS = tuple(dict.fromkeys(_NNGP_KEYS + _GP_KEYS + _NNGP_TIME_KEYS
                                  + _ELM_KEYS))
# the model names of the JAX package's _make_model: (names, class, its
# keywords, its defaults)
_MODELS = (
    (("parareal",), BareParareal, (), {}),
    (("nngp", "nngparareal"), NNGParareal, _NNGP_KEYS, {}),
    (("gpjax", "gp", "gparareal"), GParareal, _GP_KEYS, {}),
    (("gpjax_scipy", "gp_oracle"), GPScipy, _GP_SCIPY_KEYS, {}),
    (("nngp_scipy", "nngp_oracle"), NNGPScipy, _NNGP_SCIPY_KEYS, {}),
    (("nngp_time", "nngptime"), NNGPTime, _NNGP_TIME_KEYS, {}),
    (("knn_mean", "nn_mean", "knnmean"), KNNMean, ("nn",), {}),
    (("elm",), ELM, _ELM_KEYS, {"seed": 47}),
)
MODEL_NAMES = tuple(name for names, *_ in _MODELS for name in names)
SWEEP_MODES = ("auto", "scan", "host", "python")
SYNC_MODES = ("attrib", "fast")
# a run's verbose, when it is not given: the instance's
_OWN = object()


def _aux_to(aux, dev):
    """A model's ``sweep_aux`` draw (an array, a dict of arrays or None)
    as f64 tensors on ``dev``: one copy per entry per sweep."""
    if aux is None:
        return None
    if isinstance(aux, dict):
        return {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
                for k, v in aux.items()}
    return torch.as_tensor(aux, dtype=torch.float64, device=dev)


def _aux_row(aux, i):
    """Interval i's row of a sweep's draw (of each entry of a dict)."""
    if aux is None:
        return None
    if isinstance(aux, dict):
        return {k: v[i] for k, v in aux.items()}
    return aux[i]


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
        self.f = ode.get_vector_field()
        self.u0 = ode.get_init_cond()
        # each run's output by its model's name (or ``cstm_mdl_name``)
        self.runs = {}
        # the fine solve over the whole span and its seconds, filled in by
        # print_times
        self.fine = None
        self.fine_t = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def run(self, model="parareal", cstm_mdl_name=None, add_model=False,
            **kwargs):
        """Run to convergence (or ``early_stop`` iterations); returns the
        JAX package's result dict: t, u, err, x, D, k, timings,
        debug_dict, converged, conv_int (and u_hist with
        ``keep_history``; the model as ``mdl`` with ``add_model``). The
        result is also kept in ``self.runs`` under ``cstm_mdl_name`` or
        the model's name. A run's ``verbose`` holds for this line too
        (the JAX package's run() prints it by the instance's)."""
        mdl = self._make_model(model, kwargs)
        s_time = time.perf_counter()
        out = self._parareal(mdl, **kwargs)
        out["timings"]["total_wall"] = time.perf_counter() - s_time
        out["timings"]["runtime"] = out["timings"]["core_t"]
        if kwargs.get("verbose", self.verbose) == "v":
            print(f"Elapsed Parareal time: {out['timings']['runtime']:0.2f}s")
        if add_model:
            out["mdl"] = mdl
        self.runs[mdl.name if cstm_mdl_name is None else cstm_mdl_name] = out
        return out

    def _make_model(self, model, kwargs):
        """The model for ``model`` (a ModelBase, or its name), taking the
        model's keywords out of ``kwargs``."""
        kw = {k: kwargs.pop(k) for k in _MODEL_KEYS if k in kwargs}
        if isinstance(model, ModelBase):
            return model
        key = str(model).lower()
        for names, cls, keys, defaults in _MODELS:
            if key in names:
                # the JAX package drops the keywords a model does not take
                own = {k: v for k, v in kw.items() if k in keys}
                if cls is GParareal:
                    # run(mesh=...) also shards its grid search's task pool
                    own["mesh"] = kwargs.get("mesh")
                return cls(n=self.n, N=self.N, **{**defaults, **own})
        raise ValueError(f"Unknown model {model!r}")

    def _shadows(self, comp_models):
        """[name, model] of each shadow: a model instance (its name), a
        model name (that name), or (name, keywords), named by the keyword
        ``cstm_name`` or "name:model name"."""
        shadows = []
        for spec in comp_models:
            if isinstance(spec, ModelBase):
                shadows.append([spec.name, spec])
            elif isinstance(spec, str):
                shadows.append([spec, self._make_model(spec, {})])
            else:
                name, skw = spec
                mdl = self._make_model(name, dict(skw))
                shadows.append([skw.get("cstm_name", f"{name}:{mdl.name}"),
                                mdl])
        return shadows

    # ------------------------------------------------------------------
    # the fine fan-out
    # ------------------------------------------------------------------

    def _make_fanout(self, mesh):
        """(t0s, t1s, U) -> the fine endpoints of every slice: the solver's
        ``run_F_batch``, or with a mesh its ``fine_batch_raw`` over the
        mesh's blocks. A batch that does not divide over the mesh is padded
        by repeating its last slice (the pad may exceed the batch) and the
        result cut back to it."""
        solver = self.solver
        if mesh is None:
            return solver.run_F_batch
        first = mesh.devices[0]
        if first != self.device:
            raise ValueError(f"the mesh's first device ({first}) must be the "
                             f"run's device ({self.device}): the blocks "
                             f"gather there")
        if not hasattr(solver, "fine_batch_raw"):
            raise ValueError(f"mesh= needs a solver with fine_batch_raw (an "
                             f"RKSolver), not {type(solver).__name__}")
        sharded = shard_fine_fanout(solver.fine_batch_raw, mesh)
        ndev = mesh.devices.size

        def fanout(t0s, t1s, U):
            t0s, t1s, U = (solver._t(x).contiguous() for x in (t0s, t1s, U))
            B = int(U.shape[0])
            pad = (-B) % ndev
            if pad:
                t0s = torch.cat([t0s, t0s[-1:].expand(pad)])
                t1s = torch.cat([t1s, t1s[-1:].expand(pad)])
                U = torch.cat([U, U[-1:].expand(pad, -1)])
            out = sharded(t0s, t1s, U)
            return out[:B] if pad else out

        return fanout

    # ------------------------------------------------------------------
    # the corrector sweep
    # ------------------------------------------------------------------

    def _sweep(self, model, ds, I, u_init, uG_init, uF, uG, u_prev, clip,
               aux=None):
        """Sequential corrector over the intervals [I, N).

        Frozen intervals keep u_init/uG_init; interval i's model gets row
        i of ``aux`` (the iteration's draw, already on the device). Every op
        is queued on the device; nothing here reads a value back to the
        host, apart from what the model reads itself (the Nelder-Mead
        search's convergence checks) and, with the model's
        ``calc_detail_avg``, a wait for the card after each interval to
        record its wall.
        """
        record = (model.record_interval_time
                  if getattr(model, "calc_detail_avg", False) else None)
        solver = self.solver
        N = self.N
        t0_glob = self.tspan[0]
        dt_slice = (self.tspan[1] - self.tspan[0]) / N
        u_rows = [u_init[i] for i in range(I + 1)]
        uG_rows = [uG_init[i] for i in range(I + 1)]
        for i in range(I, N):
            tic = time.perf_counter()
            u_i = u_rows[i]
            uF_ip1, uG_ip1 = uF[i + 1], uG[i + 1]
            uGn = solver.coarse_step_raw(t0_glob + i * dt_slice, dt_slice, u_i)
            pred = model.predict_fn(ds, u_i, uF_ip1, uG_ip1, i,
                                    aux_i=_aux_row(aux, i))
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
            if record is not None:
                _block(u_ip1)
                record(i, time.perf_counter() - tic)
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

    @staticmethod
    def _windowed_valid(valid, N, k, I, lag_k):
        """The lag_k training window: keep only the rows of iterations
        [k+1-lag_k, k] whose slice is >= I (row kk*N + i holds slice i of
        iteration kk)."""
        idx = torch.arange(valid.shape[0], device=valid.device)
        kk = idx // N
        keep = ((kk >= max(k + 1 - lag_k, 0)) & (kk <= k)
                & (idx % N >= I))
        return valid * keep.to(valid.dtype)

    @torch.inference_mode()
    def _parareal(
        self,
        model,
        early_stop=None,
        store_int=False,
        keep_history=False,
        debug=False,
        cap_iters=None,
        mesh=None,
        warmup=True,
        measure_serial_fine=True,
        lag_k=None,
        sweep_mode="auto",
        sync_mode="attrib",
        clip_iterates=True,
        comp_models=None,
        int_dir="",
        int_name=None,
        verbose=_OWN,
        _resume=None,
    ):
        if sweep_mode == "host_cpu":
            raise ValueError(
                "sweep_mode='host_cpu' moves the JAX package's sweep to the "
                "CPU's IEEE f64 because the TPU's f64 is emulated; the "
                "card's f64 is IEEE, so the port has no such route")
        if sweep_mode not in SWEEP_MODES:
            raise ValueError(f"sweep_mode={sweep_mode!r}; known: "
                             f"{list(SWEEP_MODES)}")
        if sync_mode not in SYNC_MODES:
            raise ValueError(f"sync_mode={sync_mode!r}; known: "
                             f"{list(SYNC_MODES)}")
        N, n, eps = self.N, self.n, self.epsilon
        verbose = self.verbose if verbose is _OWN else verbose
        solver = self.solver
        dev = self.device
        t_np = np.linspace(self.tspan[0], self.tspan[1], N + 1)
        t = torch.as_tensor(t_np, dtype=torch.float64, device=dev)

        fanout = self._make_fanout(mesh)
        shadows = self._shadows(comp_models or ())
        debug = debug or bool(shadows)
        # 'fast': the fan-out is not waited for; the iteration's one wait
        # is the convergence check's
        fast_sync = sync_mode == "fast" and not debug
        shadow_errs = {name: [] for name, _ in shadows}
        mean_errs, max_errs, one_step_error, all_pred_err = [], [], [], []
        collect_data = model.needs_dataset or bool(shadows)
        cap0 = N * max(1, min(N, 32 if cap_iters is None else int(cap_iters)))
        ds = Dataset.empty(cap0 if collect_data else N, n, device=dev)
        u0 = self.u0

        # trajectory-informed iterate bounds: the coarse-init range with a
        # 3x margin (garbage iterates far outside it would blow up both
        # solvers)
        clip = None
        if clip_iterates:
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
        fused_iter_t = 0.0

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
            if fast_sync and measure_serial_fine and per_slice_fine_t is None:
                # before the fan-out, or its waits would land in the
                # iteration's wall
                per_slice_fine_t = self._measure_serial_fine(t_np, u[0])
            iter_tic = time.perf_counter()
            sub = fanout(t[I:N], t[I + 1:N + 1], u[I:N])
            if not fast_sync:
                _block(sub)
            F_time += time.perf_counter() - iter_tic
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

            # --- 3. model fit, on the lag_k window when one is set ---
            ds_fit = ds
            if lag_k is not None and collect_data:
                ds_fit = Dataset(ds.X, ds.D, self._windowed_valid(
                    ds.valid, N, k, I, int(lag_k)))
            tic = time.perf_counter()
            model.fit(ds_fit, k)
            model.add_train_time(k, time.perf_counter() - tic)

            # --- 4. corrector sweep ---
            # the model's draw for this sweep (the Nelder-Mead starts of
            # every interval), copied to the device once
            aux = _aux_to(model.sweep_aux(k, N, ds.capacity), dev)
            tic = time.perf_counter()
            u_next, uG_next, err_dev = self._sweep(
                model, ds_fit, I, u_init, uG_init, uF, uG, u, clip, aux)
            # the wait at the convergence check: err goes to the host
            err = err_dev.cpu().numpy()
            dt_sweep = time.perf_counter() - tic
            if fast_sync:
                fused_iter_t += time.perf_counter() - iter_tic
            else:
                sweep_time += dt_sweep
                # attribute the sweep wall between the coarse chain and the
                # model: estimate G from the measured init chain, prorated
                # by the active-slice fraction
                g_est = g_chain_t * (N - I) / N
                G_time += g_est
                model.add_pred_time(k, max(0.0, dt_sweep - g_est),
                                    n_active=N - I)

            # --- debug: the predictions' errors against the truth ---
            if debug:
                truth, pe = self._debug_errors(t, I, u_next, fanout)
                mean_errs.append(pe.mean(axis=0))
                max_errs.append(pe.max(axis=0))
                all_pred_err.append(pe)
                if verbose == "v":
                    print(f"Avg error {pe.mean(axis=0)}, Max. error "
                          f"{pe.max(axis=0)}")
                for name, mdl in shadows:
                    shadow_errs[name].append(self._shadow_errors(
                        mdl, ds_fit, k, I, u_next, uF, uG, uG_next, truth))

            # --- 5. convergence check + prefix freeze ---
            if np.isnan(err).any():
                raise Exception(
                    "NaN values in initial coarse solve - increase Ng!"
                )
            if debug:
                one_step_error.append([err[I + 1],
                                       float(np.max(all_pred_err[-1]))])
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
                    int_name,
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
            "warmup_split": {"fine_build": warmup_t},
            # wall clock of the solve proper: coarse init + k-loop,
            # excluding the one-off serial-fine measurement
            "core_t": time.perf_counter() - core_t0 - (per_slice_fine_t or 0.0),
            # 'attrib': the fan-out and the sweep waited for, each split its
            # own; 'fast': one wait an iteration, its wall in fused_iter_t
            "sync_mode": "fast" if fast_sync else "attrib",
            "fused_iter_t": fused_iter_t,
            # the port's one sweep, whatever sweep_mode asked (see above)
            "sweep_mode": "host",
        }
        timings.update(model.get_times())
        if fast_sync:
            timings["overhead_t"] = max(
                0.0, timings["core_t"] - g_chain_t - fused_iter_t)
        else:
            timings["overhead_t"] = max(
                0.0,
                timings["core_t"] - F_time - g_chain_t - sweep_time
                - timings["mdl_train_t"],
            )

        debug_dict = {}
        if debug:
            debug_dict = {
                "one_step_error": np.array(one_step_error),
                "all_pred_err": all_pred_err,
                "mean_errs": mean_errs,
                "max_errs": max_errs,
            }
            if shadows:
                debug_dict["err_store_mdls"] = shadow_errs

        out = {
            "t": t_np,
            "u": u.cpu().numpy(),
            "err": err_arr,
            "x": x_out,
            "D": D_out,
            "k": k_done,
            "timings": timings,
            "debug_dict": debug_dict,
            "converged": converged,
            "conv_int": conv_int,
        }
        if keep_history:
            out["u_hist"] = np.stack(hist_u, axis=2)
        return out

    def _debug_errors(self, t, I, u_next, fanout):
        """The truth, every slice fine-integrated from the new iterate in
        one fan-out (the run's: over the mesh when it has one), (N, n) on
        the device; and |truth - u_next| of the active intervals [I, N) on
        the host."""
        truth = fanout(t[:-1], t[1:], u_next[:-1])
        return truth, torch.abs(truth - u_next[1:])[I:].cpu().numpy()

    def _shadow_errors(self, mdl, ds, k, I, u_next, uF, uG, uG_next, truth):
        """A shadow model fitted on the iteration's dataset, with its own
        draw, predicting each active interval from the new iterate: the
        error |pred + uG_next - truth| of intervals [I, N)."""
        mdl.fit(ds, k)
        aux = _aux_to(mdl.sweep_aux(k, self.N, ds.capacity), self.device)
        preds = torch.stack([
            mdl.predict_fn(ds, u_next[i], uF[i + 1], uG[i + 1], i,
                           aux_i=_aux_row(aux, i))
            for i in range(I, self.N)])
        return torch.abs(preds + uG_next[I + 1:] - truth[I:]).cpu().numpy()

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
        G_time, F_time, F_time_serial, sweep_time, int_dir="", int_name=None,
    ):
        name_base = int_name or f"{self.ode_name}_{self.N}_{model.name}_int"
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

    def load_int_dump(self, ckpt_path, model="parareal", cstm_mdl_name=None,
                      **kwargs):
        """Resume a run from a per-iteration checkpoint file, written by
        this package or by the JAX package. ``model`` is a model's name
        (built with the run's keywords) or a model instance, taken as it
        is. The resumed run is returned and kept in ``self.runs`` under
        ``cstm_mdl_name`` or the model's name, as ``run`` keeps it."""
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
        self.runs[mdl.name if cstm_mdl_name is None else cstm_mdl_name] = out
        return out

    # ------------------------------------------------------------------
    # results: trajectories, artifacts, reporting (reporting.py)
    # ------------------------------------------------------------------

    def build_cont_traj(self, key=None):
        """Every slice's fine trajectory from a run's iterates, stacked:
        (N * (Nf + 1), d) as a numpy array, slice i's rows starting at u[i].
        ``key``: None (the one stored run), a run's name, or a dict with
        ``t`` and ``u``. The N slices are integrated as one batch
        (``solver.run_F_full`` with (N, 1) bounds), each slice's rows
        equal to its own one-slice trajectory."""
        if key is None:
            if len(self.runs) != 1:
                raise Exception("Multiple runs, must specify key")
            key = list(self.runs.keys())[0]
        if isinstance(key, dict) and "t" in key and "u" in key:
            t, u = key["t"], key["u"]
        else:
            t, u = self.runs[key]["t"], self.runs[key]["u"]
        t = torch.as_tensor(np.asarray(t), dtype=torch.float64,
                            device=self.device)
        u = torch.as_tensor(np.asarray(u), dtype=torch.float64,
                            device=self.device)
        N = self.N
        with torch.inference_mode():
            traj = self.solver.run_F_full(t[:N, None], t[1:N + 1, None], u[:N])
        return traj.transpose(0, 1).reshape(-1, traj.shape[-1]).cpu().numpy()

    def store(self, name, path="", slim=False):
        """Pickle this solver's runs (numpy data) with the run's identity
        and ``fine_t`` under ``path/name``; ``slim`` drops each run's bulky
        arrays (``utils/io.py:slim_run``). Returns the payload."""
        from nngparareal_torch.utils.io import slim_run, store_pickle

        runs = {k: (slim_run(v) if slim else v) for k, v in self.runs.items()}
        payload = {
            "ode_name": self.ode_name,
            "tspan": self.tspan,
            "N": self.N,
            "epsilon": self.epsilon,
            "n": self.n,
            "runs": runs,
            "fine_t": self.fine_t,
        }
        store_pickle(payload, name, path)
        return payload

    def clear_plot_obj(self):
        self.runs = {}

    def print_times(self, *args, **kwargs):
        from nngparareal_torch.reporting import print_times

        return print_times(self, *args, **kwargs)

    def print_speedup(self, *args, **kwargs):
        from nngparareal_torch.reporting import print_speedup

        return print_speedup(self, *args, **kwargs)

    def plot(self, *args, **kwargs):
        from nngparareal_torch.reporting import plot_run

        return plot_run(self, *args, **kwargs)

    def plot_all_err(self, *args, **kwargs):
        from nngparareal_torch.reporting import plot_all_err

        return plot_all_err(self, *args, **kwargs)


class PararealLight(Parareal):
    """``Parareal`` without history and checkpoints, as the JAX package's
    (its state is already O(N n)): ``keep_history`` is forced off, and
    ``store_int`` and ``load_int_dump`` raise."""

    def _parareal(self, model, **kwargs):
        kwargs["keep_history"] = False
        if kwargs.get("store_int"):
            raise NotImplementedError(
                "PararealLight does not support storing intermediate results"
            )
        return super()._parareal(model, **kwargs)

    def load_int_dump(self, *args, **kwargs):
        raise NotImplementedError(
            "PararealLight does not support loading from intermediate dumps"
        )
