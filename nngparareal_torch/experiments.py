"""Experiment drivers: the paper's setups with their exact hyperparameters.

Port of ``nngparareal_tpu/experiments.py``:

* ``run_hopf``    -- Hopf scalability (N in {32..512}, fine steps x10 000
                     paged in Nf/25 chunks, nnGP nn=15, two restarts);
* ``run_tomlab``  -- ThomasLabyrinth scalability (nnGP nn=18, fatol=xatol
                     =1e-3);
* ``run_burgers`` -- viscous Burgers d=N=128 over [0, T] (nnGP nn=18, seed
                     45): the flagship configuration of bench.py;
* ``run_fhn_pde`` -- the FHN 2D PDE d-scaling run (dx in {10..16}, N=512,
                     nnGP nn=20), with the scaling driver's fine step count
                     Nf = ceil(1e8 / Ng_tot) * Ng_tot / N
                     (``fhn_pde_parareal`` builds its Parareal);
* ``run_table2``  -- iterations to convergence of the paper's Table 2: six
                     ODE systems (FHN, Rossler, Hopf N=32, Brusselator,
                     Lorenz, DblPend) at their published configurations,
                     one after another or (``pool=k``) over k spawned
                     worker processes;
* ``run_burgers_across_m`` -- K against the neighbour count m, each seed
                     threaded into the nnGP's Nelder-Mead starts;
* ``main``        -- the command line: ``python -m
                     nngparareal_torch.experiments``.

The nnGP runs the JAX default search, Nelder-Mead, unless ``nngp_kw``
says otherwise (``dict(optimizer='grid')``); the port's ``run_table2``
takes ``nngp_kw`` as every other driver does. Each model runs in turn on
the card (``device=None``) or wherever ``device`` says; ``results_dir``
receives the pickled summary rows.

GParareal (``gpjax``, which ``MODELS_DEFAULT`` names) runs with the JAX
package's settings for each driver (``run_hopf``: theta [1, 1] and fatol =
xatol = 1e-6; ``run_tomlab``: 1e-1; ``run_table2``: 1e-6), overridden by
``gp_kw`` where the JAX driver takes it.

Every driver takes ``mesh`` (``parallel.make_mesh``): each run's fine
fan-out, and GParareal's grid search, split over its devices. The mesh's
first device must be the run's ``device``.
"""

import numpy as np
import torch

from nngparareal_torch.driver import MODEL_NAMES, Parareal
from nngparareal_torch.reporting import calc_speedup, est_serial
from nngparareal_torch.solver import RKSolver
from nngparareal_torch.systems import (
    FHNODE, Rossler, Hopf, DblPend, Brusselator, Lorenz, ThomasLabyrinth,
    FHNPDE, Burgers,
)
from nngparareal_torch.systems.configs import Config
from nngparareal_torch.utils.io import store_pickle

MODELS_DEFAULT = ("parareal", "gpjax", "nngp")


def _summarize(name, out, N):
    return {
        "name": name,
        "k": out["k"],
        "converged": out["converged"],
        "runtime": out["timings"]["runtime"],
        "F_time": out["timings"]["F_time"],
        "G_time": out["timings"]["G_time"],
        "mdl_tot_t": out["timings"]["mdl_tot_t"],
        "est_serial": est_serial(out, N),
        "speedup": calc_speedup(out, N=N),
        "conv_int": out["conv_int"],
        "err": out["err"],
        "timings": out["timings"],
    }


def _check_models(models):
    """Every model name known, before any model runs."""
    unknown = [m for m in models if m not in MODEL_NAMES]
    if unknown:
        raise ValueError(f"unknown models {unknown}; the port runs "
                         f"{list(MODEL_NAMES)}")


def _run_models(p, model_kwargs, models, results_dir, tag, nngp_kw=None,
                **common):
    _check_models(models)
    rows = []
    for mdl in models:
        kw = dict(common)
        kw.update(model_kwargs.get(mdl, {}))
        if nngp_kw and mdl == "nngp":
            # caller overrides, e.g. optimizer='grid'
            kw.update(nngp_kw)
        out = p.run(model=mdl, **kw)
        rows.append(_summarize(mdl, out, p.N))
        if results_dir:
            store_pickle(rows, f"{tag}.pkl", results_dir)
    return rows


def run_hopf(N, models=MODELS_DEFAULT, results_dir="results", mesh=None,
             store_int=False, fine_mult=10000, nngp_kw=None, gp_kw=None,
             device=None):
    """Hopf scalability: the Config's fine step count x ``fine_mult``,
    fine solves paged in Nf/25 chunks (the plain path; the kernel takes
    every step in one launch)."""
    _check_models(models)
    ode = Hopf(normalization="-11", device=device)
    cfg = Config(ode, N=N).get()
    Nf = cfg["Nf"] * fine_mult
    solver = RKSolver(
        ode.get_vector_field(), cfg["Ng"], Nf, G=cfg["G"], F=cfg["F"],
        thresh=max(Nf // 25, 1), device_field=ode.get_device_field(),
        device=device,
    )
    p = Parareal(ode, solver, cfg["tspan"], N, epsilon=5e-7, device=device)
    model_kwargs = {
        "gpjax": dict(theta=[1, 1], fatol=1e-6, xatol=1e-6,
                      **(gp_kw or {})),
        "nngp": dict(fatol=1e-1, xatol=1e-1, nn=15, n_restarts=2, seed=45),
    }
    return _run_models(p, model_kwargs, models, results_dir, f"hopf_{N}",
                       mesh=mesh, store_int=store_int, nngp_kw=nngp_kw)


def run_tomlab(N, models=MODELS_DEFAULT, results_dir="results", mesh=None,
               store_int=False, nngp_kw=None, gp_kw=None, device=None):
    """Thomas labyrinth scalability (T and the step counts per N from its
    Config)."""
    _check_models(models)
    ode = ThomasLabyrinth(normalization="-11", device=device)
    cfg = Config(ode, N=N).get()
    solver = RKSolver(
        ode.get_vector_field(), cfg["Ng"], cfg["Nf"], G=cfg["G"], F=cfg["F"],
        device_field=ode.get_device_field(), device=device,
    )
    p = Parareal(ode, solver, cfg["tspan"], N, epsilon=5e-7, device=device)
    model_kwargs = {
        "gpjax": dict(fatol=1e-1, xatol=1e-1, **(gp_kw or {})),
        "nngp": dict(nn=18, n_restarts=1, fatol=1e-3, xatol=1e-3, seed=45),
    }
    return _run_models(p, model_kwargs, models, results_dir, f"tomlab_{N}",
                       mesh=mesh, store_int=store_int, nngp_kw=nngp_kw)


def run_burgers(T=5.9, N=128, models=MODELS_DEFAULT, results_dir="results",
                mesh=None, store_int=False, nn=18, seed=45, nngp_kw=None,
                device=None):
    """Viscous Burgers d=N=128 over [0, T]: RK1 x4 / RK8 x40 000 per
    slice."""
    _check_models(models)
    ode = Burgers(d_x=N, normalization="-11", device=device)
    Ng = 4  # per slice; Ng=4N in all
    Nf = Ng * 10000
    solver = RKSolver(ode.get_vector_field(), Ng, Nf, G="RK1", F="RK8",
                      device_field=ode.get_device_field(), device=device)
    p = Parareal(ode, solver, [0.0, T], N, epsilon=5e-7, device=device)
    model_kwargs = {"nngp": dict(nn=nn, seed=seed)}
    return _run_models(p, model_kwargs, models, results_dir,
                       f"burgers_{N}_T{T}", mesh=mesh, store_int=store_int,
                       nngp_kw=nngp_kw)


def fhn_pde_parareal(dx, device=None):
    """The Parareal of the FHN 2D PDE d-scaling run: N=512, d=2*dx^2.

    The scaling driver's fine step count is Nf = ceil(1e8/Ng)*Ng over N
    (Ng the total coarse steps), not the Config's ~1e4 total. The plain
    fine path pages it in Nf/25 chunks; the kernel takes every step in one
    launch."""
    ode = FHNPDE(d_x=dx, normalization="-11", device=device)
    cfg = Config(ode, d_x=dx).get()
    N = cfg["N"]
    Ng_tot = cfg["Ng"] * N
    Nf = int(np.ceil(1e8 / Ng_tot) * Ng_tot) // N
    solver = RKSolver(
        ode.get_vector_field(), cfg["Ng"], Nf, G=cfg["G"], F=cfg["F"],
        thresh=max(Nf // 25, 1), device_field=ode.get_device_field(),
        device=device,
    )
    return Parareal(ode, solver, cfg["tspan"], N, epsilon=5e-7,
                    device=device)


def run_fhn_pde(dx, models=MODELS_DEFAULT, results_dir="results",
                mesh=None, store_int=False, nngp_kw=None, device=None):
    """FHN 2D PDE d-scaling run at grid width dx (``fhn_pde_parareal``)
    for each model; returns the summary rows."""
    p = fhn_pde_parareal(dx, device=device)
    model_kwargs = {"nngp": dict(nn=20)}
    return _run_models(
        p, model_kwargs, models, results_dir, f"fhn_pde_{dx}",
        mesh=mesh, store_int=store_int, nngp_kw=nngp_kw,
    )


_TABLE2_SYSTEMS = [
    # (ctor, nn at 5e-7, nn at 5e-9), as the JAX package's table
    (FHNODE, 15, 13),
    (Rossler, 15, 13),
    (Hopf, 15, 12),
    (Brusselator, 14, 12),
    (Lorenz, 14, 13),
    (DblPend, 15, 14),
]


def _run_table2_system(idx, epsilon, models, device=None, nngp_kw=None,
                       gp_kw=None, mesh=None):
    """One whole-system Table-2 run at its published configuration (Hopf
    at N=32); returns {system, epsilon, nn, runs}. Module-level, so that
    it pickles into a spawned worker of ``run_table2(pool=...)``, which
    runs it on ``device`` as the parent would (the card unless
    ``device="cpu"``: several processes share a card, where the JAX
    package's workers force the CPU because a TPU chip cannot be
    shared)."""
    ctor, nn7, nn9 = _TABLE2_SYSTEMS[idx]
    nn = nn7 if epsilon == 5e-7 else nn9
    ode = ctor(normalization="-11", device=device)
    N_arg = 32 if isinstance(ode, Hopf) else None
    cfg = Config(ode, N=N_arg).get()
    solver = RKSolver(
        ode.get_vector_field(), cfg["Ng"], cfg["Nf"], G=cfg["G"], F=cfg["F"],
        device_field=ode.get_device_field(), device=device,
    )
    p = Parareal(ode, solver, cfg["tspan"], cfg["N"], epsilon=epsilon,
                 device=device)
    model_kwargs = {
        "nngp": dict(nn=nn),
        "gpjax": dict(fatol=1e-6, xatol=1e-6, **(gp_kw or {})),
    }
    sys_rows = _run_models(p, model_kwargs, models, None, "",
                           nngp_kw=nngp_kw, mesh=mesh)
    return {"system": ode.name, "epsilon": epsilon, "nn": nn,
            "runs": sys_rows}


def run_table2(epsilon=5e-7, models=MODELS_DEFAULT, results_dir="results",
               mesh=None, systems=None, pool=None, gp_kw=None, device=None,
               nngp_kw=None):
    """Iterations to convergence across the six ODE systems of Table 2,
    one system after another; returns one row per system.

    ``systems``: optional subset of system names (e.g. ["FHN_ODE"]).
    ``nngp_kw``: the nnGP's overrides (the JAX ``run_table2`` has none;
    its nnGP always runs Nelder-Mead, as the port's does without them).
    ``gp_kw``: GParareal's, over fatol = xatol = 1e-6.
    ``pool``: an int fans the whole-system runs over that many spawned
    worker processes (the rows come back in the systems' order and are
    stored once, at the end); each worker runs on ``device``. It excludes
    ``mesh``, as in the JAX package."""
    _check_models(models)
    if pool and mesh is not None:
        raise ValueError("pool= (process fan-out) and mesh= (one run over "
                         "several devices) are mutually exclusive")
    sel = [i for i, (ctor, _, _) in enumerate(_TABLE2_SYSTEMS)
           if systems is None
           or ctor(normalization="-11", device="cpu").name in systems]
    tasks = _table2_tasks(sel, epsilon, models, device, nngp_kw, gp_kw)
    if pool:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max_workers=int(pool),
                mp_context=mp.get_context("spawn")) as ex:
            rows = list(ex.map(_run_table2_system, *zip(*tasks)))
        if results_dir:
            store_pickle(rows, f"table2_eps{epsilon:g}.pkl", results_dir)
        return rows
    rows = []
    for task in tasks:
        rows.append(_run_table2_system(*task, mesh=mesh))
        if results_dir:
            store_pickle(rows, f"table2_eps{epsilon:g}.pkl", results_dir)
    return rows


def _table2_tasks(sel, epsilon, models, device, nngp_kw, gp_kw):
    """The positional arguments of ``_run_table2_system`` for each system
    index of ``sel``: plain values, which pickle into a worker."""
    device = None if device is None else torch.device(device)
    return [(i, epsilon, tuple(models), device, nngp_kw, gp_kw) for i in sel]


def run_burgers_across_m(ms=range(11, 31), seeds=range(100), T=5.9,
                         results_dir="results", mesh=None, device=None):
    """K and speedup against the neighbour count m, over seeds: each seed
    is the nnGP's, so it draws the Nelder-Mead starts. A run that raises is
    recorded as a row with its error."""
    rows = []
    for m in ms:
        for seed in seeds:
            try:
                res = run_burgers(T=T, models=("nngp",), results_dir=None,
                                  mesh=mesh, nn=m, seed=int(seed),
                                  device=device)[0]
                rows.append({"m": m, "seed": seed, "k": res["k"],
                             "speedup": res["speedup"]})
            except Exception as e:  # record failures as data rows
                rows.append({"m": m, "seed": seed, "error": str(e)})
            if results_dir:
                store_pickle(rows, f"burgers_across_m_T{T}.pkl", results_dir)
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="nngparareal_torch experiments (the PyTorch/CUDA port). "
                    "The default --models runs parareal, gpjax (GParareal) "
                    "and nngp, as the JAX package's does.")
    ap.add_argument("experiment", choices=[
        "hopf", "tomlab", "burgers", "fhn_pde", "table2", "burgers_m",
    ])
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--dx", type=int, default=None)
    ap.add_argument("--T", type=float, default=5.9)
    ap.add_argument("--epsilon", type=float, default=5e-7)
    ap.add_argument("--models", nargs="+", default=list(MODELS_DEFAULT),
                    help="default: parareal gpjax nngp (any of "
                         f"{', '.join(MODEL_NAMES)})")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="shard each run's fine fan-out (and GParareal's "
                         "grid search) over this many CUDA cards; with "
                         "--device cpu, over that many blocks on the CPU")
    ap.add_argument("--nngp-grid", action="store_true",
                    help="nnGP grid hyperopt (default: Nelder-Mead, the "
                         "reference's search)")
    ap.add_argument("--gp-f32", action="store_true",
                    help="GParareal scores its candidates in f32 (the "
                         "posterior fit stays f64)")
    ap.add_argument("--gp-nm-iters", type=int, default=None,
                    help="GParareal's Nelder-Mead iterations at most "
                         "(default 400)")
    ap.add_argument("--pool", type=int, default=None,
                    help="table2: fan the whole-system runs over this many "
                         "spawned worker processes, each on --device")
    ap.add_argument("--systems", nargs="+", default=None,
                    help="table2: subset of system names")
    args = ap.parse_args(argv)

    dev = args.device
    mesh = None
    if args.mesh_devices:
        from nngparareal_torch.parallel.mesh import make_mesh

        k = args.mesh_devices
        on_cpu = dev is not None and torch.device(dev).type == "cpu"
        mesh = make_mesh(k, devices=[dev] * k if on_cpu else None)
    models = tuple(args.models)
    nngp_kw = dict(optimizer="grid") if args.nngp_grid else None
    gp_kw = None
    if args.gp_f32:
        gp_kw = dict(score_dtype=torch.float32)
    if args.gp_nm_iters:
        gp_kw = dict(gp_kw or {}, nm_max_iters=args.gp_nm_iters)
    if args.experiment == "hopf":
        rows = run_hopf(args.N or 32, models, args.results_dir, mesh,
                        nngp_kw=nngp_kw, gp_kw=gp_kw, device=dev)
    elif args.experiment == "tomlab":
        rows = run_tomlab(args.N or 32, models, args.results_dir, mesh,
                          nngp_kw=nngp_kw, gp_kw=gp_kw, device=dev)
    elif args.experiment == "burgers":
        rows = run_burgers(args.T, args.N or 128, models, args.results_dir,
                           mesh, nngp_kw=nngp_kw, device=dev)
    elif args.experiment == "fhn_pde":
        rows = run_fhn_pde(args.dx or 10, models, args.results_dir, mesh,
                           nngp_kw=nngp_kw, device=dev)
    elif args.experiment == "table2":
        rows = run_table2(args.epsilon, models, args.results_dir, mesh,
                          systems=args.systems, pool=args.pool, device=dev,
                          nngp_kw=nngp_kw, gp_kw=gp_kw)
    else:
        rows = run_burgers_across_m(T=args.T, results_dir=args.results_dir,
                                    mesh=mesh, device=dev)

    for r in rows:
        if "runs" in r:
            for rr in r["runs"]:
                print(r["system"], rr["name"], "K =", rr["k"],
                      f"speedup = {rr['speedup']:.2f}")
        elif "k" in r:
            print(r.get("name", f"m={r.get('m')}"), "K =", r["k"],
                  f"speedup = {r.get('speedup', float('nan')):.2f}")
    return rows


if __name__ == "__main__":
    main()
