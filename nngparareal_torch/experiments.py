"""Experiment drivers: the paper's setups with their exact hyperparameters.

Port of ``nngparareal_tpu/experiments.py`` for the runs the port can do:

* ``run_fhn_pde`` -- the FHN 2D PDE d-scaling experiment (dx in {10..16},
  N=512, nnGP nn=20), with the scaling driver's fine step count
  Nf = ceil(1e8 / Ng_tot) * Ng_tot / N; ``fhn_pde_parareal`` builds its
  Parareal.
* ``run_table2`` -- iterations to convergence of the paper's Table 2: six
  ODE systems (FHN, Rossler, Hopf N=32, Brusselator, Lorenz, DblPend) at
  their published configurations, nnGP with the neighbour count of each
  system and tolerance (``_TABLE2_SYSTEMS``).

Each model runs in turn on the card (``device=None``) or wherever
``device`` says; ``results_dir`` receives the pickled summary rows.

The nnGP search is named through ``nngp_kw`` (``dict(optimizer='grid')``):
the JAX package's default, Nelder-Mead, is not ported, and an nnGP run
that names no optimizer is refused before any model runs. The JAX
``run_table2`` has no ``nngp_kw`` (its nnGP always runs Nelder-Mead); the
port's takes it as both packages' ``run_fhn_pde`` do. Not ported yet
(ROADMAP.md): the GParareal model ``gpjax`` that ``MODELS_DEFAULT`` names,
which is refused before anything runs; the ``mesh`` argument (multi-GPU
slice sharding) and ``run_table2``'s process ``pool``, both refused;
``run_hopf``, ``run_tomlab``, ``run_burgers`` and the command line.
"""

import numpy as np

from nngparareal_torch.driver import Parareal
from nngparareal_torch.models import NNGParareal
from nngparareal_torch.reporting import calc_speedup, est_serial
from nngparareal_torch.solver import RKSolver
from nngparareal_torch.systems import (
    FHNODE, Rossler, Hopf, DblPend, Brusselator, Lorenz, FHNPDE,
)
from nngparareal_torch.systems.configs import Config
from nngparareal_torch.utils.io import store_pickle

MODELS_DEFAULT = ("parareal", "gpjax", "nngp")
_PORTED_MODELS = ("parareal", "nngp")


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


def _run_models(p, model_kwargs, models, results_dir, tag, nngp_kw=None,
                **common):
    missing = [m for m in models if m not in _PORTED_MODELS]
    if missing:
        raise NotImplementedError(
            f"models {missing} are not ported yet (ROADMAP.md, modules still "
            f"to port); the port runs {list(_PORTED_MODELS)}")
    if "nngp" in models:
        NNGParareal.check_optimizer((nngp_kw or {}).get("optimizer"))
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
                store_int=False, nngp_kw=None, device=None):
    """FHN 2D PDE d-scaling run at grid width dx (``fhn_pde_parareal``)
    for each model; returns the summary rows."""
    p = fhn_pde_parareal(dx, device=device)
    model_kwargs = {"nngp": dict(nn=20)}
    return _run_models(
        p, model_kwargs, models, results_dir, f"fhn_pde_{dx}",
        store_int=store_int, nngp_kw=nngp_kw,
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


def _run_table2_system(idx, epsilon, models, device=None, nngp_kw=None):
    """One whole-system Table-2 run at its published configuration (Hopf
    at N=32); returns {system, epsilon, nn, runs}."""
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
    model_kwargs = {"nngp": dict(nn=nn)}
    sys_rows = _run_models(p, model_kwargs, models, None, "",
                           nngp_kw=nngp_kw)
    return {"system": ode.name, "epsilon": epsilon, "nn": nn,
            "runs": sys_rows}


def run_table2(epsilon=5e-7, models=MODELS_DEFAULT, results_dir="results",
               mesh=None, systems=None, pool=None, device=None,
               nngp_kw=None):
    """Iterations to convergence across the six ODE systems of Table 2,
    one system after another; returns one row per system.

    ``systems``: optional subset of system names (e.g. ["FHN_ODE"]).
    ``nngp_kw``: the nnGP's overrides; it must name the search
    (``dict(optimizer='grid')``), which the JAX ``run_table2`` does not
    take. ``mesh`` and ``pool`` are not ported and raise."""
    if mesh is not None or pool:
        raise NotImplementedError(
            "run_table2's mesh= (multi-GPU slice sharding) and pool= (a "
            "process per system) are not ported yet (ROADMAP.md, modules "
            "still to port, item 9)")
    sel = [i for i, (ctor, _, _) in enumerate(_TABLE2_SYSTEMS)
           if systems is None
           or ctor(normalization="-11", device=device).name in systems]
    rows = []
    for i in sel:
        rows.append(_run_table2_system(i, epsilon, tuple(models),
                                       device=device, nngp_kw=nngp_kw))
        if results_dir:
            store_pickle(rows, f"table2_eps{epsilon:g}.pkl", results_dir)
    return rows
