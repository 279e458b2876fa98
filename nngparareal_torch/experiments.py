"""Experiment drivers: the paper's setups with their exact hyperparameters.

Port of ``nngparareal_tpu/experiments.py`` for the runs the port can do:

* ``run_fhn_pde`` -- the FHN 2D PDE d-scaling experiment (dx in {10..16},
  N=512, nnGP nn=20), with the scaling driver's fine step count
  Nf = ceil(1e8 / Ng_tot) * Ng_tot / N; ``fhn_pde_parareal`` builds its
  Parareal.

Each model runs in turn on the card (``device=None``) or wherever
``device`` says; ``results_dir`` receives the pickled summary rows. Not
ported yet (ROADMAP.md): the GParareal model ``gpjax`` that
``MODELS_DEFAULT`` names, which is refused before anything runs; the
``mesh`` argument (multi-GPU slice sharding); ``run_hopf``,
``run_tomlab``, ``run_burgers``, ``run_table2`` and the command line.
"""

import numpy as np

from nngparareal_torch.driver import Parareal
from nngparareal_torch.reporting import calc_speedup, est_serial
from nngparareal_torch.solver import RKSolver
from nngparareal_torch.systems import FHNPDE
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
