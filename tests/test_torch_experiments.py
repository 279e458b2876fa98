"""Port parity for the experiment drivers that need Nelder-Mead:
``run_hopf``, ``run_tomlab``, ``run_burgers``, ``run_burgers_across_m``
and the command line ``main``.

* Each driver builds the JAX package's run: both packages' drivers stop
  at ``_run_models``, and the Parareal, its solver (N, tspan, Ng, Nf,
  thresh, G, F, eps, u0) and the model keywords, GParareal's among them,
  are equal.
* The default ``models`` (parareal, gpjax, nngp) and ``gp_kw`` reach
  GParareal with the JAX driver's settings; ``mesh=`` reaches every run,
  and GParareal.
* ``run_burgers_across_m`` threads each seed into the nnGP: the first
  sweep's Nelder-Mead starts are JAX's for every seed, differ between
  seeds, and repeat for a repeated seed.
* ``main`` dispatches each experiment with JAX's arguments (the nnGP with
  Nelder-Mead, or the grid with ``--nngp-grid``; the default ``--models``
  with GParareal; ``--gp-f32`` and ``--gp-nm-iters`` into GParareal's
  settings), ``--mesh-devices k`` as a k-block mesh (on the CPU with
  ``--device cpu``) and ``--pool k`` as run_table2's k workers (here an
  in-process stand-in for the process pool, whose tasks must pickle);
  ``--help`` says what each does.

No model runs here: ``Parareal._parareal`` is stubbed where a call would
run one. tests/test_torch_experiments_runs.py runs the drivers.
"""

import pickle

import numpy as np
import pytest
import torch

from nngparareal_tpu import driver as jdriver
from nngparareal_tpu import experiments as jexp

from nngparareal_torch import driver as tdriver
from nngparareal_torch import experiments as texp
from nngparareal_torch.parallel import make_mesh


def _capture(seen, name):
    def stub(p, model_kwargs, models, results_dir, tag, nngp_kw=None,
             **common):
        seen[name] = dict(p=p, model_kwargs=model_kwargs, models=models,
                          tag=tag, nngp_kw=nngp_kw, common=common)
        return []
    return stub


def _built(pj, pt):
    """The two Parareals and their solvers agree."""
    sj, st = pj.solver, pt.solver
    assert (st.Ng, st.Nf, st.thresh, st.G.name, st.F.name) == (
        sj.Ng, sj.Nf, sj.thresh, sj.G.name, sj.F.name)
    assert (pt.tspan, pt.N, pt.epsilon, pt.ode_name) == (
        tuple(float(x) for x in pj.tspan), pj.N, pj.epsilon, pj.ode_name)
    np.testing.assert_array_equal(pt.u0.numpy(), np.asarray(pj.u0))
    assert st.device_field is not None


DRIVERS = [
    ("run_hopf", dict(N=32)),
    ("run_hopf", dict(N=512, fine_mult=3)),
    ("run_tomlab", dict(N=32)),
    ("run_tomlab", dict(N=128, store_int=True)),
    ("run_burgers", dict()),
    ("run_burgers", dict(T=5.0, N=16, nn=12, seed=7)),
]


@pytest.mark.parametrize("fn,kw", DRIVERS)
def test_driver_builds_the_jax_run(fn, kw, monkeypatch):
    seen = {}
    monkeypatch.setattr(jexp, "_run_models", _capture(seen, "jax"))
    monkeypatch.setattr(texp, "_run_models", _capture(seen, "torch"))
    args = dict(kw, models=("parareal", "nngp"), results_dir=None)
    getattr(jexp, fn)(**args)
    getattr(texp, fn)(device="cpu", **args)
    j, t = seen["jax"], seen["torch"]
    pj, pt = j.pop("p"), t.pop("p")
    assert t == j
    _built(pj, pt)


# GParareal's settings in each JAX driver (nngparareal_tpu/experiments.py:
# run_hopf, run_tomlab, _run_table2_system; run_burgers sets none)
JAX_GP = {"run_hopf": dict(theta0=[1.0, 1.0], fatol=1e-6, xatol=1e-6),
          "run_tomlab": dict(theta0=[1.0, 1.0], fatol=1e-1, xatol=1e-1),
          "run_burgers": dict(theta0=[1.0, 1.0], fatol=1e-4, xatol=1e-4),
          "run_table2": dict(theta0=[1.0, 1.0], fatol=1e-6, xatol=1e-6)}


def _check_gp(mdl, want, **extra):
    assert type(mdl).__name__ == "GParareal"
    np.testing.assert_array_equal(mdl.theta0, want["theta0"])
    assert (mdl.fatol, mdl.xatol) == (want["fatol"], want["xatol"])
    for key, val in extra.items():
        assert getattr(mdl, key) == val, key


@pytest.mark.parametrize("fn", ["run_hopf", "run_tomlab", "run_burgers",
                                "run_table2", "run_burgers_across_m"])
def test_driver_refusals(fn, monkeypatch):
    """mesh= reaches every run (and GParareal, which shards its grid
    search over it). The default models (parareal, gpjax, nngp) run
    GParareal with the JAX driver's settings, and gp_kw, where the JAX
    driver takes it, overrides them."""
    runs = []
    monkeypatch.setattr(tdriver.Parareal, "_parareal", _record_models(runs))
    pos = {"run_hopf": (32,), "run_tomlab": (32,)}.get(fn, ())
    sel = dict(systems=["FHN_ODE"]) if fn == "run_table2" else {}
    few = (dict(ms=[12], seeds=[3]) if fn == "run_burgers_across_m"
           else {})
    mesh = make_mesh(devices=["cpu"] * 2)
    getattr(texp, fn)(*pos, results_dir=None, device="cpu", mesh=mesh,
                      **sel, **few)
    assert runs and all(kw["mesh"] is mesh for _, _, kw in runs)
    assert all(m.mesh is mesh for _, m, _ in runs
               if type(m).__name__ == "GParareal")
    runs.clear()
    if fn == "run_burgers_across_m":
        return
    getattr(texp, fn)(*pos, results_dir=None, device="cpu", **sel)
    assert [type(m).__name__ for _, m, _ in runs] == [
        "BareParareal", "GParareal", "NNGParareal"]
    _check_gp(runs[1][1], JAX_GP[fn], optimizer="nm", nm_max_iters=400)
    if fn != "run_burgers":
        runs.clear()
        getattr(texp, fn)(*pos, models=("gpjax",), results_dir=None,
                          device="cpu", gp_kw=dict(optimizer="grid",
                                                   nm_max_iters=7), **sel)
        (_, mdl, _), = runs
        _check_gp(mdl, JAX_GP[fn], optimizer="grid", nm_max_iters=7)


class _Stop(Exception):
    pass


def _first_draw(draws):
    """Parareal._parareal of either package: record the model's seed,
    neighbour count and first sweep's draw, and stop."""
    def run(self, model, **kw):
        aux = model.sweep_aux(0, self.N, 64)
        aux = aux["theta0"] if isinstance(aux, dict) else aux
        draws.append((model.seed, model.nn, np.asarray(aux)))
        raise _Stop
    return run


def test_burgers_across_m_threads_the_seed(monkeypatch):
    got, want = [], []
    monkeypatch.setattr(tdriver.Parareal, "_parareal", _first_draw(got))
    monkeypatch.setattr(jdriver.Parareal, "_parareal", _first_draw(want))
    kw = dict(ms=[12, 13], seeds=[3, 4, 3], T=5.9, results_dir=None)
    rows_t = texp.run_burgers_across_m(device="cpu", **kw)
    rows_j = jexp.run_burgers_across_m(**kw)
    # each run stopped in the stub and was recorded as an error row
    assert [(r["m"], r["seed"]) for r in rows_t] == [
        (r["m"], r["seed"]) for r in rows_j] == [
        (m, s) for m in (12, 13) for s in (3, 4, 3)]
    assert len(got) == len(want) == 6
    for (st, nt, at), (sj, nj, aj) in zip(got, want):
        assert (st, nt) == (sj, nj)
        np.testing.assert_array_equal(at, aj)
    assert got[0][2].shape == (128, 128 * 9, 2)
    assert not np.array_equal(got[0][2], got[1][2])  # seeds 3 and 4
    np.testing.assert_array_equal(got[0][2], got[2][2])  # seed 3 again


def _fake_out(model):
    return {"k": 2, "converged": True, "conv_int": [1, 2], "err": None,
            "timings": {"core_t": 1.0, "F_time": 0.0, "G_time": 0.0,
                        "mdl_tot_t": 0.0, "F_time_serial_avg": 0.0}}


def _record_models(models):
    def run(self, model, **kw):
        models.append((self, model, kw))
        return _fake_out(model)
    return run


@pytest.mark.parametrize("argv,check", [
    (["table2", "--models", "parareal", "nngp", "--systems", "FHN_ODE"],
     dict(n_runs=2, optimizer="nm", nn=15, N=40)),
    (["table2", "--models", "nngp", "--nngp-grid", "--systems", "Lorenz",
      "--epsilon", "5e-9"], dict(n_runs=1, optimizer="grid", nn=13, N=50)),
    (["hopf", "--models", "nngp", "--N", "64"],
     dict(n_runs=1, optimizer="nm", nn=15, N=64, n_restarts=2)),
    (["tomlab", "--models", "nngp"],
     dict(n_runs=1, optimizer="nm", nn=18, N=32, fatol=1e-3)),
    (["burgers", "--models", "nngp", "--N", "16", "--T", "5"],
     dict(n_runs=1, optimizer="nm", nn=18, N=16)),
    (["fhn_pde", "--models", "parareal", "--dx", "10"],
     dict(n_runs=1, N=512)),
])
def test_main_runs_the_jax_arguments(argv, check, monkeypatch, tmp_path,
                                     capsys):
    models = []
    monkeypatch.setattr(tdriver.Parareal, "_parareal",
                        _record_models(models))
    rows = texp.main(argv + ["--device", "cpu", "--results-dir",
                             str(tmp_path)])
    assert len(models) == check["n_runs"] and rows
    p, mdl, _ = models[-1]
    assert p.N == check["N"]
    for key in ("optimizer", "nn", "n_restarts", "fatol"):
        if key in check:
            assert getattr(mdl, key) == check[key], key
    if "--epsilon" in argv:
        assert p.epsilon == 5e-9
    assert "K = 2" in capsys.readouterr().out


MAIN_CASES = [
    # the default --models: parareal, gpjax and nngp on each system
    (["table2", "--systems", "FHN_ODE", "Lorenz"],
     dict(n_runs=6, gp=JAX_GP["run_table2"])),
    (["hopf", "--models", "parareal", "gpjax"],
     dict(n_runs=2, gp=JAX_GP["run_hopf"])),
    (["table2", "--models", "gpjax", "--mesh-devices", "2", "--systems",
      "FHN_ODE"], dict(n_runs=1, gp=JAX_GP["run_table2"], mesh=2)),
    (["table2", "--models", "gpjax", "--pool", "2", "--systems", "FHN_ODE",
      "Lorenz"], dict(n_runs=2, gp=JAX_GP["run_table2"], pool=2)),
    (["hopf", "--models", "gpjax", "--gp-f32"],
     dict(n_runs=1, gp=JAX_GP["run_hopf"], score_dtype=torch.float32)),
    (["tomlab", "--models", "gpjax", "--gp-nm-iters", "50"],
     dict(n_runs=1, gp=JAX_GP["run_tomlab"], nm_max_iters=50)),
]


@pytest.mark.parametrize("argv,want", MAIN_CASES,
                         ids=[f"argv{i}" for i in range(len(MAIN_CASES))])
def test_main_refusals(argv, want, monkeypatch):
    """--mesh-devices k runs on a k-block mesh (here of the CPU) that
    reaches each run and GParareal; --pool k fans the systems over k
    workers (an in-process stand-in here) in the systems' order; the
    default --models, gpjax, --gp-f32 and --gp-nm-iters reach GParareal
    with the JAX driver's settings."""
    runs = []
    monkeypatch.setattr(tdriver.Parareal, "_parareal", _record_models(runs))
    pools = []
    monkeypatch.setattr("concurrent.futures.ProcessPoolExecutor",
                        _in_process_pool(pools))
    rows = texp.main(argv + ["--device", "cpu", "--results-dir", ""])
    assert len(runs) == want["n_runs"]
    gps = [m for _, m, _ in runs if type(m).__name__ == "GParareal"]
    assert gps
    extra = {k: v for k, v in want.items()
             if k not in ("n_runs", "gp", "mesh", "pool")}
    for mdl in gps:
        _check_gp(mdl, want["gp"], **extra)
    meshes = [kw["mesh"] for _, _, kw in runs]
    if "mesh" in want:
        mesh = meshes[0]
        assert [str(d) for d in mesh.devices] == ["cpu"] * want["mesh"]
        assert all(m is mesh for m in meshes)
        assert all(m.mesh is mesh for m in gps)
    else:
        assert meshes == [None] * len(runs)
    assert pools == ([(want["pool"], "spawn")] if "pool" in want else [])
    if "pool" in want:
        assert [r["system"] for r in rows] == argv[argv.index("--systems")
                                                   + 1:]


def _in_process_pool(made):
    """A stand-in for ProcessPoolExecutor that records (max_workers, start
    method) and maps in this process, where the stubbed driver records
    the runs; each task goes through pickle, as it would to a worker."""
    class Pool:
        def __init__(self, max_workers, mp_context):
            made.append((max_workers, mp_context.get_start_method()))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, *iterables):
            return [fn(*pickle.loads(pickle.dumps(args)))
                    for args in zip(*iterables)]
    return Pool


def test_main_help_names_the_refusals(capsys):
    """--help names every option and what it does; nothing is refused any
    more."""
    with pytest.raises(SystemExit):
        texp.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for word in ("--mesh-devices", "over this many CUDA cards",
                 "--device cpu, over that many blocks on the CPU", "--pool",
                 "spawned worker processes", "Nelder-Mead",
                 "parareal, gpjax (GParareal) and nngp",
                 "--gp-f32 GParareal scores its candidates in f32",
                 "--gp-nm-iters GP_NM_ITERS GParareal's Nelder-Mead"):
        assert word in text, word
    assert "gpjax is refused" not in text
    assert "refused" not in text and "ROADMAP" not in text
