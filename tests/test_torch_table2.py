"""Port parity for the Table-2 driver: Lorenz at its full configuration.

``experiments.run_table2`` of the port (``device="cpu"``, the grid search
through ``nngp_kw``) against the JAX package run on the CPU as
tests/test_parity_slow.py runs it (``Parareal.run`` over the same
``Config`` and ``RKSolver``), for the ``parareal`` and ``nngp`` models at
eps=5e-7:

* K is equal, and equal to the CPU IEEE-f64 oracle of PARITY.md:9-16
  (Lorenz: Parareal 15, nnGP with the grid search 9).
* The control is the JAX package against itself with u0 moved by 4e-16
  (the gap the two packages start with), as tests/test_torch_fhn_pde.py
  and tests/test_torch_parareal.py use it. Lorenz is chaotic: the coarse
  initialisations of the two packages, and of JAX and its control,
  already differ by more than 1e-9, so no 1e-9 bound holds on its
  iterates. The nnGP's grid search, in its first sweeps, is near a tie:
  under the control the JAX run converges in 8 iterations instead of 9,
  and its conv_int departs from the unmoved run's at the sixth entry
  (``test_lorenz_nngp_control_is_near_a_tie``).
* So: Parareal's conv_int is equal; the nnGP's conv_int agrees with JAX's
  for exactly as many leading entries as it does today (Lorenz 6 of 9: the
  seventh is 39 against JAX's 37), and for no fewer than the control's
  do; the final iterate
  is within 1e-9 of max|u| of JAX's, or else within 10x the control's
  gap; Parareal's iterates stay within 10x the control's gap in every
  iteration.
* A checkpoint the JAX nnGP run wrote after its third iteration resumes
  in the port to the same K and conv_int as the JAX run.
* ThomasLabyrinth N=32 with bare Parareal reaches K=30 in the JAX
  package: chip_smoke.py's oracle for the port's run of it.
* Rossler's nnGP K under the control, for the sign draws 0-9, is 12, 12,
  11, 11, 12, 12, 12, 12, 11, 12: 11 lies outside the 12-13 that
  tests/test_parity_slow.py allows the JAX package (its CPU value is 13),
  in the method's spread at the rounding level, which the chip run's
  range takes in.
* ``pool=`` with ``mesh=`` refused (as in JAX), ``mesh=`` reaching each
  run, ``gpjax`` reaching GParareal with the JAX driver's Table-2
  settings, and the nnGP that names no search: it runs Nelder-Mead, the
  JAX default.

The helpers here also serve the other Table-2 files
(tests/test_torch_table2_*.py).
"""

import os

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt

import nngparareal_torch as nt
from nngparareal_torch import driver as tdriver
from nngparareal_torch import experiments as texp
from nngparareal_torch.convert import load_checkpoint
from nngparareal_torch.models import GParareal, NNGParareal
from nngparareal_torch.parallel import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPS = 5e-7
NUDGE = 4e-16  # the control's move of u0
FINAL = 1e-9  # final iterate, relative to max|u|, where no near-tie is
# a cut configuration's final iterate, relative to max|u|: both runs stop
# once an iteration moves no slice end by eps
CUT_FINAL = EPS
MODELS = ("parareal", "nngp")
GRID = dict(optimizer="grid")
# the neighbour count of each system at 5e-7 (experiments._TABLE2_SYSTEMS)
NN = {ctor.__name__: nn for ctor, nn, _ in texp._TABLE2_SYSTEMS}
ODE_NAMES = {"FHNODE": "FHN_ODE"}
N32 = ("Hopf", "ThomasLabyrinth")  # systems whose Config needs N (32 here)


def jax_run(name, model, edit=None, nudge=0.0, sign_seed=0, search=GRID,
            **kw):
    """The JAX package's run of one Table-2 system, with its config
    changed by ``edit`` where a test cuts it, and u0 moved by ``nudge``
    for the control (each coordinate up or down, by a draw of
    ``sign_seed``); the nnGP with the search ``search`` names (``{}``:
    the default, Nelder-Mead)."""
    ode = getattr(jt, name)(normalization="-11")
    cfg = jt.Config(ode, N=32 if name in N32 else None).get()
    if edit:
        edit(cfg)
    s = jt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"])
    p = jt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=EPS,
                    verbose=None)
    if nudge:
        signs = np.random.default_rng(sign_seed).choice([-1.0, 1.0],
                                                        p.u0.shape)
        p.u0 = p.u0 + nudge * signs
    mkw = dict(nn=NN[name], **search) if model == "nngp" else {}
    return p.run(model=model, keep_history=True, measure_serial_fine=False,
                 **mkw, **kw)


def port_run(name, edit=None, results_dir=None, models=MODELS,
             search=GRID):
    """The port's run_table2 for one system (both models unless
    ``models`` says otherwise; ``search`` as its ``nngp_kw``, ``{}`` for
    none); returns its row and the Parareal outputs of its runs (with
    their histories), by model."""
    outs = []
    run = tdriver.Parareal.run

    def keep(self, *args, **kwargs):
        out = run(self, *args, keep_history=True, **kwargs)
        outs.append(out)
        return out

    class Cut(texp.Config):
        def get(self):
            cfg = super().get()
            edit(cfg)
            return cfg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdriver.Parareal, "run", keep)
        if edit:
            mp.setattr(texp, "Config", Cut)
        rows = texp.run_table2(
            EPS, models=models, results_dir=results_dir,
            systems=[ODE_NAMES.get(name, name)], device="cpu",
            nngp_kw=search or None)
    assert len(rows) == 1 and len(outs) == len(models)
    return rows[0], dict(zip(models, outs))


def runs_of(name, edit=None, controls=True, models=MODELS, search=GRID):
    """The port and JAX, and JAX's control where ``controls``, for each of
    ``models``, the nnGP with ``search``."""
    runs = {"port": port_run(name, edit, models=models, search=search)}
    for model in models:
        runs[model] = jax_run(name, model, edit, search=search)
        if controls:
            runs[model + "_control"] = jax_run(name, model, edit, NUDGE,
                                               search=search)
    return runs


def _agree(a, b):
    """Leading entries on which two conv_int lists agree."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def check_row(row, name, N, models=MODELS):
    """The row of one system: its name (Hopf's with its N), tolerance,
    neighbour count and one summary per model."""
    assert row["system"] == (f"{name}_{N}" if name == "Hopf"
                             else ODE_NAMES.get(name, name))
    assert row["epsilon"] == EPS and row["nn"] == NN[name]
    assert [r["name"] for r in row["runs"]] == list(models)


def check_against_jax(runs, model, k_oracle=None, agree=None):
    """K equal (and equal to the oracle), conv_int and iterates against
    JAX within what the control allows; an nnGP run's conv_int agrees with
    JAX's for exactly ``agree`` leading entries."""
    row, outs = runs["port"]
    ot, oj = outs[model], runs[model]
    summary, = [r for r in row["runs"] if r["name"] == model]
    assert ot["converged"] and oj["converged"]
    assert summary["k"] == ot["k"] == oj["k"]
    if k_oracle is not None:
        assert ot["k"] == k_oracle
    assert summary["conv_int"] == ot["conv_int"]
    assert ot["conv_int"][-1] == oj["conv_int"][-1]
    scale = np.abs(oj["u"]).max()
    gap = np.abs(ot["u"] - oj["u"]).max() / scale
    oc = runs.get(model + "_control")
    if oc is None:  # a cut configuration, no near-tie
        assert ot["conv_int"] == oj["conv_int"]
        assert gap <= CUT_FINAL, gap
        return
    ctl = np.abs(oc["u"] - oj["u"]).max() / scale
    assert gap <= FINAL or gap <= 10 * ctl, (gap, ctl)
    if model == "parareal":
        assert ot["conv_int"] == oj["conv_int"]
        k = oj["u_hist"].shape[2]
        port = np.abs(ot["u_hist"] - oj["u_hist"]).max(axis=(0, 1))
        control = np.abs(oc["u_hist"][:, :, :k] - oj["u_hist"]).max(
            axis=(0, 1))
        assert np.all(port <= np.maximum(10 * control, FINAL * scale)), (
            port, control)
    else:
        got = _agree(ot["conv_int"], oj["conv_int"])
        assert got == agree, (ot["conv_int"], oj["conv_int"])
        assert got >= _agree(oc["conv_int"], oj["conv_int"]), (
            ot["conv_int"], oj["conv_int"], oc["conv_int"])


# --- Lorenz at its full Table-2 configuration ---


@pytest.fixture(scope="module")
def lorenz(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    rdir = str(tmp_path_factory.mktemp("results"))
    runs = {"port": port_run("Lorenz", results_dir=rdir)}
    for model in MODELS:
        kw = dict(store_int=True, int_dir=jdir) if model == "nngp" else {}
        runs[model] = jax_run("Lorenz", model, **kw)
        runs[model + "_control"] = jax_run("Lorenz", model, nudge=NUDGE)
    name = "Lorenz_50_NNGP_int"
    runs["jax_ckpt"] = os.path.join(jdir, name, f"{name}_2")
    runs["results_dir"] = rdir
    return runs


@pytest.mark.parametrize("model,k,agree", [("parareal", 15, None),
                                           ("nngp", 9, 6)])
def test_lorenz_table2_matches_jax(lorenz, model, k, agree):
    check_against_jax(lorenz, model, k, agree)


def test_lorenz_table2_row(lorenz):
    row, _ = lorenz["port"]
    check_row(row, "Lorenz", 50)
    stored = load_checkpoint(os.path.join(lorenz["results_dir"],
                                          "table2_eps5e-07.pkl"))
    assert [r["system"] for r in stored] == ["Lorenz"]
    assert [r["k"] for r in stored[0]["runs"]] == [15, 9]


def test_lorenz_resumes_jax_checkpoint(lorenz):
    """The JAX nnGP run's checkpoint after its third iteration, resumed in
    the port, reaches the JAX run's K and conv_int."""
    full = lorenz["nngp"]
    ode = nt.Lorenz(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=EPS,
                    verbose=None, device="cpu")
    out = p.load_int_dump(lorenz["jax_ckpt"], model="nngp", nn=NN["Lorenz"],
                          measure_serial_fine=False, **GRID)
    assert out["converged"]
    assert out["k"] == full["k"] == 9
    assert out["conv_int"] == full["conv_int"]
    assert out["conv_int"][:3] == load_checkpoint(
        lorenz["jax_ckpt"])["conv_int"]
    ctl = np.abs(lorenz["nngp_control"]["u"] - full["u"]).max()
    assert np.abs(out["u"] - full["u"]).max() <= 10 * ctl


def test_lorenz_nngp_control_is_near_a_tie(lorenz):
    """Under the control the JAX nnGP run converges in 8 iterations, not 9,
    and its conv_int departs from the unmoved run's at the sixth entry."""
    oj, oc = lorenz["nngp"], lorenz["nngp_control"]
    assert (oj["k"], oc["k"]) == (9, 8)
    assert _agree(oc["conv_int"], oj["conv_int"]) == 5


def test_tomlab_parareal_k_of_the_jax_package():
    """ThomasLabyrinth N=32 (tspan [0, 10], RK1 x10 / RK4 x31 250 per
    slice) with bare Parareal: K=30 in the JAX package on the CPU, the K
    that chip_smoke.py holds the port's run on the card to."""
    out = jax_run("ThomasLabyrinth", "parareal")
    assert out["converged"] and out["k"] == 30


@pytest.mark.parametrize("sign_seed,k", enumerate(
    [12, 12, 11, 11, 12, 12, 12, 12, 11, 12]))
def test_rossler_nngp_k_under_the_control(sign_seed, k):
    """Rossler's nnGP (grid) K is 13 on the CPU (PARITY.md); when u0 moves
    by 4e-16 it is 12 or 11 by the draw of the move's signs (ten draws:
    seven 12, three 11, no 13). So the range 12-13 that
    tests/test_parity_slow.py allows is narrower than the method's own
    spread at the rounding level, and the chip run's Rossler range
    (chip_smoke.py:TABLE2) takes 11."""
    out = jax_run("Rossler", "nngp", nudge=NUDGE, sign_seed=sign_seed)
    assert out["converged"] and out["k"] == k


# --- the default search, and the refusals ---


def test_nngp_without_a_search_is_refused():
    """Naming no search runs the JAX default, Nelder-Mead, with the JAX
    package's settings (fatol, xatol, restarts, iterations, neighbour
    count, seed); no call is refused for it any more."""
    want = jt.models.NNGParareal(n=2, N=4)
    got = NNGParareal(n=2, N=4)
    for key in ("optimizer", "fatol", "xatol", "n_restarts", "nm_max_iters",
                "nn", "seed", "B"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.optimizer == "nm" and got.B == 2 * 9
    ode = nt.FHNODE(normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), 4, 10, G="RK2", F="RK4",
                    device="cpu")
    p = nt.Parareal(ode, s, [0.0, 40.0], 40, verbose=None, device="cpu")
    mdl = p._make_model("nngp", dict(nn=15, n_restarts=2, fatol=1e-3))
    assert (mdl.optimizer, mdl.nn, mdl.n_restarts, mdl.fatol, mdl.xatol,
            mdl.B) == ("nm", 15, 2, 1e-3, 0.1, 2 * 9 * 2)
    assert NNGParareal(n=2, N=4, nn=15, optimizer="grid").nn == 15


class _Reached(Exception):
    """Raised where a stubbed run reaches a GP model."""


def _stub_parareal(models, kws=None):
    """Parareal._parareal that records its model (and its keywords into
    ``kws``): an nnGP or a GParareal stops the run there (_Reached), any
    other model returns an empty result."""
    def run(self, model, **kw):
        models.append(model)
        if kws is not None:
            kws.append(kw)
        if isinstance(model, (NNGParareal, GParareal)):
            raise _Reached
        return {"k": 1, "converged": True, "conv_int": [], "err": None,
                "timings": {"core_t": 1.0, "F_time": 0.0, "G_time": 0.0,
                            "mdl_tot_t": 0.0, "F_time_serial_avg": 0.0}}
    return run


@pytest.mark.parametrize("kwargs,match", [
    (dict(models=("nngp",)), None),
    (dict(models=("parareal", "nngp"), nngp_kw=dict(nn=3)), None),
    (dict(models=("gpjax",), nngp_kw=GRID), "GParareal"),
    (dict(models=MODELS, nngp_kw=GRID, pool=2,
          mesh=make_mesh(devices=["cpu"] * 2)), "pool"),
    (dict(models=MODELS, nngp_kw=GRID, mesh=make_mesh(devices=["cpu"] * 2)),
     "mesh"),
], ids=["kwargs0-None", "kwargs1-None", "kwargs2-ROADMAP", "kwargs3-pool",
        "kwargs4-mesh"])  # the ids these cases had when gpjax was refused
def test_run_table2_refusals(kwargs, match, monkeypatch):
    """``pool`` with ``mesh`` is refused before any model runs, with the
    JAX package's ValueError. Without a search named (``match`` None)
    nothing is refused: the first system's nnGP is built with
    Nelder-Mead, the JAX default, and its neighbour count, or the one
    ``nngp_kw`` gives. ``gpjax`` is not refused: it runs GParareal with
    the JAX driver's Table-2 settings (Nelder-Mead, fatol = xatol = 1e-6,
    at most 400 iterations; ``nngp_kw`` is the nnGP's alone). ``mesh``
    reaches every run of the system."""
    models, kws = [], []
    monkeypatch.setattr(tdriver.Parareal, "_parareal",
                        _stub_parareal(models, kws))
    if match == "GParareal":
        with pytest.raises(_Reached):
            texp.run_table2(EPS, results_dir=None, device="cpu", **kwargs)
        (mdl,) = models
        assert isinstance(mdl, GParareal)
        assert (mdl.optimizer, mdl.fatol, mdl.xatol, mdl.nm_max_iters) == (
            "nm", 1e-6, 1e-6, 400)
        return
    if match is None:
        with pytest.raises(_Reached):
            texp.run_table2(EPS, results_dir=None, device="cpu", **kwargs)
        mdl = models[-1]
        assert [type(m).__name__ for m in models] == (
            ["BareParareal"] * ("parareal" in kwargs["models"])
            + ["NNGParareal"])
        nn = (kwargs.get("nngp_kw") or {}).get("nn", NN["FHNODE"])
        assert (mdl.optimizer, mdl.nn, mdl.n_restarts) == ("nm", nn, 1)
        return
    if match == "mesh":
        with pytest.raises(_Reached):
            texp.run_table2(EPS, results_dir=None, device="cpu", **kwargs)
        assert [type(m).__name__ for m in models] == ["BareParareal",
                                                      "NNGParareal"]
        assert [kw["mesh"] for kw in kws] == [kwargs["mesh"]] * 2
        return
    with pytest.raises(ValueError, match="mutually exclusive"):
        texp.run_table2(EPS, results_dir=None, device="cpu", **kwargs)
    assert models == []
