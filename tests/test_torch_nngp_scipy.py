"""Port parity for the host oracles: models/nngp_scipy.py (NNGPScipy, the
nnGP with scipy's Nelder-Mead task by task), solver.py:ScipySolver and
systems/base.py:get_vector_field_numpy; the port of
tests/test_scipy_solver.py and of tests/test_parareal.py's nngp_scipy
tests.

* On the same dataset and queries NNGPScipy's predictions and recorded
  picks are bitwise JAX's: both are numpy and scipy, with the same
  stream of starts.
* FHN (nn=15), one iteration end to end: the inputs of the two packages
  differ by a rounding (their fan-outs), and scipy's Nelder-Mead on the
  near-singular local GPs turns that into near ties between jitters. The
  picks are the same (interval, coordinate) set, every pick's NLL within
  the search's fatol (0.1) of JAX's, and at least 90 % of them are JAX's
  (jitter equal, theta within 1e-6); the iterates lie within 10x JAX's
  own control (u0 moved by 4e-16).
* ScipySolver's fine solve against the RK fine solve (rtol 1e-7, as the
  JAX test) and against JAX's ScipySolver (rtol 1e-12); its coarse
  solve is the RK solver's.
* RUN_SLOW: a short Parareal run with the scipy fine solver (the JAX
  test's), and Hopf N=32 with nngp_scipy reaching the reference's K=9.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models.nngp_scipy import NNGPScipy as JScipy

import nngparareal_torch as nt
from nngparareal_torch.models import Dataset, NNGPScipy

from test_torch_knn_elm import _one_torch_thread, fhn_pair  # noqa: F401

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"


def _picks_equal(a, b):
    return a[2] == b[2] and np.abs(a[1] - b[1]).max() <= 1e-6


def test_same_inputs_give_jax_picks_bitwise():
    pj, _ = fhn_pair()
    out = pj.run(model="parareal", early_stop=1, measure_serial_fine=False,
                 comp_models=["knn_mean"])
    cap = 64
    X, D, V = np.zeros((cap, 2)), np.zeros((cap, 2)), np.zeros(cap)
    X[:40], D[:40], V[:40] = out["x"], out["D"], 1.0
    V[[3, 17]] = 0.0
    jm = JScipy(2, 40, nn=15, record=True, seed=3)
    tm = NNGPScipy(2, 40, nn=15, record=True, seed=3)
    jm.fit(JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(V)), 1)
    tm.fit(Dataset(torch.as_tensor(X), torch.as_tensor(D),
                   torch.as_tensor(V)), 1)
    z = np.zeros(2)
    zt = torch.zeros(2, dtype=torch.float64)
    for i in (1, 7, 30):
        q = out["u"][i]
        want = np.asarray(jm.predict_fn((), None, jnp.asarray(q),
                                        jnp.asarray(z), jnp.asarray(z), None,
                                        i))
        got = tm.predict_fn(None, torch.tensor(q), zt, zt, i).numpy()
        np.testing.assert_array_equal(got, want)
        for a, b in zip(tm.picks[(1, i)], jm.picks[(1, i)]):
            assert a[0] == b[0] and a[2] == b[2]
            np.testing.assert_array_equal(a[1], b[1])
    # an empty dataset predicts the bare correction, drawing nothing
    empty = NNGPScipy(2, 40)
    empty.fit(Dataset.empty(8, 2, device="cpu"), 0)
    state = empty.rng.bit_generator.state
    uF = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert torch.equal(empty.predict_fn(None, zt, uF, 0.5 * uF, 0),
                       0.5 * uF)
    assert empty.rng.bit_generator.state == state


@pytest.fixture(scope="module")
def fhn_runs():
    pj, pt = fhn_pair()
    jm = JScipy(2, 40, nn=15, record=True)
    tm = NNGPScipy(2, 40, nn=15, record=True)
    kw = dict(early_stop=1, measure_serial_fine=False)
    oj, ot = pj.run(model=jm, **kw), pt.run(model=tm, **kw)
    pc, _ = fhn_pair(nudge=4e-16)
    oc = pc.run(model="nngp_scipy", nn=15, **kw)
    return (oj, jm), (ot, tm), oc


def test_fhn_one_iteration_against_jax(fhn_runs):
    (oj, jm), (ot, tm), oc = fhn_runs
    assert ot["k"] == oj["k"] == 1 and np.isfinite(ot["err"]).all()
    assert sorted(tm.picks) == sorted(jm.picks) and tm.picks
    pairs = [(a, b) for key in jm.picks
             for a, b in zip(tm.picks[key], jm.picks[key])]
    assert all(abs(a[0] - b[0]) <= tm.fatol for a, b in pairs)
    same = sum(_picks_equal(a, b) for a, b in pairs)
    assert same >= 0.9 * len(pairs), (same, len(pairs))
    gap = np.abs(ot["u"] - oj["u"]).max()
    assert gap <= 10.0 * np.abs(oc["u"] - oj["u"]).max()


def test_model_keys_reach_the_oracle():
    _, pt = fhn_pair()
    for key in ("nngp_scipy", "nngp_oracle"):
        mdl = pt._make_model(key, dict(nn=7, seed=3, optimizer="grid"))
        assert isinstance(mdl, NNGPScipy) and (mdl.nn, mdl.seed) == (7, 3)


def test_scipy_fine_matches_rk_and_jax():
    ode = nt.FHNODE(normalization="-11", device="cpu")
    f = ode.get_vector_field()
    rk = nt.RKSolver(f, 4, 1500, G="RK2", F="RK4", device="cpu")
    sp = nt.ScipySolver(f, 4, 1500, G="RK2", F="RK4", rtol=1e-9, atol=1e-11,
                        device="cpu")
    u0 = ode.get_init_cond()
    a = rk.run_F(0.0, 1.0, u0).numpy()
    b = sp.run_F(0.0, 1.0, u0).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(sp.run_G(0.0, 1.0, u0).numpy(),
                                  rk.run_G(0.0, 1.0, u0).numpy())
    # against JAX's, at 100 steps: its field is called eagerly, ~1 ms a
    # call
    oj = jt.FHNODE(normalization="-11")
    jsp = jt.ScipySolver(oj.get_vector_field(), 4, 100, G="RK2", F="RK4",
                         rtol=1e-9, atol=1e-11)
    sp100 = nt.ScipySolver(f, 4, 100, G="RK2", F="RK4", rtol=1e-9,
                           atol=1e-11, device="cpu")
    want = np.asarray(jsp.run_F(0.0, 1.0, oj.get_init_cond()))
    np.testing.assert_allclose(sp100.run_F(0.0, 1.0, u0).numpy(), want,
                               rtol=1e-12, atol=0)
    # the batch: slices one after another, back on the solver's device
    U = torch.stack([u0, u0 + 0.01])
    out = sp.run_F_batch([0.0, 0.5], [0.5, 1.0], U)
    assert out.shape == (2, 2) and out.dtype == torch.float64
    np.testing.assert_array_equal(out[1].numpy(),
                                  sp.run_F(0.5, 1.0, U[1]).numpy())


@pytest.mark.skipif(not RUN_SLOW, reason="scipy fine solves through a "
                    "torch field are minutes on the CPU")
def test_parareal_with_scipy_solver():
    ode = nt.FHNODE(normalization="-11", device="cpu")
    sp = nt.ScipySolver(ode.get_vector_field(), 4, 400, G="RK2", F="RK4",
                        device="cpu")
    p = nt.Parareal(ode, sp, [0, 8], 8, epsilon=5e-7, verbose=None,
                    device="cpu")
    out = p.run(model="parareal", measure_serial_fine=False)
    assert out["converged"] and out["k"] <= 8


@pytest.mark.skipif(not RUN_SLOW, reason="scipy Nelder-Mead per task is "
                    "minutes on the CPU")
def test_hopf_nngp_scipy_oracle_k9():
    ode = nt.Hopf(normalization="-11", device="cpu")
    cfg = nt.Config(ode, N=32).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], 32, epsilon=5e-7, verbose=None,
                    device="cpu")
    out = p.run(model="nngp_scipy", nn=15, measure_serial_fine=False)
    assert out["converged"] and out["k"] == 9
