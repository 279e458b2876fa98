"""Port parity for the comparison models: kNN-mean (models/knn_mean.py)
and the ELM (models/elm.py), against the JAX package on the CPU.

* kNN-mean's prediction on a padded dataset with invalid rows and exact
  duplicates, at m = 5, 15 and past the valid rows: rtol 1e-13.
* The ELM's degree-2 features and its four activations (the reference's
  misspelled ``radbad`` among them): 1e-13. Its projection (bias and C)
  is drawn bitwise as JAX's from one seed, and
  ``convert.elm_params_from_jax`` carries JAX's arrays across.
* The ELM's prediction: its ridge system has at most m = 10 rows of H
  against res_size = 20 columns and a ridge of 1e-10, so the directions H
  does not span are fixed by the ridge alone and two LU solves part there
  by far more than one rounding. The control is the JAX package against
  itself with the dataset's X moved by 4e-16 (each entry up or down, three
  sign draws), as tests/test_torch_gparareal_ties.py moves it: that moves
  the ridge system by a rounding, as the two packages' matrix products
  do. (A move of the query alone reaches only the new point's features,
  never the near-singular system: it moves JAX's prediction by ~1e-17
  where the two packages part by up to 1e-10.) The port lies within 10x
  the control's gap.
* End to end on FHN cut to its first 16 slices with Nf // 10 (the cut of
  tests/test_torch_table2_nm_cut_rk8.py): kNN-mean (nn=15) and the ELM
  (m=10, res_size=20) reach JAX's K and conv_int, and the final iterates
  agree within 1e-9 of max|u|. The full FHN runs (K=39 and K=14, the JAX
  package's on the CPU) take 39 and 14 plain fan-outs here: RUN_SLOW=1,
  and on the card in chip_smoke.py.

``fhn_pair`` also serves the other files of this slice.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models import elm as jelm
from nngparareal_tpu.models.knn_mean import KNNMean as JKNN

import nngparareal_torch as nt
from nngparareal_torch.convert import elm_params_from_jax
from nngparareal_torch.models import ELM, Dataset, KNNMean
from nngparareal_torch.models import elm as telm

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
EPS = 5e-7
NUDGE = 4e-16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut(factor, slices):
    """Nf // factor, and the first ``slices`` slices of the configured
    width (as tests/test_torch_table2_nm_cut_rk8.py cuts)."""
    def edit(cfg):
        cfg["Nf"] //= factor
        width = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
        cfg["tspan"] = [cfg["tspan"][0], cfg["tspan"][0] + slices * width]
        cfg["N"] = slices
    return edit


def fhn_pair(edit=None, nudge=0.0, sign_seed=0):
    """FHN's Parareal in both packages (JAX's, the port's on the CPU), at
    its Config changed by ``edit``; JAX's u0 moved by ``nudge`` (each
    coordinate up or down by a draw of ``sign_seed``) for a control."""
    pars = []
    for pkg, kw in ((jt, {}), (nt, {"device": "cpu"})):
        ode = pkg.FHNODE(normalization="-11", **kw)
        cfg = pkg.Config(ode).get()
        if edit:
            edit(cfg)
        s = pkg.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"], **kw)
        pars.append(pkg.Parareal(ode, s, cfg["tspan"], cfg["N"],
                                 epsilon=EPS, verbose=None, **kw))
    pj, pt = pars
    if nudge:
        signs = np.random.default_rng(sign_seed).choice([-1.0, 1.0],
                                                        pj.u0.shape)
        pj.u0 = pj.u0 + nudge * signs
    return pj, pt


def _padded(seed=0, cap=64, rows=40, n=3):
    """A padded dataset: ``rows`` valid rows of ``cap``, two of them
    masked out (converged slices), three exact duplicates."""
    rng = np.random.default_rng(seed)
    X = np.zeros((cap, n))
    D = np.zeros((cap, n))
    X[:rows] = rng.standard_normal((rows, n))
    D[:rows] = 1e-3 * rng.standard_normal((rows, n))
    X[30:33] = X[12]  # a frozen slice appends identical states
    valid = np.zeros(cap)
    valid[:rows] = 1.0
    valid[[5, 21]] = 0.0
    return X, D, valid


def _jax_pred(model, X, D, valid):
    @jax.jit
    def pred(q):
        z = jnp.zeros(X.shape[1])
        ds = JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(valid))
        return model.predict_fn((), ds, q, z, z, None, jnp.asarray(0))
    return lambda q: np.asarray(pred(jnp.asarray(q)))


def _port_pred(model, X, D, valid):
    ds = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                 torch.as_tensor(valid))
    z = torch.zeros(X.shape[1], dtype=torch.float64)
    return lambda q: model.predict_fn(ds, torch.as_tensor(q), z, z,
                                      0).numpy()


@pytest.mark.parametrize("nn", [5, 15, 60])
def test_knn_mean_predict_matches_jax(nn):
    X, D, valid = _padded()
    want_fn = _jax_pred(JKNN(3, 8, nn=nn), X, D, valid)
    got_fn = _port_pred(KNNMean(3, 8, nn=nn), X, D, valid)
    rng = np.random.default_rng(1)
    # a duplicated row, a masked-out row and two fresh points
    for q in (X[12], X[5], rng.standard_normal(3), X[0] + 1e-9):
        want, got = want_fn(q), got_fn(q)
        np.testing.assert_allclose(got, want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max())


def test_knn_mean_adaptive_m_matches_jax():
    jm, tm = JKNN(3, 8, nn="adaptive"), KNNMean(3, 8, nn="adaptive")
    assert [tm.m_for(k) for k in range(30)] == [jm.m_for(k)
                                                for k in range(30)]


@pytest.mark.parametrize("shape", [(5,), (7, 3), (4, 2, 6)])
def test_poly2_matches_jax(shape):
    x = np.random.default_rng(2).standard_normal(shape)
    f = jelm._poly2
    for _ in shape[:-1]:
        f = jax.vmap(f)
    want = np.asarray(f(jnp.asarray(x)))
    got = telm._poly2(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == shape[:-1] + (telm.n_poly2(shape[-1]),)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert telm.n_poly2(shape[-1]) == jelm.n_poly2(shape[-1])


@pytest.mark.parametrize("loss", sorted(jelm._LOSSES))
def test_activations_match_jax(loss):
    assert sorted(telm._LOSSES) == sorted(jelm._LOSSES)
    z = 3.0 * np.random.default_rng(3).standard_normal(200)
    want = np.asarray(jelm._LOSSES[loss](jnp.asarray(z)))
    got = telm._LOSSES[loss](torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("seed,n,res", [(47, 2, 20), (3, 3, 50)])
def test_elm_projection_bitwise_and_carried_across(seed, n, res):
    jm = jelm.ELM(n, 8, seed=seed, res_size=res)
    tm = ELM(n, 8, seed=seed, res_size=res)
    np.testing.assert_array_equal(tm._bias, np.asarray(jm._bias))
    np.testing.assert_array_equal(tm._C, np.asarray(jm._C))
    other = ELM(n, 8, seed=seed + 1, res_size=res)
    assert not np.array_equal(other._C, tm._C)
    other.set_projection(**elm_params_from_jax(np.asarray(jm._bias),
                                               np.asarray(jm._C)))
    np.testing.assert_array_equal(other._C, np.asarray(jm._C))
    with pytest.raises(TypeError, match="JAX object"):
        elm_params_from_jax(jm._bias, jm._C)
    with pytest.raises(ValueError, match="shapes"):
        elm_params_from_jax(np.asarray(jm._C), np.asarray(jm._C))


def test_elm_predict_within_the_jax_control():
    X, D, valid = _padded(seed=4)
    kw = dict(seed=47, m=10, res_size=20)
    want_fn = _jax_pred(jelm.ELM(3, 8, **kw), X, D, valid)
    got_fn = _port_pred(ELM(3, 8, **kw), X, D, valid)
    rng = np.random.default_rng(5)
    controls = []
    for s in range(3):
        signs = np.random.default_rng(s).choice([-1.0, 1.0], X.shape)
        controls.append(_jax_pred(jelm.ELM(3, 8, **kw),
                                  X * (1.0 + NUDGE * signs), D, valid))
    for q in (X[12], X[0] + 1e-3, rng.standard_normal(3)):
        want = want_fn(q)
        gap = np.abs(got_fn(q) - want).max()
        ctl = max(np.abs(c(q) - want).max() for c in controls)
        assert np.isfinite(want).all()
        assert gap <= 10.0 * max(ctl, 1e-15 * np.abs(want).max()), (gap, ctl)


def _end_to_end(model, edit, **kw):
    pj, pt = fhn_pair(edit)
    oj = pj.run(model=model, measure_serial_fine=False, **kw)
    ot = pt.run(model=model, measure_serial_fine=False, **kw)
    assert ot["k"] == oj["k"] and ot["converged"] == oj["converged"]
    assert ot["conv_int"] == oj["conv_int"]
    np.testing.assert_allclose(ot["u"], oj["u"], rtol=0,
                               atol=1e-9 * np.abs(oj["u"]).max())
    return oj


@pytest.mark.parametrize("model,kw", [("knn_mean", dict(nn=15)),
                                      ("elm", dict(m=10, res_size=20))])
def test_cut_fhn_end_to_end_matches_jax(model, kw):
    out = _end_to_end(model, cut(10, 16), **kw)
    assert out["converged"]


@pytest.mark.skipif(not RUN_SLOW, reason="39 and 14 plain fan-outs of the "
                    "full FHN: minutes on the CPU (the card runs them)")
@pytest.mark.parametrize("model,kw,k", [("knn_mean", dict(nn=15), 39),
                                        ("elm", dict(m=10, res_size=20), 14)])
def test_full_fhn_end_to_end_matches_jax(model, kw, k):
    assert _end_to_end(model, None, **kw)["k"] == k
