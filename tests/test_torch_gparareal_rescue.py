"""Port parity for GParareal's random-restart rescue and its posterior
validation (models/gp.py ``_rescue`` and ``_validate_alphas``), as
tests/test_gp_rescue.py and tests/test_gp_alpha_validation.py hold the
JAX package's, each case run in both packages on the same numpy-seeded
datasets:

* the rescue replaces a +inf coordinate with a finite NLL at a jitter of
  the grid, leaves the others alone, draws its starts from the model's
  generator as JAX does (the generator ends in the same state) and
  reaches JAX's optimum: |theta| within the search's xatol (the kernel
  reads sx squared, so its sign is free) and the NLL within its fatol.
  Several restarts, at different jitters, reach that optimum, and which
  of them wins is a near tie (here JAX's at 1e-20, the port's at 1e-16);
  with no rounds left it raises;
* the validation walks a failing pick down the per-jitter candidates (to
  the first whose solve is usable: on exactly duplicated points where a
  jitter of 1e-18 starts to suffice is a rounding-level tie, JAX stops at
  1e-17, the port at 1e-18), escalates the jitter per coordinate without candidates,
  counts and stamps an unusable posterior, stays silent on an all-invalid
  dataset, and every fit on duplicated points leaves a usable posterior
  (relative residual below ``alpha_res_tol``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nngparareal_tpu.models.base import Dataset as JDataset
from nngparareal_tpu.models.gp import GParareal as JGP

from nngparareal_torch.models import Dataset, GParareal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(ds):
    return ds.X, ds.D, ds.valid


def _pair(X, D, V):
    """The same dataset in both packages."""
    return (JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(V)),
            Dataset(torch.tensor(X), torch.tensor(D), torch.tensor(V)))


def _rescue_data(n=2, rows=12, cap=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(cap, n))
    D = 0.1 * rng.normal(size=(cap, n))
    V = np.zeros(cap)
    V[:rows] = 1.0
    return _pair(X, D, V)


def _rescue_args(mdl):
    th = np.tile(mdl.theta0, (mdl.n, 1))
    jv = np.full(mdl.n, -20.0)
    fv = np.array([np.inf, 1.0])
    return th, jv, fv, np.array([0])


def test_rescue_replaces_inf_coord_as_jax():
    jds, tds = _rescue_data()
    j, t = JGP(2, 9), GParareal(2, 9)
    thj, jvj, fvj = j._rescue(*_arrays(jds), *_rescue_args(j))
    tht, jvt, fvt = t._rescue(*_arrays(tds), *_rescue_args(t))
    assert np.isfinite(fvt).all() and np.isfinite(tht).all()
    assert fvt[1] == 1.0 and jvt[1] == -20.0  # untouched
    assert jvt[0] in t._jitters
    assert abs(fvt[0] - fvj[0]) <= t.fatol
    assert np.abs(np.abs(tht[0]) - np.abs(thj[0])).max() <= t.xatol
    # the same draws: both generators end in the same state
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_rescue_exhaustion_raises():
    _, tds = _rescue_data()
    t = GParareal(2, 9)
    with pytest.raises(RuntimeError, match="rescue failed"):
        t._rescue(*_arrays(tds), *_rescue_args(t), max_attempts=0)


def _dup_data(n=2, rows=24, cap=32, seed=7):
    """Exactly duplicated inputs: a kernel whose length-scale is much
    larger than the points' spread is rank-deficient."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(cap, n))
    X[rows // 2:rows] = X[: rows - rows // 2][: rows // 2]
    D = np.tanh(X @ rng.normal(size=(n, n))) * 0.1
    X[rows:] = 0.0
    D[rows:] = 0.0
    V = np.zeros(cap)
    V[:rows] = 1.0
    return _pair(X, D, V)


FAIL_TH = np.array([[1e6, 1.0], [1e6, 1.0]])


def _jax_fns(mdl):
    fns = mdl._get_fns(32)
    return fns[1], fns[4]


def _candidates(nj=9):
    th_nj = np.tile(np.array([1.0, 0.1]), (2, nj, 1))
    fv_nj = np.tile(np.arange(1.0, nj + 1.0), (2, 1))
    fv_nj[:, 0] = 0.0  # rank 0: the failing pick
    th_nj[:, 0] = FAIL_TH
    return th_nj, fv_nj


def _resid(t, tds, th, jv, alpha):
    return t._alpha_resid(*_arrays(tds), torch.as_tensor(th),
                          torch.as_tensor(jv), alpha)


def test_validate_swaps_to_usable_candidate_as_jax():
    jds, tds = _dup_data()
    j = JGP(2, 9, optimizer="grid")
    t = GParareal(2, 9, optimizer="grid")
    jv = np.array([-20.0, -20.0])
    alpha = t._alphas(*_arrays(tds), torch.tensor(FAIL_TH), torch.tensor(jv))
    assert not torch.isfinite(alpha).all()  # the hazard is real
    th2, jv2, _, alpha2 = t._validate_alphas(
        *_arrays(tds), FAIL_TH.copy(), jv.copy(), np.zeros(2), alpha,
        _candidates())
    alphas, resid = _jax_fns(j)
    ja = alphas(*_arrays(jds), jnp.asarray(FAIL_TH), jnp.asarray(jv))
    thj, jvj, _, _ = j._validate_alphas(
        alphas, resid, *_arrays(jds), FAIL_TH.copy(), jv.copy(),
        np.zeros(2), ja, _candidates())
    assert torch.isfinite(alpha2).all()
    assert t.alpha_rejects and j.alpha_rejects
    np.testing.assert_array_equal(th2, thj)
    assert set(jv2) | set(jvj) <= set(t._jitters[1:4])
    np.testing.assert_allclose(th2, np.tile([1.0, 0.1], (2, 1)))
    assert (_resid(t, tds, th2, jv2, alpha2) < t.alpha_res_tol).all()


@pytest.mark.parametrize("jv0", [(-20.0, -20.0), (-4.0, -20.0)])
def test_validate_escalates_jitter_per_coordinate_as_jax(jv0):
    """Without candidates (the Nelder-Mead path) the jitter rises; a
    coordinate already at the cap (-4) does not stop the others."""
    jds, tds = _dup_data()
    j = JGP(2, 9, optimizer="grid")
    t = GParareal(2, 9, optimizer="grid")
    jv = np.array(jv0)
    alpha = t._alphas(*_arrays(tds), torch.tensor(FAIL_TH), torch.tensor(jv))
    _, jv2, _, alpha2 = t._validate_alphas(
        *_arrays(tds), FAIL_TH.copy(), jv.copy(), np.zeros(2), alpha, None,
        n_valid=24)
    alphas, resid = _jax_fns(j)
    ja = alphas(*_arrays(jds), jnp.asarray(FAIL_TH), jnp.asarray(jv))
    _, jvj, _, _ = j._validate_alphas(
        alphas, resid, *_arrays(jds), FAIL_TH.copy(), jv.copy(),
        np.zeros(2), ja, None, n_valid=24)
    np.testing.assert_array_equal(jv2, jvj)
    assert jv2[1] > jv0[1]
    if jv0[0] < -4.0:
        assert torch.isfinite(alpha2).all()
        assert (jv2 > np.array(jv0)).all()


def test_unusable_fit_is_counted_and_stamped(capsys):
    _, tds = _dup_data()
    t = GParareal(2, 9, optimizer="grid")
    t.k = 3
    jv = np.array([-20.0, -20.0])
    alpha = t._alphas(*_arrays(tds), torch.tensor(FAIL_TH), torch.tensor(jv))
    t.alpha_res_tol = 1e-300  # every solve "fails": the walk exhausts
    t._validate_alphas(*_arrays(tds), FAIL_TH.copy(), jv.copy(), np.zeros(2),
                       alpha, None, n_valid=24)
    out = capsys.readouterr().out
    assert "k=3" in out and "24 valid rows" in out
    assert len(t.alpha_unusable) == 1
    assert t.get_times()["alpha_unusable"] == 1
    assert t.alpha_unusable[0]["n_valid"] == 24


@pytest.mark.parametrize("opt", ["grid", "nm"])
def test_fit_on_an_all_invalid_dataset_is_silent(opt, capsys):
    n, cap = 2, 32
    t = GParareal(n, 9, optimizer=opt)
    t.fit(Dataset.empty(cap, n, device="cpu"), 0)
    assert "posterior solve unusable" not in capsys.readouterr().out
    assert not t.alpha_unusable
    assert torch.isfinite(t.state[2]).all()


@pytest.mark.parametrize("opt", ["grid", "nm"])
def test_fit_posterior_always_usable_on_degenerate_data(opt):
    _, tds = _dup_data()
    t = GParareal(2, 9, optimizer=opt)
    t.fit(tds, 0)
    th, jv, alpha = t.state
    assert torch.isfinite(alpha).all()
    assert (_resid(t, tds, th, jv, alpha[:, :32]) < t.alpha_res_tol).all()
