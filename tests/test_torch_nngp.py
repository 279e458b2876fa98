"""Port parity: the nnGP prediction (grid hyperparameter search + Cholesky
posterior) on one frozen dataset against the JAX package.

Dataset: Burgers d=16 ([-1,1]-normalised) states near the coarse
trajectory, with defects F(x) - G(x) as a parareal iteration appends them,
60 valid rows in a padded buffer of 96, including exact duplicate rows
(a frozen slice appends identical states). m=18, optimizer='grid'.
Tolerance rtol 1e-10 of max|prediction|.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models import NNGParareal as JNNGP

import nngparareal_torch as nt
from nngparareal_torch.models import Dataset, NNGParareal
from nngparareal_torch.ops.rk import make_batched_last_integrator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_SLICES, CAP, VALID = 16, 96, 60


def _frozen_dataset(seed=0):
    ode = nt.Burgers(d_x=16, normalization="-11", device="cpu")
    f = ode.get_vector_field()
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 5.9, N_SLICES + 1)
    s = nt.RKSolver(f, 4, 40, G="RK1", F="RK8", device="cpu")
    traj = s.run_G_chain(t, ode.get_init_cond()).numpy()[:-1]  # (16, 16)
    rows = np.concatenate([traj + rng.normal(scale=10.0 ** -e, size=traj.shape)
                           for e in (2, 3, 4, 6)])[:VALID]
    rows[50:53] = rows[20]  # exact duplicates
    t0s = np.tile(t[:-1], 4)[:VALID]
    t1s = t0s + (t[1] - t[0])
    X = torch.as_tensor(rows)
    uF = make_batched_last_integrator(f, "RK8", 40)(
        torch.as_tensor(t0s), torch.as_tensor(t1s), X)
    uG = make_batched_last_integrator(f, "RK1", 4)(
        torch.as_tensor(t0s), torch.as_tensor(t1s), X)
    Xp = np.zeros((CAP, 16))
    Dp = np.zeros((CAP, 16))
    valid = np.zeros(CAP)
    Xp[:VALID] = rows
    Dp[:VALID] = (uF - uG).numpy()
    valid[:VALID] = 1.0
    valid[[7, 33]] = 0.0  # rows of converged slices are masked out
    queries = np.stack([traj[5], traj[11] + 1e-5, rows[20]])
    return Xp, Dp, valid, queries


@pytest.fixture(scope="module")
def frozen():
    return _frozen_dataset()


def test_predict_fn_matches_jax(frozen):
    X, D, valid, queries = frozen
    jm = JNNGP(n=16, N=N_SLICES, nn=18, optimizer="grid")
    tm = NNGParareal(n=16, N=N_SLICES, nn=18, optimizer="grid")
    jm.fit(None, 3)
    tm.fit(None, 3)

    @jax.jit
    def jpred(Xj, Dj, Vj, q):
        ds = JDataset(Xj, Dj, Vj)
        z = jnp.zeros(16)
        return jm.predict_fn((), ds, q, z, z, jnp.zeros(1), jnp.asarray(0))

    ds_t = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                   torch.as_tensor(valid))
    z = torch.zeros(16, dtype=torch.float64)
    finite = 0
    for q in queries:
        want = np.asarray(jpred(jnp.asarray(X), jnp.asarray(D),
                                jnp.asarray(valid), jnp.asarray(q)))
        got = tm.predict_fn(ds_t, torch.as_tensor(q), z, z, 0).numpy()
        # NaN (a failed posterior factorisation: the driver falls back to
        # the bare correction) must be NaN in both
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isfinite(want)
        if ok.any():
            finite += 1
            np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10,
                                       atol=1e-10 * np.abs(want[ok]).max())
    assert finite >= 2


def test_unported_search_modes_raise():
    """Nelder-Mead, the JAX default, is ported, and so are the LOO
    selector, the LU posterior, reduced-precision scoring and the
    neighbour strategies: each is taken as given (tests/test_torch_loo_lu
    .py and tests/test_torch_strategies.py hold them against JAX); an
    unknown value raises."""
    assert NNGParareal(n=2, N=4, nn=18, optimizer="nm").optimizer == "nm"
    for kw in (dict(selector="loo"), dict(posterior="lu"),
               dict(score_dtype=torch.float32), dict(strategy="row")):
        mdl = NNGParareal(n=2, N=4, nn=18, **kw)
        assert all(getattr(mdl, k) == v for k, v in kw.items())
    with pytest.raises(ValueError, match="strategy"):
        NNGParareal(n=2, N=4, nn=18, strategy="rows")
