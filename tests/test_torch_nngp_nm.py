"""Port parity: the nnGP with Nelder-Mead, the JAX package's default search.

* ``predict_fn`` against the JAX package's on one frozen dataset (Burgers
  d=16 states and defects, 60 valid rows in a padded buffer of 96, with
  exact duplicate rows; tests/test_torch_nngp.py builds it) with the same
  starts theta0, for one and two restarts: the predictions agree within
  rtol 1e-10 of max|prediction|, NaN where JAX has NaN.
* ``sweep_aux`` draws bitwise JAX's over three iterations, and after a
  checkpoint of the JAX model's state resumes in the port.
* ``m_for`` (``nn='adaptive'``), the task layout (coord, jitter, restart)
  and the grid search with ``grid_polish`` (a fixed-iteration Nelder-Mead
  from each jitter's best grid point) against JAX's.
* The lane-major kernels sum a leading axis in XLA's order on the CPU
  (a fused multiply-add after another) and take 10**x from ``std::pow``,
  as XLA does: those steps are bitwise JAX's on the same inputs, and a
  lane's NLL is the same whatever the number of lanes beside it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models import NNGParareal as JNNGP

from nngparareal_torch.models import Dataset, NNGParareal
from nngparareal_torch.ops import gp_lanes as tgl

from test_torch_nngp import N_SLICES, _frozen_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_DIM = 16
RTOL = 1e-10


@pytest.fixture(scope="module")
def frozen():
    return _frozen_dataset()


def _predict_both(frozen, k=3, **kw):
    """Each query's prediction from both packages, with the starts the
    models draw for iteration k (the JAX model's draw: the port's must be
    equal, tested below)."""
    X, D, valid, queries = frozen
    jm = JNNGP(n=N_DIM, N=N_SLICES, **kw)
    tm = NNGParareal(n=N_DIM, N=N_SLICES, **kw)
    jm.fit(None, k)
    tm.fit(None, k)
    jaux = jm.sweep_aux(k, N_SLICES, X.shape[0])
    taux = tm.sweep_aux(k, N_SLICES, X.shape[0])
    if jaux is None:
        assert taux is None
        jaux, taux = jnp.zeros((N_SLICES, 1)), None
    else:
        jaux = jaux["theta0"]
        np.testing.assert_array_equal(taux, np.asarray(jaux))

    @jax.jit
    def jpred(Xj, Dj, Vj, q, a):
        ds = JDataset(Xj, Dj, Vj)
        z = jnp.zeros(N_DIM)
        aux = {"theta0": a} if taux is not None else a
        return jm.predict_fn((), ds, q, z, z, aux, jnp.asarray(0))

    ds_t = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                   torch.as_tensor(valid))
    z = torch.zeros(N_DIM, dtype=torch.float64)
    out = []
    for i, q in enumerate(queries):
        want = np.asarray(jpred(jnp.asarray(X), jnp.asarray(D),
                                jnp.asarray(valid), jnp.asarray(q), jaux[i]))
        aux_i = None if taux is None else torch.as_tensor(taux[i])
        got = tm.predict_fn(ds_t, torch.as_tensor(q), z, z, i,
                            aux_i=aux_i).numpy()
        out.append((got, want))
    return out, tm


def _check(pairs, need=None):
    """Equal NaN places; the rest within RTOL; at least ``need`` queries
    (all by default) with a finite prediction."""
    finite = 0
    for got, want in pairs:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isfinite(want)
        if ok.any():
            finite += 1
            np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL,
                                       atol=RTOL * np.abs(want[ok]).max())
    assert finite >= (len(pairs) if need is None else need)


@pytest.mark.parametrize("kw", [dict(nn=18), dict(nn=12, n_restarts=2,
                                                  seed=7)])
def test_nm_predict_fn_matches_jax(frozen, kw):
    pairs, tm = _predict_both(frozen, **kw)
    _check(pairs)
    # each search stopped when every simplex had frozen, within the cap
    its = tm.nm_stats["iterations"]
    assert len(its) == len(pairs) and all(0 < i <= 200 for i in its)


def test_grid_polish_matches_jax(frozen):
    pairs, _ = _predict_both(frozen, nn=18, optimizer="grid",
                             grid_polish=30)
    # the third query is a duplicated dataset row: its polished search
    # picks a Gram whose factorisation fails in both packages
    _check(pairs, need=2)


def test_nm_predict_fn_adaptive_m_matches_jax(frozen):
    """``nn='adaptive'`` at iteration 11: m = 13 neighbours."""
    pairs, tm = _predict_both(frozen, k=11)
    assert tm.m_for(11) == 13
    _check(pairs)


def test_m_for_and_task_layout_match_jax():
    for nn in ("adaptive", 7, 15):
        jm, tm = JNNGP(n=3, N=8, nn=nn), NNGParareal(n=3, N=8, nn=nn)
        assert [tm.m_for(k) for k in range(40)] == [jm.m_for(k)
                                                    for k in range(40)]
    for kw in (dict(), dict(n_restarts=3), dict(optimizer="grid",
                                                n_restarts=3)):
        jm, tm = JNNGP(n=3, N=8, **kw), NNGParareal(n=3, N=8, **kw)
        assert tm.B == jm.B
        np.testing.assert_array_equal(
            tm._task_jitters(torch.float64, "cpu").numpy(),
            np.asarray(jm._jitter_vals))
        # task b scores coordinate b // per
        np.testing.assert_array_equal(np.arange(tm.B) // tm.per,
                                      np.asarray(jm._coord_idx))


def test_sweep_aux_draws_and_resume_match_jax():
    """Three iterations' draws (N intervals x B tasks x 2), then a new
    port model set from the JAX model's checkpoint state draws JAX's
    fourth; the grid search draws nothing."""
    jm = JNNGP(n=3, N=8, seed=11, n_restarts=2)
    tm = NNGParareal(n=3, N=8, seed=11, n_restarts=2)
    for k in range(3):
        want = np.asarray(jm.sweep_aux(k, 8, 64)["theta0"])
        got = tm.sweep_aux(k, 8, 64)
        assert got.shape == (8, 3 * 9 * 2, 2) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    resumed = NNGParareal(n=3, N=8, seed=11, n_restarts=2)
    resumed.set_ckpt_state(jm.get_ckpt_state())
    np.testing.assert_array_equal(
        resumed.sweep_aux(3, 8, 64), np.asarray(jm.sweep_aux(3, 8,
                                                             64)["theta0"]))
    assert NNGParareal(n=3, N=8, optimizer="grid").sweep_aux(0, 8) is None


def test_nm_needs_its_starts(frozen):
    X, D, valid, queries = frozen
    tm = NNGParareal(n=N_DIM, N=N_SLICES, nn=18)
    ds = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                 torch.as_tensor(valid))
    z = torch.zeros(N_DIM, dtype=torch.float64)
    with pytest.raises(ValueError, match="sweep_aux"):
        tm.predict_fn(ds, torch.as_tensor(queries[0]), z, z, 0)


# --- the lane-major kernels' rounding ---


def test_leading_axis_sums_are_xla_order():
    """``dot0`` and ``sum0`` against XLA's ``jnp.sum(a * b, axis=0)`` and
    ``jnp.sum(a, axis=0)``, ``pow10`` against ``10.0 ** x``: bitwise."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((17, 5, 33)) * np.exp(rng.uniform(-9, 9,
                                                              (17, 5, 33)))
    b = rng.standard_normal((17, 1, 33))
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=0))(a, b))
    got = tgl.dot0(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(a))
    np.testing.assert_array_equal(tgl.sum0(torch.as_tensor(a)).numpy(),
                                  want)
    x = rng.uniform(-22.0, 9.0, 1001)
    np.testing.assert_array_equal(
        tgl.pow10(torch.as_tensor(x)).numpy(),
        np.asarray(jax.jit(lambda v: 10.0 ** v)(jnp.asarray(x))))


def test_a_lanes_nll_does_not_depend_on_the_other_lanes(frozen):
    """The same candidate scores bitwise alike in a batch of 160 and
    alone, and its posterior factors it alike: near-duplicate rows and
    tiny jitters, where a pivot fails by rounding."""
    X, D, valid, _ = frozen
    rows = [20, 50, 51, 52] + list(range(21, 35))  # four equal rows
    rng = np.random.default_rng(3)
    Xs = X[rows]
    sqd = torch.as_tensor(((Xs[:, None] - Xs[None]) ** 2).sum(-1))
    y = torch.as_tensor(D[rows, :1])
    mask = torch.ones(18, dtype=torch.float64)
    th = torch.as_tensor(rng.uniform(-9.0, 0.0, (160, 2)))
    jit = torch.as_tensor(rng.uniform(-20.0, -12.0, 160))
    batch = tgl.nll_lanes(sqd, y[:, :, None], th, jit, mask)
    alone = torch.cat([tgl.nll_lanes(sqd, y[:, :, None], th[i:i + 1],
                                     jit[i:i + 1], mask)
                       for i in range(160)], dim=1)
    assert torch.equal(batch, alone)
    assert torch.isinf(batch).any() and torch.isfinite(batch).any()
    post = tgl.posterior_mean_lanes(sqd, sqd[0], y.expand(18, 160), th, jit,
                                    mask)
    # a finite score means the posterior's factorisation succeeded too
    assert torch.isfinite(post[torch.isfinite(batch[0])]).all()
