"""Port parity for models/gp.py: GParareal's fit on frozen datasets.

The port's ``GParareal`` against the JAX package's on the same numpy-seeded
padded datasets (2 coordinates; 24 valid rows in a 32-row bucket, below
the 48-row switch, and 100 in a 128-row bucket, above it; a masked hole
among the valid rows), ``fit`` at k=1:

* Well-conditioned data (rough targets) from a warm start inside the
  factorable region: the same jitter picks; thetas within the search's
  ``xatol`` and NLLs within its ``fatol`` (Nelder-Mead; both searches
  stop once a simplex spans less than that), equal grid picks and NLLs
  within 1e-12 relative (grid); alpha within 1e-8 of max|alpha| (the
  measured gap is 1e-14).
* Near-singular Grams, where a pick is a near tie, are in
  tests/test_torch_gparareal_ties.py.
* The grid search's result does not depend on its batch sizes
  (``grid_chunk``, ``grid_task_chunk``): bitwise.
* ``fit_rows_cap`` fits the newest valid rows and scatters alpha back to
  their rows; ``score_rows_cap`` scores on the newest rows and keeps the
  posterior on the whole window; both as JAX's, at small caps.
* The prediction, the checkpoint state (a JAX GParareal's state resumes
  in the port, its generator included), the settings and the refusals.

The random-restart rescue and the posterior validation are in
tests/test_torch_gparareal_rescue.py; whole runs in
tests/test_torch_gparareal_cut*.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nngparareal_tpu.models.base import Dataset as JDataset
from nngparareal_tpu.models.gp import GParareal as JGP

from nngparareal_torch.models import Dataset, GParareal
from nngparareal_torch.parallel import make_mesh

TOL = 1e-6  # the searches' fatol and xatol here
SIZES = [(24, 32, 12), (100, 128, 50)]  # (valid rows, bucket, N)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rows, cap, rough=True, n=2, seed=3):
    rng = np.random.default_rng(seed)
    X = np.zeros((cap, n))
    D = np.zeros((cap, n))
    V = np.zeros(cap)
    X[:rows] = rng.uniform(-1, 1, (rows, n))
    if rough:
        D[:rows] = rng.normal(size=(rows, n)) * 1e-3
    else:
        D[:rows] = np.stack([np.sin(2 * X[:rows, 0]) * 1e-3,
                             X[:rows, 1] ** 2 * 1e-3], 1)
    V[:rows] = 1.0
    V[3] = 0.0
    return X, D, V


def _both(X, D, V, N, k=1, **kw):
    """The JAX and the port's GParareal fitted on (X, D, V)."""
    j = JGP(2, N, **kw)
    j.fit(JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(V)), k)
    t = GParareal(2, N, **kw)
    t.fit(Dataset(torch.tensor(X), torch.tensor(D), torch.tensor(V)), k)
    return j, t


def _alpha_gap(j, t):
    aj = np.asarray(j.state[2])
    return np.abs(aj - t.state[2].numpy()).max() / np.abs(aj).max()


@pytest.mark.parametrize("rows,cap,N", SIZES)
@pytest.mark.parametrize("opt", ["nm", "grid"])
def test_fit_matches_jax(opt, rows, cap, N):
    X, D, V = _data(rows, cap)
    j, t = _both(X, D, V, N, optimizer=opt, fatol=TOL, xatol=TOL,
                 theta=[0.05, 0.001])
    np.testing.assert_array_equal(t.jitter_sel, j.jitter_sel)
    if opt == "nm":
        assert np.abs(t.thetas - j.thetas).max() <= TOL
        assert np.abs(t.fvals - j.fvals).max() <= TOL
    else:
        np.testing.assert_array_equal(t.thetas, j.thetas)
        np.testing.assert_allclose(t.fvals, j.fvals, rtol=1e-12, atol=0)
    assert _alpha_gap(j, t) <= 1e-8
    assert t.fit_buckets == [cap]
    assert np.abs(t.hyp - j.hyp).max() <= (TOL if opt == "nm" else 0.0)


@pytest.mark.parametrize("rows,cap,N", SIZES)
def test_grid_result_does_not_depend_on_its_batches(rows, cap, N):
    X, D, V = _data(rows, cap, rough=False)
    ds = Dataset(torch.tensor(X), torch.tensor(D), torch.tensor(V))
    fits = []
    for kw in (dict(), dict(grid_chunk=7, grid_task_chunk=5)):
        m = GParareal(2, N, optimizer="grid", **kw)
        m.fit(ds, 1)
        fits.append(m)
    a, b = fits
    np.testing.assert_array_equal(a.thetas, b.thetas)
    np.testing.assert_array_equal(a.jitter_sel, b.jitter_sel)
    np.testing.assert_array_equal(a.fvals, b.fvals)
    assert torch.equal(a.state[2], b.state[2])


def _rough_big(cap=128, n=2, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(cap, n))
    D = rng.normal(size=(cap, n)) * 1e-3
    V = np.ones(cap)
    V[40:45] = 0.0  # a hole mid-dataset
    return X, D, V


def test_fit_rows_cap_windows_the_newest_rows_as_jax():
    X, D, V = _rough_big()
    N = 16
    k = X.shape[0] // N - 1  # rows = (k+1)*N = 128 > the cap
    j, t = _both(X, D, V, N, k=k, optimizer="grid", fit_rows_cap=64)
    alpha = t.state[2].numpy()
    newest = np.where(V > 0)[0][-64:]
    outside = np.setdiff1d(np.arange(X.shape[0]), newest)
    assert np.abs(alpha[:, outside]).max() == 0.0
    assert np.abs(alpha[:, newest]).min() > 0.0
    assert t.fit_buckets == [64]
    np.testing.assert_array_equal(t.thetas, j.thetas)
    np.testing.assert_array_equal(t.jitter_sel, j.jitter_sel)
    assert _alpha_gap(j, t) <= 1e-8


def test_score_rows_cap_scores_newest_rows_as_jax():
    X, D, V = _rough_big()
    N = 16
    k = X.shape[0] // N - 1
    j, t = _both(X, D, V, N, k=k, optimizer="grid", score_rows_cap=32)
    np.testing.assert_array_equal(t.thetas, j.thetas)
    np.testing.assert_array_equal(t.jitter_sel, j.jitter_sel)
    assert _alpha_gap(j, t) <= 1e-8
    # the posterior spans the whole window, not just the scored rows
    assert (t.state[2].abs() > 0).sum() > 32 * 2
    assert t.alpha_unusable == []
    # and the scores differ from a fit that scores every row
    full = GParareal(2, N, optimizer="grid", score_rows_cap=None)
    full.fit(Dataset(torch.tensor(X), torch.tensor(D), torch.tensor(V)), k)
    assert not np.array_equal(full.fvals, t.fvals)


def test_predict_matches_jax():
    X, D, V = _data(100, 128)
    j, t = _both(X, D, V, 50, optimizer="grid")
    rng = np.random.default_rng(4)
    for _ in range(5):
        q = rng.uniform(-1, 1, size=2)
        want = np.asarray(j.predict_fn(
            j.state_pytree(), JDataset(jnp.asarray(X), jnp.asarray(D),
                                       jnp.asarray(V)),
            jnp.asarray(q), None, None, None, 0))
        got = t.predict_fn(
            Dataset(torch.tensor(X), torch.tensor(D), torch.tensor(V)),
            torch.tensor(q), None, None, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(D).max())


def test_settings_and_refusals_match_jax():
    j, t = JGP(3, 40), GParareal(3, 40)
    for key in ("name", "fatol", "xatol", "nm_max_iters", "optimizer",
                "alpha_res_tol", "fit_rows_cap", "score_rows_cap",
                "grid_chunk", "grid_task_chunk", "score_dtype"):
        assert getattr(t, key) == getattr(j, key), key
    for key in ("theta0", "thetas", "jitter_sel", "hyp", "_jitters",
                "_grid_logs"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
    assert t._refine_half_span == j._refine_half_span
    # score_lanes and a mesh are kept as the JAX package keeps them: a
    # mesh of one device shards nothing
    assert (GParareal(3, 40, score_lanes=True).score_lanes
            == JGP(3, 40, score_lanes=True).score_lanes is True)
    assert t.score_lanes is j.score_lanes is False
    mesh = make_mesh(devices=["cpu"] * 2)
    assert GParareal(3, 40, mesh=mesh).mesh is mesh
    assert GParareal(3, 40, mesh=make_mesh(devices=["cpu"])).mesh is None
    assert t.mesh is j.mesh is None
    with pytest.raises(ValueError):
        GParareal(3, 40, optimizer="lbfgs")
    with pytest.raises(ValueError):
        GParareal(3, 40, score_dtype="float16")


def test_jax_checkpoint_state_resumes_in_the_port():
    X, D, V = _data(24, 32)
    j = JGP(2, 12, optimizer="grid")
    j.fit(JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(V)), 1)
    j.rng.uniform(size=3)  # move its generator
    j.alpha_rejects.append(dict(k=1, coord=0, rel=1.0, to=(-18.0, [1, 2])))
    state = j.get_ckpt_state()
    t = GParareal(2, 12, optimizer="grid")
    t.set_ckpt_state(state)
    np.testing.assert_array_equal(t.thetas, j.thetas)
    np.testing.assert_array_equal(t.jitter_sel, j.jitter_sel)
    np.testing.assert_array_equal(t.hyp, j.hyp)
    assert t.k == j.k == 1
    assert t.alpha_rejects == j.alpha_rejects and t.alpha_unusable == []
    np.testing.assert_array_equal(t.rng.uniform(size=4),
                                  j.rng.uniform(size=4))
    # and the port's own state round-trips
    u = GParareal(2, 12, optimizer="grid")
    u.set_ckpt_state(t.get_ckpt_state())
    np.testing.assert_array_equal(u.thetas, t.thetas)
    assert u.get_times()["alpha_rejects"] == 1
