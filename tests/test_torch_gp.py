"""Port parity: neighbour selection, distances and the lane-major GP
kernels against the JAX package.

Tolerance rtol 1e-12 for values, plus atol 1e-300 where a value can be
subnormal: XLA on the CPU flushes subnormal results to zero, torch keeps
them (a Gram entry exp(-huge) is 2e-310 in one and 0 in the other). Indices, and the positions of +inf
(``nll_lanes``) and NaN (``cholesky_lanes``, ``posterior_mean_lanes``),
must be equal: they decide which candidates and predictions the nnGP
search keeps.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nngparareal_tpu.ops import gp as jgp
from nngparareal_tpu.ops import gp_lanes as jlanes
from nngparareal_tpu.ops.nn_select import nearest_neighbors as j_nn

from nngparareal_torch.ops import gp as tgp
from nngparareal_torch.ops import gp_lanes as tlanes
from nngparareal_torch.ops.nn_select import nearest_neighbors as t_nn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-12
TINY = 1e-300  # below it XLA:CPU flushes to zero

_j_nll = jax.jit(jlanes.nll_lanes)
_j_post = jax.jit(jlanes.posterior_mean_lanes)
_j_chol = jax.jit(jlanes.cholesky_lanes)


def _t(x):
    return torch.as_tensor(np.array(x))


def _dataset_with_ties(seed=0, cap=64, n=5):
    """Rows with exact duplicates (a frozen slice appends identical states)
    and invalid padding rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(cap, n))
    X[10] = X[3]
    X[11] = X[3]
    X[40] = X[3]
    X[20:24] = X[7]
    valid = np.ones(cap)
    valid[50:] = 0.0
    valid[11] = 0.0  # a duplicate that is masked out
    return X, valid


@pytest.mark.parametrize("qrow", [3, 7, None])
def test_nearest_neighbors_tie_order(qrow):
    X, valid = _dataset_with_ties()
    q = X[qrow] if qrow is not None else X[3] + 1e-3
    m = 18
    ij, dj = jax.jit(j_nn, static_argnums=3)(jnp.asarray(q), jnp.asarray(X),
                                             jnp.asarray(valid), m)
    it, dt = t_nn(_t(q), _t(X), _t(valid), m)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL)


def test_nearest_neighbors_fewer_valid_than_m():
    X, valid = _dataset_with_ties()
    valid[:] = 0.0
    valid[[5, 3, 10]] = 1.0
    ij, dj = jax.jit(j_nn, static_argnums=3)(jnp.asarray(X[0]), jnp.asarray(X),
                                             jnp.asarray(valid), 6)
    it, dt = t_nn(_t(X[0]), _t(X), _t(valid), 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert np.array_equal(np.isinf(dt.numpy()), np.isinf(np.asarray(dj)))


def test_pairwise_and_query_distances():
    X, _ = _dataset_with_ties(seed=1, cap=64, n=16)
    np.testing.assert_allclose(
        tgp.pairwise_sq_dists(_t(X[:18]), _t(X)).numpy(),
        np.asarray(jgp.pairwise_sq_dists(jnp.asarray(X[:18]), jnp.asarray(X))),
        rtol=RTOL, atol=0)
    np.testing.assert_allclose(
        tgp.sq_dists_to(_t(X[2]), _t(X)).numpy(),
        np.asarray(jgp.sq_dists_to(jnp.asarray(X[2]), jnp.asarray(X))),
        rtol=RTOL, atol=0)


def _gp_problem(seed, near_singular):
    """m=18 local GP: distances, targets, candidates, mask."""
    rng = np.random.default_rng(seed)
    m, n, B = 18, 6, 40
    X = rng.normal(size=(m, 4))
    if near_singular:
        X[5] = X[2]
        X[9] = X[2]
        X[12] = X[4]
    Y = rng.normal(size=(m, n))
    theta = rng.uniform(-8.0, 0.0, (B, 2))
    jit = rng.choice(np.arange(-20.0, -11.0), B)
    if near_singular:
        jit[:12] = -20.0  # jitter 1e-20: below f64 resolution of the Gram
        theta[:6, 1] = 0.0
        theta[:6, 0] = 2.0  # long length scale: rank-deficient Gram
    mask = np.ones(m)
    mask[16:] = 0.0
    sqd = np.asarray(jgp.pairwise_sq_dists(jnp.asarray(X), jnp.asarray(X)))
    return sqd, Y, theta, jit, mask


def _assert_same_nonfinite(got, want):
    for kind in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(kind(got), kind(want), kind.__name__)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=TINY)


@pytest.mark.parametrize("near_singular", [False, True])
def test_cholesky_lanes(near_singular):
    """The port sums each column's update as the jitted JAX function does
    (a fused multiply-add after another): NaN and +-inf sit at the same
    places. Against the JAX function run op by op (no fused multiply-adds)
    the non-finite places are the same, but an entry divided by an
    exactly-zero pivot may be NaN in one and inf in the other. Values are
    held against the op-by-op function only for candidates whose pivots
    are all sound."""
    sqd, Y, theta, jit, mask = _gp_problem(2, near_singular)
    K = jlanes.k_se_log10_lanes(jnp.asarray(sqd), jnp.asarray(theta))
    A = np.asarray(jlanes.masked_gram_lanes(K, jnp.asarray(mask), jnp.asarray(jit)))
    A_t = tlanes.masked_gram_lanes(
        tlanes.k_se_log10_lanes(_t(sqd), _t(theta)), _t(mask), _t(jit))
    np.testing.assert_allclose(A_t.numpy(), A, rtol=RTOL, atol=TINY)
    got = tlanes.cholesky_lanes(_t(A)).numpy()
    eager = np.asarray(jlanes.cholesky_lanes(jnp.asarray(A)))
    if near_singular:
        assert np.isnan(eager).any(), "the case must include failed pivots"
    jitted = np.asarray(_j_chol(jnp.asarray(A)))
    _assert_same_nonfinite(got, jitted)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(eager))
    # values where the factorisation is well away from breakdown: next to
    # a pivot that is rounding noise, any reordering changes O(1) digits
    piv = np.abs(np.einsum("iib->ib", eager))
    sound = np.all(piv > 1e-6 * piv.max(axis=0), axis=0)
    assert sound.all() or near_singular
    # norm-wise: an entry formed by cancellation carries rounding relative
    # to its column, not to itself
    ref = eager[..., sound]
    np.testing.assert_allclose(got[..., sound], ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("near_singular", [False, True])
@pytest.mark.parametrize("per_task", [False, True])
def test_nll_lanes(near_singular, per_task):
    sqd, Y, theta, jit, mask = _gp_problem(3, near_singular)
    if per_task:  # (m, 1, B): task b scores its own target column
        Y = np.random.default_rng(4).normal(size=(sqd.shape[0], 1, len(jit)))
    want = np.asarray(_j_nll(jnp.asarray(sqd), jnp.asarray(Y),
                             jnp.asarray(theta), jnp.asarray(jit),
                             jnp.asarray(mask)))
    got = tlanes.nll_lanes(_t(sqd), _t(Y), _t(theta), _t(jit), _t(mask)).numpy()
    if near_singular:
        assert np.isposinf(want).any(), "the case must include failed pivots"
    assert not np.isnan(got).any()
    _assert_same_nonfinite(got, want)


@pytest.mark.parametrize("near_singular", [False, True])
def test_posterior_mean_lanes(near_singular):
    sqd, Y, theta, jit, mask = _gp_problem(5, near_singular)
    B = Y.shape[1]
    theta, jit = theta[:B], jit[:B]
    if near_singular:
        theta[:3] = (2.0, 0.0)
    sqd_q = np.random.default_rng(6).uniform(0.0, 4.0, sqd.shape[0])
    want = np.asarray(_j_post(jnp.asarray(sqd), jnp.asarray(sqd_q),
                              jnp.asarray(Y), jnp.asarray(theta),
                              jnp.asarray(jit), jnp.asarray(mask)))
    got = tlanes.posterior_mean_lanes(_t(sqd), _t(sqd_q), _t(Y), _t(theta),
                                      _t(jit), _t(mask)).numpy()
    if near_singular:
        assert np.isnan(want).any(), "the case must include failed pivots"
    _assert_same_nonfinite(got, want)


def test_triangular_solves():
    rng = np.random.default_rng(8)
    m, r, B = 18, 3, 7
    Lt = np.tril(rng.normal(size=(B, m, m))) + 4.0 * np.eye(m)
    L = np.moveaxis(Lt, 0, -1)  # (m, m, B)
    Y = rng.normal(size=(m, r, B))
    np.testing.assert_allclose(
        tlanes.solve_lower_lanes(_t(L), _t(Y)).numpy(),
        np.asarray(jlanes.solve_lower_lanes(jnp.asarray(L), jnp.asarray(Y))),
        rtol=RTOL, atol=0)
    U = np.swapaxes(L, 0, 1)
    np.testing.assert_allclose(
        tlanes.solve_upper_lanes(_t(U), _t(Y)).numpy(),
        np.asarray(jlanes.solve_upper_lanes(jnp.asarray(U), jnp.asarray(Y))),
        rtol=RTOL, atol=0)
