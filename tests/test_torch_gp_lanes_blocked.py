"""The blocked lane-major GP NLL (``ops/gp_lanes.py``: ``k_se_linear_lanes``,
``cholesky_lanes_blocked``, ``solve_lower_lanes_blocked``,
``nll_lanes_big``) against the JAX package's, jitted, on the CPU.

m = 64 (four whole blocks of 16) and m = 80 with block 24 (three blocks
and a short last one of 8, padded with identity rows), B = 4 candidates, r = 3 target
columns, the last rows masked, from a numpy seed. Three candidates are
well conditioned (a short length scale and a jitter of 1e-4 or more); the
fourth has a long length scale and a jitter of 1e-20, so that its Gram is
singular to rounding and its factor fails: NaN in the factor and the
solve, +inf in the NLL, in both packages. The NLL's +inf positions are
equal; in the factor and the solve the well-conditioned candidates'
non-finite positions are equal (there are none), while the column at which
the failing candidate's pivot first goes non-positive is decided by
rounding (at m=64: 35 in the JAX package, 34 in the port), so there both
are only held to fail. Finite values agree to 1e-12 relative, or to 1e-300 absolute: XLA flushes
subnormal values to 0 on the CPU, torch keeps them, and the short length
scales make kernel values near and below 1e-308 (against values of order
1).
``pivot_floor`` (clamping each pivot against the original diagonal) is
held the same way at m = 64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nngparareal_tpu.ops import gp_lanes as J

from nngparareal_torch.ops import gp_lanes as T

RTOL = 1e-12
TINY = 1e-300  # XLA's subnormal flush, against values of order 1
SHAPES = [(64, 16), (80, 24)]  # (m, block)


def _problem(m, seed=0):
    """sqd (m, m), Y (m, 3), theta (4, 2) linear scale, jitter exponents
    (4,), mask (m,): candidate 3 fails."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (m, 3))
    sqd = ((X[:, None] - X[None]) ** 2).sum(-1)
    Y = rng.normal(size=(m, 3))
    theta = np.array([[0.05, 1.3], [0.08, 0.7], [0.1, 2.0], [30.0, 1.0]])
    jitter = np.array([-2.0, -3.0, -4.0, -20.0])
    mask = (np.arange(m) < m - 5).astype(float)
    return sqd, Y, theta, jitter, mask


def _same(got, want):
    """Equal non-finite positions (NaN as NaN, inf as inf), finite values
    to RTOL (or TINY: subnormals)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=TINY)


def _gram(m):
    sqd, Y, theta, jitter, mask = _problem(m)
    K = np.asarray(J.k_se_linear_lanes(jnp.asarray(sqd), jnp.asarray(theta)))
    A = np.asarray(J.masked_gram_lanes(jnp.asarray(K), jnp.asarray(mask),
                                       jnp.asarray(jitter)))
    return sqd, theta, K, A


def _fails_alike(got, want):
    """Lanes 0-2 held by ``_same``; lane 3 has NaN in both."""
    got, want = np.asarray(got), np.asarray(want)
    _same(got[..., :3], want[..., :3])
    assert np.isnan(got[..., 3]).any() and np.isnan(want[..., 3]).any()


@pytest.mark.parametrize("m,block", SHAPES)
def test_kernel_factor_and_solve_match_jax(m, block):
    sqd, theta, K, A = _gram(m)
    _same(T.k_se_linear_lanes(torch.tensor(sqd), torch.tensor(theta)), K)
    Lj = np.asarray(jax.jit(J.cholesky_lanes_blocked, static_argnums=1)(
        jnp.asarray(A), block))
    Lt = T.cholesky_lanes_blocked(torch.tensor(A), block=block).numpy()
    # the well-conditioned candidates factor; the last one fails
    assert np.isfinite(Lj[..., :3]).all()
    _fails_alike(Lt, Lj)
    Y = np.random.default_rng(1).normal(size=(m, 3, 4))
    Zj = jax.jit(J.solve_lower_lanes_blocked, static_argnums=2)(
        jnp.asarray(Lj), jnp.asarray(Y), block)
    _fails_alike(T.solve_lower_lanes_blocked(torch.tensor(Lj),
                                             torch.tensor(Y), block=block),
                 Zj)


@pytest.mark.parametrize("m,block", SHAPES)
def test_nll_lanes_big_matches_jax(m, block):
    args = _problem(m)

    def jax_nll(*a, pivot_floor=None):
        return np.asarray(jax.jit(lambda *x: J.nll_lanes_big(
            *x, kernel=J.k_se_linear_lanes, pivot_floor=pivot_floor,
            block=block))(*(jnp.asarray(v) for v in a)))

    want = jax_nll(*args)
    got = T.nll_lanes_big(*(torch.tensor(v) for v in args),
                          kernel=T.k_se_linear_lanes, block=block).numpy()
    assert got.dtype == np.float64 and got.shape == (3, 4)
    assert np.isfinite(want[:, :3]).all()
    assert np.isposinf(want[:, 3]).all()
    _same(got, want)
    if m != 64:
        return
    # with a pivot floor the failing candidate factors to a finite NLL
    floored = T.nll_lanes_big(*(torch.tensor(v) for v in args),
                              kernel=T.k_se_linear_lanes, block=block,
                              pivot_floor=1e-3).numpy()
    _same(floored, jax_nll(*args, pivot_floor=1e-3))
    np.testing.assert_array_equal(floored[:, :3], got[:, :3])
    assert np.isfinite(floored).all()
