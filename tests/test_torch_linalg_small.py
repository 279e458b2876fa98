"""Port parity for ops/linalg_small.py: the column-loop Cholesky and
triangular solves that GParareal's GP uses up to 48 rows.

The port's five functions against the JAX package's, jitted, on the same
numpy-seeded batched inputs at m = 1, 7, 18 and 48 (SE Grams of random
points, with a diagonal shift that keeps them well conditioned).

Tolerance: 4 ulps of the largest entry of the JAX result (|port - JAX| <=
4 eps max|JAX|). Both packages sum as the jitted function does at one
column (one fused multiply-add after another); XLA computes a longer sum
as a batched dot whose order it chooses (measured: in order up to 4
terms), so the last bits may differ there. At m = 1 nothing is summed and
the results are bitwise equal, except chol_solve_small: XLA rewrites
(y / l) / l as y / (l * l). On an indefinite input the NaN positions are
equal: a failed pivot gives NaN, which propagates.
"""

import numpy as np
import pytest
import torch

import jax
from nngparareal_tpu.ops import linalg_small as jls

from nngparareal_torch.ops import linalg_small as tls

ULPS = 4
EPS = np.finfo(np.float64).eps
BATCH = (3, 2)


def _inputs(m, seed=0, shift=0.1):
    rng = np.random.default_rng(seed + m)
    X = rng.normal(size=BATCH + (m, 3))
    sqd = ((X[..., :, None, :] - X[..., None, :, :]) ** 2).sum(-1)
    A = np.exp(-0.5 * sqd / 0.3) + shift * np.eye(m)
    return A, rng.normal(size=BATCH + (m,)), rng.normal(size=BATCH + (m, 4))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ULPS * EPS * np.abs(want).max()


def _cases(m):
    A, y, Y = _inputs(m)
    L = np.asarray(jax.jit(jls.cholesky_small)(A))
    U = np.swapaxes(L, -1, -2)
    return {
        "cholesky_small": (tls.cholesky_small(_t(A)), L),
        "solve_lower_small": (tls.solve_lower_small(_t(L), _t(y)),
                              jax.jit(jls.solve_lower_small)(L, y)),
        "solve_upper_small": (tls.solve_upper_small(_t(U), _t(y)),
                              jax.jit(jls.solve_upper_small)(U, y)),
        "chol_solve_small": (tls.chol_solve_small(_t(L), _t(y)),
                             jax.jit(jls.chol_solve_small)(L, y)),
        "solve_lower_small_mrhs": (
            tls.solve_lower_small_mrhs(_t(L), _t(Y)),
            jax.jit(jls.solve_lower_small_mrhs)(L, Y)),
    }


FUNCS = ["cholesky_small", "solve_lower_small", "solve_upper_small",
         "chol_solve_small", "solve_lower_small_mrhs"]


@pytest.mark.parametrize("m", [1, 7, 18, 48])
@pytest.mark.parametrize("fn", FUNCS)
def test_matches_jax_within_ulps(fn, m):
    got, want = _cases(m)[fn]
    _close(got, want)
    if m == 1 and fn != "chol_solve_small":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [7, 18, 48])
def test_factor_reconstructs_its_input(m):
    A, _, _ = _inputs(m)
    L = tls.cholesky_small(_t(A))
    assert torch.equal(L, torch.tril(L))
    np.testing.assert_allclose((L @ L.transpose(-1, -2)).numpy(), A,
                               rtol=0, atol=8 * m * EPS)


@pytest.mark.parametrize("m", [7, 18, 48])
def test_indefinite_input_gives_nan_where_jax_does(m):
    A, y, _ = _inputs(m, seed=5)
    A[..., m // 2, m // 2] = -1.0  # a negative pivot halfway down
    Lj = np.asarray(jax.jit(jls.cholesky_small)(A))
    Lt = tls.cholesky_small(_t(A)).numpy()
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    assert np.isnan(Lt).any()
    zj = np.asarray(jax.jit(jls.chol_solve_small)(Lj, y))
    zt = tls.chol_solve_small(_t(Lj), _t(y)).numpy()
    np.testing.assert_array_equal(np.isnan(zt), np.isnan(zj))
    assert np.isnan(zt).all()
