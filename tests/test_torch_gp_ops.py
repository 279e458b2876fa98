"""Port parity for the GP functions of ops/gp.py that GParareal uses:
``k_se_linear``, ``k_se_log10``, ``_masked_gram``, ``gp_fit``, ``gp_nll``
(with and without ``rel_floor``), ``nll_from_sqd`` and
``predict_mean_from_sqd``, against the JAX package's, jitted, on both
sides of the 48-row switch (the column loop of ops/linalg_small.py below
it, the library Cholesky above it) and in f32 (the blocked factorisation
above it).

Inputs: squared distances of seeded random points in [-1, 1]^3, padded
rows masked out, three thetas and jitters 1e-8 and 1e-6 (the masked Grams'
condition numbers run from 1e1 to 5e8). The two packages sum and factor
in other orders, and a solve magnifies a rounding difference by up to the
condition number, so the tolerances, relative to the JAX value, are: the
kernels 2 eps (exp may differ by an ulp); the NLL, alpha and the
posterior mean 4 eps cond(Kj) (normwise for alpha); the factor L 4 eps
sqrt(cond(Kj)); the f32 NLL 1e-4 (cond 1e4 x eps32). The masked Gram is
bitwise equal. A batch of candidates gives each candidate's unbatched
value, bitwise.

A zero pivot and an indefinite Gram give +inf in both packages, on both
sides of the switch: that is what drops a Nelder-Mead candidate.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nngparareal_tpu.ops import gp as jgp

from nngparareal_torch.ops import gp as tgp

THETAS = [(0.3, 1.2), (0.5, 0.05), (1.0, 0.3)]
EPS = np.finfo(np.float64).eps
JITTERS = [-8.0, -6.0]
SIZES = [(20, 16), (48, 41), (64, 50), (130, 117)]  # (M, valid rows)


def _inputs(M, valid, seed=0):
    rng = np.random.default_rng(seed + M)
    X = rng.uniform(-1, 1, size=(M, 3))
    sqd = ((X[:, None] - X[None]) ** 2).sum(-1)
    sqd_q = ((X - rng.uniform(-1, 1, size=3)) ** 2).sum(-1)
    y = np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2]
    mask = (np.arange(M) < valid).astype(float)
    mask[2] = 0.0  # a hole among the valid rows
    return sqd, sqd_q, y, mask


def _t(x, dt=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dt)


@functools.lru_cache(maxsize=None)
def _jax_nll(rel_floor):
    return jax.jit(functools.partial(jgp.nll_from_sqd, kernel=jgp.k_se_linear,
                                     rel_floor=rel_floor))


_jax_predict = jax.jit(functools.partial(jgp.predict_mean_from_sqd,
                                         kernel=jgp.k_se_linear))
_jax_fit = jax.jit(jgp.gp_fit)


def _cond(sqd, th, jp, mask):
    K = np.asarray(jgp.k_se_linear(sqd, np.asarray(th)))
    return np.linalg.cond(np.asarray(jgp._masked_gram(K, mask, jp)))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kernel", ["k_se_linear", "k_se_log10"])
def test_kernels_match_jax(kernel):
    sqd, sqd_q, _, _ = _inputs(30, 30)
    for th in THETAS:
        want = jax.jit(getattr(jgp, kernel))(sqd, np.asarray(th))
        got = getattr(tgp, kernel)(_t(sqd), _t(th))
        assert _rel(got, want) <= 2 * EPS
    # a batch of thetas leads the output's axes
    got = getattr(tgp, kernel)(_t(sqd_q), _t(THETAS))
    assert got.shape == (3, 30)
    for i, th in enumerate(THETAS):
        assert torch.equal(got[i], getattr(tgp, kernel)(_t(sqd_q), _t(th)))


@pytest.mark.parametrize("M,valid", SIZES)
def test_masked_gram_is_bitwise(M, valid):
    sqd, _, _, mask = _inputs(M, valid)
    K = np.asarray(jgp.k_se_linear(sqd, np.asarray(THETAS[0])))
    want = np.asarray(jax.jit(jgp._masked_gram)(K, mask, -8.0))
    got = tgp._masked_gram(_t(K), _t(mask), _t(-8.0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,valid", SIZES)
@pytest.mark.parametrize("rel_floor", [None, 1e-6])
def test_gp_nll_matches_jax(M, valid, rel_floor):
    sqd, _, y, mask = _inputs(M, valid)
    th_all, jit_all, got_all = [], [], []
    for th in THETAS:
        for jp in JITTERS:
            want = float(_jax_nll(rel_floor)(sqd, y, np.asarray(th), jp,
                                             mask))
            got = tgp.nll_from_sqd(_t(sqd), _t(y), _t(th), _t(jp), _t(mask),
                                   tgp.k_se_linear, rel_floor=rel_floor)
            assert np.isfinite(want)
            tol = 4 * EPS * _cond(sqd, th, jp, mask)
            assert abs(float(got) - want) <= tol * abs(want), (th, jp)
            th_all.append(th)
            jit_all.append(jp)
            got_all.append(got)
    # the same candidates as one batch: each one's value, bitwise
    batch = tgp.nll_from_sqd(_t(sqd), _t(y), _t(th_all), _t(jit_all),
                             _t(mask), tgp.k_se_linear, rel_floor=rel_floor)
    assert torch.equal(batch, torch.stack(got_all))


@pytest.mark.parametrize("M,valid", SIZES)
def test_gp_fit_and_posterior_match_jax(M, valid):
    sqd, sqd_q, y, mask = _inputs(M, valid)
    for th in THETAS:
        K = np.asarray(jgp.k_se_linear(sqd, np.asarray(th)))
        Lj, aj = _jax_fit(K, y, -8.0, mask)
        Lt, at = tgp.gp_fit(_t(K), _t(y), _t(-8.0), _t(mask))
        cond = _cond(sqd, th, -8.0, mask)
        assert _rel(Lt, Lj) <= 4 * EPS * np.sqrt(cond)
        assert _rel(at, aj) <= 4 * EPS * cond
        assert torch.all(at[mask == 0] == 0)  # padded rows carry no weight
        want = float(_jax_predict(sqd, sqd_q, y, np.asarray(th), -6.0,
                                  mask))
        got = float(tgp.predict_mean_from_sqd(
            _t(sqd), _t(sqd_q), _t(y), _t(th), _t(-6.0), _t(mask),
            tgp.k_se_linear))
        tol = 4 * EPS * _cond(sqd, th, -6.0, mask)
        assert abs(got - want) <= tol * max(abs(want), np.abs(y).max())


@pytest.mark.parametrize("M,valid", [(130, 117), (256, 200)])
def test_gp_nll_f32_matches_jax(M, valid):
    """Above 48 rows an f32 Gram factors in ops/chol_blocked.py, in both
    packages; with the f32 scoring's relative floor."""
    sqd, _, y, mask = _inputs(M, valid)
    rf = 4.0 * float(np.finfo(np.float32).eps)
    for th in THETAS:
        K = np.asarray(jgp.k_se_linear(sqd, np.asarray(th)), np.float32)
        args = (K, y.astype(np.float32), np.float32(-8.0),
                mask.astype(np.float32))
        want = float(jgp.gp_nll(*(jnp.asarray(a) for a in args),
                                rel_floor=rf))
        got = tgp.gp_nll(*(_t(a, torch.float32) for a in args),
                         rel_floor=rf)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-4 * abs(want), th


@pytest.mark.parametrize("M", [20, 64])
@pytest.mark.parametrize("case", ["zero_pivot", "indefinite"])
def test_failed_factorisation_is_inf_in_both(M, case):
    sqd, _, y, mask = _inputs(M, M)
    mask = np.ones(M)
    K = np.array(jgp.k_se_linear(sqd, np.asarray(THETAS[0])))
    jp = -np.inf  # no jitter: 10^-inf = 0
    if case == "zero_pivot":
        K[0, :] = K[:, 0] = 0.0  # the first pivot is exactly 0
    else:
        K[M // 2, M // 2] = -1.0
    want = float(jax.jit(jgp.gp_nll)(K, y, jp, mask))
    got = float(tgp.gp_nll(_t(K), _t(y), _t(jp), _t(mask)))
    assert want == np.inf and got == np.inf
    # the library path maps a failed factor to all NaN, as JAX's
    if M > tgp.SMALL_M:
        Kj = tgp._masked_gram(_t(K), _t(mask), _t(jp))
        assert torch.isnan(tgp.cholesky_nan(Kj)).all()
        _, alpha = tgp.gp_fit(_t(K), _t(y), _t(jp), _t(mask))
        assert torch.isnan(alpha).all()
