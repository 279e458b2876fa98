"""Port parity for the nnGP's LOO selection, LU posterior and f32 scoring
(``selector='loo'``, ``posterior='lu'``, ``score_dtype`` of
models/nngp.py, and ``loo_lanes``, ``posterior_mean_lu`` and
``nll_lanes(dtype=)`` of ops/gp_lanes.py), against the JAX package on the
CPU.

The data: the frozen Burgers dataset of tests/test_torch_nngp.py (d=16,
m=18, the grid search), its three queries' neighbourhoods, and the grid's
576 (theta, jitter) candidates.

* ``loo_lanes``: +inf where JAX's is, the rest within 1e-10 of the
  largest; ``posterior_mean_lu``: finite where JAX's is, within 1e-12.
* ``nll_lanes(dtype=float32)``: the JAX package rounds the kernel values
  and the jitter's power to f32 and factors the Gram in f64 (its identity
  is f64); so does the port. Its f32 exp rounds otherwise than XLA's in
  ~3 % of the kernel values, one f32 ulp, which the near-singular Grams
  amplify: the control is JAX against itself with the distances moved by
  one f32 rounding (2^-24, each entry up or down, three sign draws). The
  +inf places are JAX's, and the port lies within 10x the control's gap.
  Unchanged in f64: ``dtype=float64`` is bitwise the default.
* ``predict_fn`` with ``selector='loo'`` and with ``posterior='lu'``:
  NaN where JAX's is, the rest within 1e-10 of the largest (as
  tests/test_torch_nngp.py holds the default); with
  ``score_dtype=float32``: NaN where JAX's is, and within 10x JAX's
  f32-level control (the dataset's X moved by 2^-24).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models import NNGParareal as JNNGP
from nngparareal_tpu.ops import gp_lanes as jl

from nngparareal_torch.models import Dataset, NNGParareal
from nngparareal_torch.ops import gp as tgp
from nngparareal_torch.ops import gp_lanes as tl
from nngparareal_torch.ops.nn_select import nearest_neighbors

from test_torch_nngp import N_SLICES, _frozen_dataset
from test_torch_knn_elm import _one_torch_thread  # noqa: F401

ULP32 = 2.0 ** -24


@pytest.fixture(scope="module")
def frozen():
    return _frozen_dataset()


def _hoods(frozen):
    """Each query's neighbourhood: (sqd (m, m), sqd_q (m,), targets
    scaled to 1 (m, 16), mask (m,)), as the grid search sees it."""
    X, D, valid, queries = frozen
    out = []
    for q in queries:
        q = torch.as_tensor(q)
        idx, sqd = nearest_neighbors(q, torch.as_tensor(X),
                                     torch.as_tensor(valid), 18)
        mask = torch.isfinite(sqd).double() * torch.as_tensor(valid)[idx]
        xm = torch.as_tensor(X)[idx]
        ym = torch.as_tensor(D)[idx]
        out.append((tgp.pairwise_sq_dists(xm, xm), tgp.sq_dists_to(q, xm),
                    ym / ym.abs().max(), mask))
    return out


def _grid():
    g = np.arange(-8.0, 0.0)
    gx, gy = np.meshgrid(g, g)
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    return np.repeat(grid, 9, axis=0), np.tile(np.arange(-20.0, -11.0), 64)


def _j(*xs):
    return [jnp.asarray(x.numpy() if torch.is_tensor(x) else x) for x in xs]


def test_loo_lanes_matches_jax(frozen):
    th, jit = _grid()
    jf = jax.jit(jl.loo_lanes)
    for sqd, _, ym, mask in _hoods(frozen):
        want = np.asarray(jf(*_j(sqd, ym, th, jit, mask)))
        got = tl.loo_lanes(sqd, ym, torch.as_tensor(th),
                           torch.as_tensor(jit), mask).numpy()
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        ok = np.isfinite(want)
        assert ok.any()
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=1e-10 * np.abs(want[ok]).max())


def test_posterior_mean_lu_matches_jax(frozen):
    th, jit = _grid()
    sel = np.arange(0, 576, 36)  # 16 candidates, one per coordinate
    jf = jax.jit(jl.posterior_mean_lu)
    for sqd, sqd_q, ym, mask in _hoods(frozen):
        args = (sqd, sqd_q, ym, torch.as_tensor(th[sel]),
                torch.as_tensor(jit[sel]), mask)
        want = np.asarray(jf(*_j(*args)))
        got = tl.posterior_mean_lu(*args).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=1e-12 * np.abs(want[ok]).max())


def test_nll_lanes_f32_within_the_jax_control(frozen):
    th, jit = _grid()
    jf = jax.jit(lambda *a: jl.nll_lanes(*a, dtype=jnp.float32))
    tth, tjit = torch.as_tensor(th), torch.as_tensor(jit)
    for sqd, _, ym, mask in _hoods(frozen):
        want = np.asarray(jf(*_j(sqd, ym, th, jit, mask)))
        got = tl.nll_lanes(sqd, ym, tth, tjit, mask,
                           dtype=torch.float32).numpy()
        assert got.dtype == np.float64
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        ok = np.isfinite(want)
        ctl = 0.0
        for s in range(3):
            signs = np.random.default_rng(s).choice([-1.0, 1.0], sqd.shape)
            c = np.asarray(jf(*_j(sqd.numpy() * (1.0 + ULP32 * signs), ym,
                                  th, jit, mask)))
            both = ok & np.isfinite(c)
            ctl = max(ctl, np.abs(c[both] - want[both]).max())
        assert np.abs(got[ok] - want[ok]).max() <= 10.0 * ctl
        # f64 scoring is the default path, bitwise
        assert torch.equal(
            tl.nll_lanes(sqd, ym, tth, tjit, mask, dtype=torch.float64),
            tl.nll_lanes(sqd, ym, tth, tjit, mask))


def _predictor(model, X, D, valid):
    """JAX's predict_fn at a query, jitted, on the dataset X, D, valid."""
    @jax.jit
    def pred(Xj, q):
        z = jnp.zeros(16)
        return model.predict_fn((), JDataset(Xj, jnp.asarray(D),
                                             jnp.asarray(valid)),
                                q, z, z, jnp.zeros(1), jnp.asarray(0))
    return lambda Xn, q: np.asarray(pred(jnp.asarray(Xn), jnp.asarray(q)))


def _both(frozen, **kw):
    """(port, JAX) predictions at each query, and JAX's predictor."""
    X, D, valid, queries = frozen
    jkw = dict(kw)
    if kw.get("score_dtype") is torch.float32:
        jkw["score_dtype"] = jnp.float32
    jm = JNNGP(n=16, N=N_SLICES, nn=18, optimizer="grid", **jkw)
    tm = NNGParareal(n=16, N=N_SLICES, nn=18, optimizer="grid", **kw)
    jm.fit(None, 3)
    tm.fit(None, 3)
    jpred = _predictor(jm, X, D, valid)
    ds = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                 torch.as_tensor(valid))
    z = torch.zeros(16, dtype=torch.float64)
    pairs = [(tm.predict_fn(ds, torch.as_tensor(q), z, z, 0).numpy(),
              jpred(X, q)) for q in queries]
    return pairs, tm, jpred


@pytest.mark.parametrize("kw", [dict(selector="loo"),
                                dict(selector="loo", loo_top=4,
                                     loo_window=0.5),
                                dict(posterior="lu")])
def test_predict_fn_matches_jax(frozen, kw):
    pairs, tm, _ = _both(frozen, **kw)
    finite = 0
    for got, want in pairs:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isfinite(want)
        if ok.any():
            finite += 1
            np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10,
                                       atol=1e-10 * np.abs(want[ok]).max())
    assert finite >= 2
    if kw.get("posterior") == "lu":
        times = tm.get_times()
        assert times["lu_taken"] + times["chol_taken"] == 3 * 16
        assert times["lu_taken"] > 0


def test_f32_scored_predict_within_the_jax_control(frozen):
    X = frozen[0]
    pairs, _, jpred = _both(frozen, score_dtype=torch.float32)
    queries = frozen[3]
    for (got, want), q in zip(pairs, queries):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isfinite(want)
        if not ok.any():
            continue
        ctl = 0.0
        for s in range(3):
            signs = np.random.default_rng(s).choice([-1.0, 1.0], X.shape)
            c = jpred(X * (1.0 + ULP32 * signs), q)
            ctl = max(ctl, np.nanmax(np.abs(c - want)))
        assert np.abs(got[ok] - want[ok]).max() <= 10.0 * ctl


@pytest.mark.parametrize("kw", [dict(strategy="nearest"),
                                dict(selector="loocv"),
                                dict(posterior="qr"),
                                dict(score_dtype="float32"),
                                dict(optimizer="bfgs")])
def test_unknown_options_raise(kw):
    with pytest.raises(ValueError):
        NNGParareal(n=2, N=4, nn=18, **kw)
