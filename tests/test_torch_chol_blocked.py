"""Port parity for ops/chol_blocked.py: the blocked IEEE-f32 Cholesky that
GParareal's f32 scoring uses above 48 rows.

``chol_diag_solve`` of the port against the JAX package's on the same f32
inputs (SPD matrices of condition 1e4 and a random right-hand side) at m
= 64, 300 (padded to whole 256-blocks) and 512, within the tolerances
tests/test_chol_blocked.py puts on the JAX function against LAPACK in
f64: diag(L) rtol 5e-3, z rtol 2e-2 with atol 5e-3 max|z| (cond 1e4 in
f32: a relative error of about cond x eps32, 1e-3). Both packages are
also held to LAPACK in f64 there. A batch gives each matrix's unbatched
result; an indefinite input gives NaN; the products run in IEEE f32 and
the caller's float32 matmul precision is restored.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp
from nngparareal_tpu.ops.chol_blocked import chol_diag_solve as jcds

from nngparareal_torch.ops.chol_blocked import chol_diag_solve as tcds


def _spd(m, seed=0, cond=1e4):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    ev = np.logspace(0.0, -np.log10(cond), m)
    return (Q * ev) @ Q.T


def _inputs(m):
    K = _spd(m, seed=m).astype(np.float32)
    y = np.random.default_rng(1).normal(size=m).astype(np.float32)
    return K, y


def _check(d, z, L, zref):
    assert np.allclose(d, np.diag(L), rtol=5e-3)
    assert np.allclose(z, zref, rtol=2e-2, atol=5e-3 * np.abs(zref).max())


@pytest.mark.parametrize("m", [64, 300, 512])
def test_matches_jax_and_lapack(m):
    K, y = _inputs(m)
    dj, zj = (np.asarray(a)[:m] for a in jcds(jnp.asarray(K),
                                             jnp.asarray(y)))
    dt, zt = (a.numpy()[:m] for a in tcds(torch.tensor(K), torch.tensor(y)))
    assert dt.dtype == np.float32 and zt.dtype == np.float32
    _check(dt, zt, np.diag(dj), zj)  # against JAX's
    L = np.linalg.cholesky(K.astype(np.float64))
    zref = sla.solve_triangular(L, y.astype(np.float64), lower=True)
    _check(dt, zt, L, zref)  # against LAPACK in f64
    _check(dj, zj, L, zref)


def test_padding_gives_identity_rows():
    K, y = _inputs(300)
    d, z = tcds(torch.tensor(K), torch.tensor(y))
    assert d.shape == z.shape == (512,)
    assert torch.equal(d[300:], torch.ones(212))
    assert torch.equal(z[300:], torch.zeros(212))


def test_batch_is_each_matrix():
    Ks, ys = zip(*(_inputs(m) for m in (96, 96)))
    Kb = torch.tensor(np.stack([Ks[0], _spd(96, seed=3).astype(np.float32)]))
    yb = torch.tensor(np.stack(ys))
    db, zb = tcds(Kb, yb, bs=32)
    for i in range(2):
        d1, z1 = tcds(Kb[i], yb[i], bs=32)
        torch.testing.assert_close(db[i], d1, rtol=1e-6, atol=0)
        torch.testing.assert_close(zb[i], z1, rtol=1e-5,
                                   atol=1e-6 * float(z1.abs().max()))


def test_nan_on_indefinite():
    m = 128
    K = _spd(m, seed=3)
    K[0, 0] = -1.0
    d, _ = tcds(torch.tensor(K, dtype=torch.float32), torch.ones(m))
    assert not torch.isfinite(d).all()
    dj, _ = jcds(jnp.asarray(K, jnp.float32), jnp.ones((m,), jnp.float32))
    np.testing.assert_array_equal(np.isfinite(d.numpy()),
                                  np.isfinite(np.asarray(dj)))


def test_products_run_in_ieee_f32_and_restore_the_setting():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []
        orig = torch.Tensor.__matmul__

        def spy(a, b):
            seen.append(torch.get_float32_matmul_precision())
            return orig(a, b)

        torch.Tensor.__matmul__ = spy
        try:
            K, y = _inputs(64)
            tcds(torch.tensor(K), torch.tensor(y), bs=32)
        finally:
            torch.Tensor.__matmul__ = orig
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
