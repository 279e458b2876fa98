"""Port parity for the time-augmented nnGP (models/nngp_time.py:
NNGPTime), against the JAX package on the CPU.

* ``k_se_time``, the product kernel on the stacked space, slice-index and
  iteration-index distances: rtol 1e-13; batched as the search calls it.
  XLA flushes subnormal results to 0 on the CPU: so does the port's
  kernel, so that rows whose similarity underflows tie at 0 (the lower
  row first) as in JAX.
* ``sweep_aux``: theta0, rand and kval bitwise, in JAX's order.
* ``predict_fn`` on a frozen FHN dataset (the rows of three bare Parareal
  iterations) with the same draws, at nn=10, reps=2, nn_iters=2,
  nm_max_iters=40 (tests/test_variants.py's configuration): each round is
  a 72-simplex Nelder-Mead in 4-d whose NLLs differ from JAX's by XLA's
  exp in the last bits, which the search may amplify. The control is JAX
  against itself with the dataset's X moved by 4e-16 (each entry up or
  down, three sign draws); every prediction lies within 10x its gap, and
  where the control moves nothing beyond 1e-15 the port agrees with JAX
  to 1e-14.
* RUN_SLOW: Lorenz at tests/test_variants.py:61's bounded configuration
  converges with K in 20-23: the current JAX package's K on the CPU is 23
  and 20 under two of three control draws (u0 moved by 4e-16); the JAX
  test's K <= 13 is not what that package reaches.

The end-to-end FHN run is tests/test_torch_nngp_time_fhn.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models.nngp_time import NNGPTime as JTime
from nngparareal_tpu.models.nngp_time import k_se_time as jk

import nngparareal_torch as nt
from nngparareal_torch.models import Dataset, NNGPTime
from nngparareal_torch.models.nngp_time import k_se_time as tk

from test_torch_knn_elm import _one_torch_thread, fhn_pair  # noqa: F401

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
N, CAP = 40, 128
CONFIG = dict(nn=10, reps=2, nn_iters=2, nm_max_iters=40)


def test_k_se_time_matches_jax():
    rng = np.random.default_rng(0)
    S = 0.3 * np.abs(rng.standard_normal((3, 12, 12)))
    jf = jax.jit(jk)
    thetas = rng.uniform(-2.0, 1.0, (6, 4))
    for th in thetas:
        want = np.asarray(jf(jnp.asarray(S), jnp.asarray(th)))
        got = tk(torch.as_tensor(S), torch.as_tensor(th)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    # batched: thetas (6, 4) against one stack, and per-batch stacks
    got = tk(torch.as_tensor(S)[None], torch.as_tensor(thetas)).numpy()
    want = np.stack([np.asarray(jf(jnp.asarray(S), jnp.asarray(t)))
                     for t in thetas])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    stacks = np.stack([S, 2.0 * S])
    got = tk(torch.as_tensor(stacks), torch.as_tensor(thetas[:2])).numpy()
    np.testing.assert_allclose(got[1], np.asarray(jf(
        jnp.asarray(2.0 * S), jnp.asarray(thetas[1]))), rtol=1e-13, atol=0)
    # underflow: 0, as XLA flushes a subnormal result
    far = np.full((3, 2, 2), 1e3)
    th = np.array([-1.0, 0.0, 0.0, 0.0])
    assert np.asarray(jf(jnp.asarray(far), jnp.asarray(th))).max() == 0.0
    assert tk(torch.as_tensor(far), torch.as_tensor(th)).max() == 0.0
    # exp(-0.5 * 12 * 3.84) ~ 1e-10 is normal, times 1e-300 is not
    near = np.full((3, 1, 1), 3.84)
    th = np.array([-1.0, -300.0, 0.0, 0.0])
    assert np.asarray(jf(jnp.asarray(near), jnp.asarray(th))).max() == 0.0
    assert tk(torch.as_tensor(near), torch.as_tensor(th)).max() == 0.0
    th[1] = -290.0  # normal: the same value in both
    np.testing.assert_allclose(
        tk(torch.as_tensor(near), torch.as_tensor(th)).numpy(),
        np.asarray(jf(jnp.asarray(near), jnp.asarray(th))), rtol=1e-13)


def test_sweep_aux_bitwise():
    jm = JTime(3, 8, seed=11, reps=3, n_restarts=2)
    tm = NNGPTime(3, 8, seed=11, reps=3, n_restarts=2)
    assert (tm.chains, tm.tasks_per_chain) == (jm.chains, jm.tasks_per_chain)
    for k in range(3):
        want, got = jm.sweep_aux(k, 8, 64), tm.sweep_aux(k, 8, 64)
        assert list(got) == list(want) == ["theta0", "rand", "kval"]
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    resumed = NNGPTime(3, 8, seed=11, reps=3, n_restarts=2)
    resumed.set_ckpt_state(jm.get_ckpt_state())
    np.testing.assert_array_equal(resumed.sweep_aux(3, 8, 64)["rand"],
                                  np.asarray(jm.sweep_aux(3, 8, 64)["rand"]))
    assert [tm.m_for(k) for k in range(20)] == [jm.m_for(k)
                                                for k in range(20)]


@pytest.fixture(scope="module")
def frozen():
    """FHN's rows after three bare Parareal iterations (JAX's), padded to
    CAP, and JAX's final iterate as the queries."""
    pj, _ = fhn_pair()
    out = pj.run(model="parareal", early_stop=3, measure_serial_fine=False,
                 comp_models=["knn_mean"])
    rows = out["x"].shape[0]
    X, D, V = np.zeros((CAP, 2)), np.zeros((CAP, 2)), np.zeros(CAP)
    X[:rows], D[:rows], V[:rows] = out["x"], out["D"], 1.0
    return X, D, V, out["u"]


def _jax_predictor(model, D, V):
    @jax.jit
    def pred(Xj, q, aux, i):
        z = jnp.zeros(2)
        return model.predict_fn((), JDataset(Xj, jnp.asarray(D),
                                             jnp.asarray(V)),
                                q, z, z, aux, i)
    return pred


def test_predict_fn_within_the_jax_control(frozen):
    X, D, V, u = frozen
    k = 2
    jm, tm = JTime(2, N, **CONFIG), NNGPTime(2, N, **CONFIG)
    jm.fit(None, k)
    tm.fit(None, k)
    aux = jm.sweep_aux(k, N, CAP)
    taux = tm.sweep_aux(k, N, CAP)
    pred = _jax_predictor(jm, D, V)
    ds = Dataset(torch.as_tensor(X), torch.as_tensor(D), torch.as_tensor(V))
    z = torch.zeros(2, dtype=torch.float64)
    moved = [X * (1.0 + 4e-16 * np.random.default_rng(s).choice(
        [-1.0, 1.0], X.shape)) for s in range(3)]
    exact = 0
    for i in (5, 12, 20, 30, 39):
        aux_i = {key: v[i] for key, v in aux.items()}
        want = np.asarray(pred(jnp.asarray(X), jnp.asarray(u[i]), aux_i,
                               jnp.asarray(i)))
        got = tm.predict_fn(ds, torch.tensor(u[i]), z, z, i, aux_i={
            key: torch.as_tensor(v[i]) for key, v in taux.items()}).numpy()
        assert np.isfinite(got).all()
        ctl = max(np.abs(np.asarray(pred(jnp.asarray(Xm), jnp.asarray(u[i]),
                                         aux_i, jnp.asarray(i))) - want).max()
                  for Xm in moved)
        gap = np.abs(got - want).max()
        assert gap <= 10.0 * max(ctl, 1e-15), (i, gap, ctl)
        exact += ctl <= 1e-15
    # every search ran its 40 iterations (no simplex set froze whole)
    assert tm.nm_stats["iterations"] == [40] * 10
    assert exact >= 1


@pytest.mark.skipif(not RUN_SLOW, reason="Lorenz with the time-augmented "
                    "nnGP is ~15 minutes on the CPU")
def test_lorenz_bounded_configuration_k():
    ode = nt.Lorenz(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=5e-7,
                    verbose=None, device="cpu")
    out = p.run(model="nngp_time", nn=14, reps=2, nn_iters=2,
                nm_max_iters=80, measure_serial_fine=False)
    assert out["converged"] and 20 <= out["k"] <= 23
