"""Port parity for the nnGP's neighbour strategies (``strategy`` of
models/nngp.py: the research variants of the reference's
nnGPara_with_time.py), against the JAX package on the CPU.

* The neighbour indices and selection mask of each strategy, exactly, at
  several (k, i) on a padded dataset with masked-out rows, where the
  eligible rows are fewer than m (ties among +inf penalties) and, for
  ``col+rnd``, with its random scores rounded so that they tie: the lower
  row first, as ``lax.top_k`` orders them.
* ``col+rnd``'s draws bitwise, after the Nelder-Mead starts when both are
  drawn; a model set from a JAX checkpoint's state draws JAX's next ones,
  and the port resumes the JAX run's checkpoint to JAX's K and conv_int.
* End to end, FHN at its configuration, two iterations with the grid
  search (tests/test_variants.py:19-27): the iterates within 1e-12 of
  max|u| of JAX's; ``col+rnd``, whose random neighbours make the grid
  search's pick a near tie, within 10x JAX's own control (u0 moved by
  4e-16).
"""

import glob

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nngparareal_tpu.models import Dataset as JDataset
from nngparareal_tpu.models import NNGParareal as JNNGP

from nngparareal_torch.convert import load_checkpoint
from nngparareal_torch.models import Dataset, NNGParareal
from nngparareal_torch.models.nngp import STRATEGIES

from test_torch_knn_elm import _one_torch_thread, fhn_pair  # noqa: F401

VARIANTS = [s for s in STRATEGIES if s != "nn"]
N, n, CAP = 8, 2, 64
GRID = dict(nn=12, optimizer="grid", grid_refine=0)


def _data(k):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((CAP, n))
    X[20], X[21] = X[12], X[13]
    D = rng.standard_normal((CAP, n))
    valid = np.zeros(CAP)
    valid[: (k + 1) * N] = 1.0
    valid[[3, 9, 17]] = 0.0
    return X, D, valid


@pytest.mark.parametrize("strategy", VARIANTS)
@pytest.mark.parametrize("k", [0, 1, 3, 6])
@pytest.mark.parametrize("m", [4, 12])
def test_neighbour_indices_match_jax(strategy, k, m):
    X, D, valid = _data(k)
    jm = JNNGP(n, N, nn=m, optimizer="grid", strategy=strategy)
    tm = NNGParareal(n, N, nn=m, optimizer="grid", strategy=strategy)
    assert tm.name == jm.name == "NNGP" + strategy
    jm.fit(None, k)
    tm.fit(None, k)
    rand = np.round(np.random.default_rng(k).random((N, CAP)), 1)
    dj = JDataset(jnp.asarray(X), jnp.asarray(D), jnp.asarray(valid))
    dt = Dataset(torch.as_tensor(X), torch.as_tensor(D),
                 torch.as_tensor(valid))
    for i in range(N):
        q = X[(k * N + i) % CAP]
        ji, jmask = jm._select_neighbors(dj, jnp.asarray(q), m, i,
                                         {"rand": jnp.asarray(rand[i])})
        ti, tmask = tm._select_neighbors(dt, torch.as_tensor(q), m, i,
                                         {"rand": torch.as_tensor(rand[i])})
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("optimizer", ["grid", "nm"])
def test_col_rnd_draws_bitwise(optimizer):
    jm = JNNGP(n, N, seed=7, optimizer=optimizer, strategy="col+rnd")
    tm = NNGParareal(n, N, seed=7, optimizer=optimizer, strategy="col+rnd")
    for k in range(3):
        want, got = jm.sweep_aux(k, N, CAP), tm.sweep_aux(k, N, CAP)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    resumed = NNGParareal(n, N, seed=7, optimizer=optimizer,
                          strategy="col+rnd")
    resumed.set_ckpt_state(jm.get_ckpt_state())
    want, got = jm.sweep_aux(3, N, CAP), resumed.sweep_aux(3, N, CAP)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    with pytest.raises(ValueError, match="capacity"):
        tm.sweep_aux(0, N)


def test_col_rnd_resumes_a_jax_checkpoint(tmp_path):
    pj, pt = fhn_pair()
    kw = dict(model="nngp", strategy="col+rnd", early_stop=2,
              measure_serial_fine=False, **GRID)
    oj = pj.run(store_int=True, int_dir=str(tmp_path), **kw)
    path = sorted(glob.glob(str(tmp_path / "*" / "*_0")))[0]
    state = load_checkpoint(path)["model_state"]
    # the next draws of a model set from the checkpoint are JAX's
    jm = JNNGP(pt.n, pt.N, strategy="col+rnd", **GRID)
    tm = NNGParareal(pt.n, pt.N, strategy="col+rnd", **GRID)
    jm.set_ckpt_state(state)
    tm.set_ckpt_state(state)
    np.testing.assert_array_equal(tm.sweep_aux(1, pt.N, 1280)["rand"],
                                  np.asarray(jm.sweep_aux(1, pt.N,
                                                          1280)["rand"]))
    out = pt.load_int_dump(path, **kw)
    assert out["k"] == oj["k"] and out["conv_int"] == oj["conv_int"]


@pytest.fixture(scope="module")
def col_rnd_control():
    pc, _ = fhn_pair(nudge=4e-16)
    return pc.run(model="nngp", strategy="col+rnd", early_stop=2,
                  measure_serial_fine=False, **GRID)


@pytest.mark.parametrize("strategy", VARIANTS)
def test_fhn_two_iterations_match_jax(strategy, request):
    pj, pt = fhn_pair()
    kw = dict(model="nngp", strategy=strategy, early_stop=2,
              measure_serial_fine=False, **GRID)
    oj, ot = pj.run(**kw), pt.run(**kw)
    assert ot["k"] == oj["k"] == 2 and ot["conv_int"] == oj["conv_int"]
    assert np.isfinite(ot["u"]).all()
    gap = np.abs(ot["u"] - oj["u"]).max()
    if strategy == "col+rnd":
        ctl = request.getfixturevalue("col_rnd_control")
        assert gap <= 10.0 * np.abs(ctl["u"] - oj["u"]).max()
    else:
        assert gap <= 1e-12 * np.abs(oj["u"]).max()
