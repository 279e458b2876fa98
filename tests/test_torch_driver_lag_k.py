"""Port parity for the driver's ``lag_k`` window and ``cap_iters``, against
the JAX package on the CPU.

* ``_windowed_valid`` (the ``lag_k`` window) equals JAX's on the same
  masks.
* ``lag_k=3`` with the nnGP (nn=15, grid) on FHN's first 16 slices at the
  full Nf: K and conv_int equal JAX's, and the final iterates lie within
  the gap JAX's own control opens (u0 moved by 4e-16, each coordinate up
  or down): the searches of the two packages part at the rounding level
  (4.1e-11 here against the control's 1.2e-10), so no 1e-12 bound holds on
  an nnGP run. The same run with ``cap_iters=1`` (the dataset grown three
  times, from 16 rows to 128) is bitwise the uncapped one.
* The full FHN with ``lag_k=3`` is chip_smoke.py's oracle: JAX gives K=6
  (conv_int [1, 2, 3, 25, 38, 40]); its control gives 5 or 6 (twelve sign
  draws: 5 in ten); the port gives 7, and 5, 5, 6 under the same control.
  The first sweep already parts from JAX's by 7e-7, with or without the
  window (the grid search's tie at iteration 0), 5x the control's gap.
  So K is held to 5-7, the band of both packages and their controls.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nngparareal_tpu.driver import Parareal as JParareal

from nngparareal_torch.driver import Parareal as TParareal

from test_torch_knn_elm import _one_torch_thread, cut, fhn_pair  # noqa: F401

GRID = dict(model="nngp", nn=15, optimizer="grid", measure_serial_fine=False)


@pytest.mark.parametrize("k,I,lag_k", [(0, 1, 3), (2, 1, 2), (5, 7, 3),
                                       (4, 0, 1), (9, 3, 20)])
def test_windowed_valid_matches_jax(k, I, lag_k):
    N = 8
    valid = (np.random.default_rng(k).random(10 * N) < 0.8).astype(float)
    want = np.asarray(JParareal._windowed_valid(jnp.asarray(valid), N, k, I,
                                                lag_k))
    got = TParareal._windowed_valid(torch.as_tensor(valid), N, k, I, lag_k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def lag_runs():
    """FHN's first 16 slices at the full Nf, nnGP grid with lag_k=3: JAX,
    the port, the port with cap_iters=1, and JAX's control."""
    pj, pt = fhn_pair(edit=cut(1, 16))
    kw = dict(GRID, lag_k=3)
    out = {"jax": pj.run(**kw), "port": pt.run(**kw),
           "port_cap1": pt.run(**kw, cap_iters=1)}
    pc, _ = fhn_pair(edit=cut(1, 16), nudge=4e-16, sign_seed=0)
    out["control"] = pc.run(**kw)
    return out


def test_lag_k_matches_jax(lag_runs):
    oj, ot, oc = lag_runs["jax"], lag_runs["port"], lag_runs["control"]
    assert ot["converged"] and oj["converged"]
    assert ot["k"] == oj["k"] == 6
    assert ot["conv_int"] == oj["conv_int"] == [1, 2, 3, 6, 10, 16]
    control_gap = np.abs(oc["u"] - oj["u"]).max()
    assert control_gap > 0.0
    assert np.abs(ot["u"] - oj["u"]).max() <= control_gap


def test_cap_iters_one_equals_uncapped(lag_runs):
    ot, oc = lag_runs["port"], lag_runs["port_cap1"]
    np.testing.assert_array_equal(oc["u"], ot["u"])
    np.testing.assert_array_equal(oc["err"], ot["err"])
    assert oc["conv_int"] == ot["conv_int"]


def test_lag_k_full_fhn_band():
    """chip_smoke.py's oracle for the api phase: JAX's K and conv_int at
    the full configuration, and the port's K in the band 5-7."""
    pj, pt = fhn_pair()
    oj = pj.run(**GRID, lag_k=3)
    assert (oj["k"], oj["conv_int"]) == (6, [1, 2, 3, 25, 38, 40])
    ot = pt.run(**GRID, lag_k=3)
    assert ot["converged"] and 5 <= ot["k"] <= 7
