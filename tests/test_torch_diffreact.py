"""Port parity for systems/pdes.py:DiffReact, the 2D diffusion-reaction
system, against the JAX package on the CPU.

* The initial condition bitwise, the name and the dimension (2 d_x^2).
* The vector field, raw and [-1,1]-normalised, at d_x = 4 and 8, on one
  state and on a batch: rtol 1e-13 of the largest component (the
  Laplacian is a dense matrix product in both packages, summed in their
  own orders).
* A short fan-out through the plain torch integrator (``fine="torch"``:
  the JAX package never integrates DiffReact with its Pallas kernel, and
  the port has no kernel form of it): 1e-12.
* ``make_system("diffreact", d_x=...)`` builds it; ``Config`` refuses it
  as the JAX package does ("No config for input ODE").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.systems.pdes import DiffReact as JDiffReact

import nngparareal_torch as nt
from nngparareal_torch.systems import registry as tregistry

from test_torch_knn_elm import _one_torch_thread  # noqa: F401


def _pair(d_x, norm):
    kw = {} if norm is None else {"normalization": norm}
    return JDiffReact(d_x, **kw), nt.DiffReact(d_x, device="cpu", **kw)


@pytest.mark.parametrize("norm", [None, "-11"])
@pytest.mark.parametrize("d_x", [4, 8])
def test_field_matches_jax(d_x, norm):
    oj, ot = _pair(d_x, norm)
    assert ot.name == oj.name == f"DiffReact2D_{d_x}"
    assert ot.get_dim() == oj.get_dim() == 2 * d_x * d_x
    np.testing.assert_array_equal(ot.get_init_cond().numpy(),
                                  oj.get_init_cond())
    fj = jax.jit(oj.get_vector_field())
    ft = ot.get_vector_field()
    rng = np.random.default_rng(d_x)
    U = oj.get_init_cond()[None, :] + 0.3 * rng.uniform(
        -1.0, 1.0, (5, ot.get_dim()))
    want = np.stack([np.asarray(fj(0.0, jnp.asarray(u))) for u in U])
    got = ft(0.0, torch.as_tensor(U)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(ft(0.0, torch.as_tensor(U[0])).numpy(),
                               want[0], rtol=0, atol=1e-13 * scale)
    # the host twin for scipy-based solvers
    np.testing.assert_allclose(ot.get_vector_field_numpy()(0.0, U[1]),
                               want[1], rtol=0, atol=1e-13 * scale)


def test_plain_fanout_matches_jax():
    oj, ot = _pair(4, "-11")
    sj = jt.RKSolver(oj.get_vector_field(), 2, 20, G="RK1", F="RK4")
    st = nt.RKSolver(ot.get_vector_field(), 2, 20, G="RK1", F="RK4",
                     fine="torch", device="cpu")
    rng = np.random.default_rng(0)
    U = oj.get_init_cond()[None, :] + 0.1 * rng.uniform(-1, 1, (3, 32))
    t0, t1 = np.array([0.0, 0.5, 1.0]), np.array([0.5, 1.0, 1.5])
    want = np.asarray(sj.run_F_batch(jnp.asarray(t0), jnp.asarray(t1),
                                     jnp.asarray(U)))
    got = st.run_F_batch(t0, t1, U).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_make_system_and_config():
    ot, params = tregistry.make_system("diffreact_n", d_x=4, device="cpu")
    assert isinstance(ot, nt.DiffReact) and params == {}
    assert ot.normalizer.norm_type == "-11"
    for pkg, ode in ((jt, JDiffReact(4)), (nt, ot)):
        with pytest.raises(Exception, match="No config for input ODE"):
            pkg.Config(ode)
