"""GParareal's grid search with its task pool over an 8-block mesh on the
CPU, and the nnGP with the fine fan-out over it, against the port's
unsharded runs and the JAX package's mesh runs.

The mini FHN of tests/test_mesh_models.py (RK2 x4 / RK4 x400, 16 slices
over [0, 16], eps=5e-7), ``early_stop=3``: the nnGP with the grid search
(nn=10), and GParareal with the grid search on a 7-point log grid. Each
mesh run is bitwise the port's unsharded run, and its conv_int is the
JAX package's mesh run's on its 8 virtual CPU devices. In the GParareal
run each of the 8 devices scores its own block of (coordinate x jitter)
tasks: the first holds the 18 real ones, the rest dummies.
"""

import numpy as np
import pytest

import nngparareal_tpu as jt
from nngparareal_tpu.parallel.mesh import make_mesh as jmake_mesh

import nngparareal_torch as nt

from test_torch_mesh import _one_torch_thread  # noqa: F401

RUNS = {"nngp": dict(model="nngp", nn=10, optimizer="grid"),
        "gpjax": dict(model="gpjax", optimizer="grid",
                      grid_logs=np.linspace(-4.5, 1.5, 7))}


def _build(pkg, **kw):
    ode = pkg.FHNODE(normalization="-11", **kw)
    s = pkg.RKSolver(ode.get_vector_field(), 4, 400, G="RK2", F="RK4", **kw)
    return pkg.Parareal(ode, s, [0, 16], 16, epsilon=5e-7, verbose=None,
                        **kw)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_mesh_model_run_is_the_unsharded_and_jax(name):
    kw = dict(RUNS[name], early_stop=3, measure_serial_fine=False)
    mesh = nt.make_mesh(devices=["cpu"] * 8)
    sharded = _build(nt, device="cpu").run(mesh=mesh, add_model=True, **kw)
    one = _build(nt, device="cpu").run(add_model=True, **kw)
    want = _build(jt).run(mesh=jmake_mesh(8), **kw)
    assert sharded["conv_int"] == one["conv_int"] == want["conv_int"]
    np.testing.assert_array_equal(sharded["u"], one["u"])
    if name == "gpjax":
        assert sharded["mdl"].mesh is mesh
        np.testing.assert_array_equal(sharded["mdl"].thetas,
                                      one["mdl"].thetas)
