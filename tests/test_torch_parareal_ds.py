"""A cut end-to-end configuration in double-single on the CPU: FHN ODE
([-1,1]-normalised) over [0, 16], N=16, RK2 x4 / RK4 x40 per slice,
eps=5e-7, with ``fine='ds'`` (the plain ds fan-out) and ``fine='pallas'``
(the ds kernel's wrapper, which takes its plain version on CPU tensors).

* Bare Parareal: K and conv_int those of the port's f64 run and of the
  JAX package's (f64, jitted: no ds value is compared with JAX here), and
  the final iterate within 1e-10 of the port's f64 run.
* The nnGP with the grid search (nn=8): K and conv_int those of both f64
  runs; its iterate within 1e-8 of the port's f64 run, since the GP's
  solve amplifies the ~1e-14 gap between the ds and f64 training data.
* ``mesh=`` over 2 CPU blocks: bitwise the unsharded ds run, since each
  slice is integrated alone.

No JAX ds run appears here: on the CPU, XLA collapses compensated
arithmetic under ``jit`` (``ds32.backend_preserves_ds()`` is False), and
the eager oracles are in tests/test_torch_ds32.py, test_torch_ds_lift.py
and test_torch_rk_ds.py.
"""

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt
import nngparareal_torch as nt
from nngparareal_torch.parallel import make_mesh

N, T, NG, NF = 16, 16.0, 4, 40
MODELS = {"parareal": dict(model="parareal"),
          "nngp": dict(model="nngp", nn=8, optimizer="grid")}
ITERATE_ATOL = {"parareal": 1e-10, "nngp": 1e-8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(fine):
    ode = nt.FHNODE(normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), NG, NF, G="RK2", F="RK4",
                    fine=fine, fine_ds=ode.get_ds_vector_field(),
                    device_field=ode.get_device_field(), device="cpu")
    return nt.Parareal(ode, s, [0.0, T], N, epsilon=5e-7, verbose=None,
                       device="cpu")


@pytest.fixture(scope="module")
def runs():
    """Each run once: the JAX package's and the port's f64 runs of each
    model, and the port's ds runs, keyed by (package or fine, model)."""
    cache = {}

    def get(kind, model):
        if (kind, model) not in cache:
            if kind == "jax":
                ode = jt.FHNODE(normalization="-11")
                s = jt.RKSolver(ode.get_vector_field(), NG, NF, G="RK2",
                                F="RK4")
                p = jt.Parareal(ode, s, [0.0, T], N, epsilon=5e-7,
                                verbose=None)
            else:
                p = _port(kind)
            cache[kind, model] = p.run(**MODELS[model])
        return cache[kind, model]

    return get


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fine", ["ds", "pallas"])
def test_ds_run_gives_the_f64_k(runs, fine, model):
    jax_out, f64_out = runs("jax", model), runs("torch", model)
    assert jax_out["k"] == f64_out["k"]
    assert list(jax_out["conv_int"]) == list(f64_out["conv_int"])
    out = runs(fine, model)
    assert out["converged"]
    assert out["k"] == f64_out["k"]
    assert list(out["conv_int"]) == list(f64_out["conv_int"])
    gap = np.abs(out["u"] - f64_out["u"]).max()
    assert 0.0 < gap <= ITERATE_ATOL[model]  # ds ran, and tracks f64


def test_mesh_is_the_unsharded_ds_run(runs):
    one = runs("ds", "parareal")
    sharded = _port("ds").run(model="parareal",
                              mesh=make_mesh(devices=["cpu"] * 2))
    assert sharded["k"] == one["k"]
    assert list(sharded["conv_int"]) == list(one["conv_int"])
    np.testing.assert_array_equal(sharded["u"], one["u"])
