"""The port's device mesh (``nngparareal_torch/parallel/mesh.py``) against
the unsharded port and the JAX package's mesh on the CPU.

* ``shard_fine_fanout`` over 8 blocks on the CPU (``make_mesh(devices=
  ["cpu"] * 8)``) is bitwise the unsharded fan-out, through the plain
  integrator and through the kernel's wrapper (which takes its plain
  version on a CPU tensor), and within 1e-12 of the JAX package's
  ``shard_fine_fanout`` on its 8 virtual CPU devices, on the inputs of
  tests/test_sharding.py.
* The padding configuration of tests/test_sharding.py (FHN over [0, 20],
  N=20, RK2 x4 / RK4 x500): bare Parareal on the 8-block mesh gives the
  JAX mesh run's K and conv_int, ``u`` within 1e-12, and is bitwise the
  port's unsharded run. FHN at its Table-2 configuration is
  tests/test_torch_mesh_fhn.py.
* What raises: a batch that does not divide over the mesh, a mesh whose
  first device is not the run's, a solver without ``fine_batch_raw``, a
  mesh of more devices than exist, a card that is absent.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops.rk import integrate_last as jintegrate_last
from nngparareal_tpu.parallel.mesh import make_mesh as jmake_mesh
from nngparareal_tpu.parallel.mesh import shard_fine_fanout as jshard

import nngparareal_torch as nt
from nngparareal_torch.parallel import (
    SLICE_AXIS, Mesh, make_mesh, shard_fine_fanout, slice_sharding)

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """tests/test_sharding.py's fan-out inputs: 16 slices of width 1."""
    rng = np.random.default_rng(0)
    t0s = np.arange(16, dtype=float)
    return t0s, t0s + 1.0, rng.normal(size=(16, 2)) * 0.1


@pytest.mark.parametrize("fine", ["torch", "cuda"])
def test_sharded_fanout_is_the_unsharded_and_jax(fine):
    ode = nt.FHNODE(normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), 4, 200, G="RK2", F="RK4",
                    fine=fine, device_field=ode.get_device_field(),
                    device="cpu")
    t0s, t1s, U = (torch.tensor(x) for x in _inputs())
    mesh = make_mesh(devices=CPU8)
    got = shard_fine_fanout(s.fine_batch_raw, mesh)(t0s, t1s, U)
    np.testing.assert_array_equal(got.numpy(), s.run_F_batch(t0s, t1s,
                                                              U).numpy())

    f = jt.FHNODE(normalization="-11").get_vector_field()

    def fan(a, b, u):
        def one(t0, t1, x):
            return jintegrate_last(f, "RK4", t0, (t1 - t0) / 200, 200, x)
        return jax.vmap(one)(a, b, u)

    assert jax.device_count() >= 8
    want = jshard(fan, jmake_mesh(8))(*(jnp.asarray(x) for x in _inputs()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_mesh_and_its_sharding():
    mesh = make_mesh(devices=CPU8)
    assert mesh.devices.size == 8 and mesh.axis_names == (SLICE_AXIS,)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(3, devices=CPU8).devices.size == 3
    blocks = slice_sharding(mesh).blocks(16)
    assert [(sl.start, sl.stop) for _, sl in blocks] == [
        (2 * j, 2 * j + 2) for j in range(8)]
    with pytest.raises(ValueError, match="pad it"):
        slice_sharding(mesh).blocks(20)
    ode = nt.FHNODE(normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), 4, 10, device="cpu")
    t0s, t1s, U = (torch.tensor(x)[:12] for x in _inputs())
    with pytest.raises(ValueError, match="does not divide"):
        shard_fine_fanout(s.fine_batch_raw, mesh)(t0s, t1s, U)


def test_what_a_mesh_refuses(monkeypatch):
    with pytest.raises(ValueError, match="3 devices asked for, 2 available"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(devices=["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="does not exist"):
        make_mesh(devices=["cuda:0"])


def _padding_parareal(pkg, **kw):
    """tests/test_sharding.py:test_mesh_with_padding's configuration."""
    ode = pkg.FHNODE(normalization="-11", **kw)
    s = pkg.RKSolver(ode.get_vector_field(), 4, 500, G="RK2", F="RK4", **kw)
    return pkg.Parareal(ode, s, [0, 20], 20, epsilon=5e-7, verbose=None,
                        **kw)


def test_padding_run_is_the_unsharded_and_jax_mesh_run():
    mesh = make_mesh(devices=CPU8)
    one = _padding_parareal(nt, device="cpu").run(
        model="parareal", measure_serial_fine=False)
    sharded = _padding_parareal(nt, device="cpu").run(
        model="parareal", measure_serial_fine=False, mesh=mesh)
    want = _padding_parareal(jt).run(model="parareal", mesh=jmake_mesh(8),
                                     measure_serial_fine=False)
    assert sharded["converged"]
    assert (sharded["k"], sharded["conv_int"]) == (
        one["k"], one["conv_int"]) == (want["k"], want["conv_int"])
    np.testing.assert_array_equal(sharded["u"], one["u"])
    np.testing.assert_allclose(sharded["u"], want["u"], rtol=1e-12, atol=0)
    assert sharded["timings"]["F_time"] > 0.0


def test_a_run_refuses_a_mesh_it_cannot_use():
    """The blocks gather on the mesh's first device, which must be the
    run's; the blocks run the solver's ``fine_batch_raw``, which a scipy
    solver has not. Both raise before any model runs."""
    p = _padding_parareal(nt, device="cpu")
    with pytest.raises(ValueError, match="first device"):
        p.run(model="parareal", mesh=Mesh(["cuda:0", "cpu"]))
    ode = nt.FHNODE(normalization="-11", device="cpu")
    scipy_p = nt.Parareal(ode, nt.ScipySolver(ode.get_vector_field(), 4, 50,
                                              device="cpu"),
                          [0, 20], 20, verbose=None, device="cpu")
    with pytest.raises(ValueError, match="fine_batch_raw"):
        scipy_p.run(model="parareal", mesh=make_mesh(devices=CPU8))
    assert p.runs == scipy_p.runs == {}
