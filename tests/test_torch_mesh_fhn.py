"""FHN at its Table-2 configuration (N=40 over [0, 40], RK2 x4 / RK4
x4000), bare Parareal with the fine fan-out over an 8-block mesh on the
CPU: the JAX package's mesh run's K and conv_int on its 8 virtual CPU
devices (tests/test_sharding.py:test_full_run_on_mesh_matches_serial),
``u`` within 1e-12 of it, and bitwise the port's unsharded run. 40
slices over 8 blocks divide at first and are padded once slices
converge.

On the CPU each block runs the plain integrator's step loop on its own,
so the mesh run costs about 8 unsharded runs (~80 s of this file's
~100 s).
"""

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt
from nngparareal_tpu.parallel.mesh import make_mesh as jmake_mesh

import nngparareal_torch as nt

from test_torch_mesh import _one_torch_thread  # noqa: F401


def _fhn(pkg, **kw):
    ode = pkg.FHNODE(normalization="-11", **kw)
    cfg = pkg.Config(ode).get()
    s = pkg.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                     G=cfg["G"], F=cfg["F"], **kw)
    return pkg.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=5e-7,
                        verbose=None, **kw)


def test_fhn_table2_run_on_an_8_block_mesh():
    run = dict(model="parareal", measure_serial_fine=False)
    sharded = _fhn(nt, device="cpu").run(
        mesh=nt.make_mesh(devices=["cpu"] * 8), **run)
    one = _fhn(nt, device="cpu").run(**run)
    want = _fhn(jt).run(mesh=jmake_mesh(8), **run)
    assert sharded["converged"] and sharded["k"] == 11
    assert (sharded["k"], sharded["conv_int"]) == (
        one["k"], one["conv_int"]) == (want["k"], want["conv_int"])
    np.testing.assert_array_equal(sharded["u"], one["u"])
    np.testing.assert_allclose(sharded["u"], want["u"], rtol=1e-12, atol=0)
