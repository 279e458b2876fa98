"""Port parity: tableaus, normaliser, systems and configs.

The same numpy inputs (``np.random.default_rng``) go through the JAX
package (on the CPU, f64) and nngparareal_torch (``device="cpu"``).
Tolerance: rtol 1e-14 for the fields (the eager torch ops and the JAX ops
are the same arithmetic; a few ulp of slack for XLA's op fusion).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops import butcher as jbutcher
from nngparareal_tpu.systems import configs as jconfigs

import nngparareal_torch as nt
from nngparareal_torch.ops import butcher as tbutcher
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.ops.rk_cuda import BurgersField, OdeField


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-14


@pytest.mark.parametrize("name", ["RK1", "RK2", "RK4", "RK8"])
def test_tableaus_equal(name):
    a = jbutcher.get_tableau(name)
    b = tbutcher.get_tableau(name)
    assert (a.name, a.a, a.b, a.c, a.order) == (b.name, b.a, b.b, b.c, b.order)


def test_rk8_shape_and_flat_layout():
    """RK8's shape, and the dense layout the kernels are compiled with
    (csrc/tableaus.cuh: a as S x S rows, then b)."""
    tab = tbutcher.get_tableau("RK8")
    assert tab.stages == 11
    assert sum(1 for row in tab.a for x in row if x != 0.0) == 39
    assert sum(1 for x in tab.b if x != 0.0) == 5
    a = tbutcher.dense_a(tab)
    assert len(a) == 11 and all(len(row) == 11 for row in a)
    assert a[3][2] == tab.a[3][2] and a[0][5] == 0.0
    header = rk_cuda.TABLEAUS_H.read_text()
    assert "struct RK8 {\n    static constexpr int id = 3;" in header
    assert rk_cuda.compiled_tableau_id(tab) == 3


def _pair(kind, **kw):
    if kind == "burgers":
        return (jt.Burgers(normalization=kw.get("norm"), d_x=kw["d_x"]),
                nt.Burgers(normalization=kw.get("norm"), d_x=kw["d_x"],
                           device="cpu"))
    return (jt.FHNODE(normalization=kw.get("norm")),
            nt.FHNODE(normalization=kw.get("norm"), device="cpu"))


CASES = [
    ("burgers", {"d_x": 16, "norm": "-11"}),
    ("burgers", {"d_x": 128, "norm": "-11"}),
    ("burgers", {"d_x": 16, "norm": None}),
    ("fhn", {"norm": "-11"}),
    ("fhn", {"norm": None}),
]


@pytest.mark.parametrize("kind,kw", CASES, ids=lambda v: str(v))
def test_vector_field_matches_jax(kind, kw):
    oj, ot = _pair(kind, **kw)
    d = oj.get_dim()
    U = np.random.default_rng(1).uniform(-1.0, 1.0, (7, d))
    fj = jax.jit(jax.vmap(lambda u: oj.get_vector_field()(0.0, u)))
    want = np.asarray(fj(jnp.asarray(U)))
    got = ot.get_vector_field()(0.0, torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14 * np.abs(want).max())
    # one state (d,) and a batch (B, d) go through the same field
    one = ot.get_vector_field()(0.0, torch.as_tensor(U[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("kind,kw", CASES, ids=lambda v: str(v))
def test_init_cond_matches_jax(kind, kw):
    oj, ot = _pair(kind, **kw)
    u0 = ot.get_init_cond()
    assert u0.dtype == torch.float64 and u0.device.type == "cpu"
    np.testing.assert_allclose(u0.numpy(), oj.get_init_cond(), rtol=RTOL)
    assert ot.get_dim() == oj.get_dim() and ot.name == oj.name


def test_burgers_device_field_constants():
    oj, ot = _pair("burgers", d_x=128, norm="-11")
    fld = ot.get_device_field()
    assert isinstance(fld, BurgersField)
    assert fld.inv_h2 == oj._inv_h2
    assert fld.half_inv_2h == 0.5 * oj._inv_2h
    # the kernel knows only Burgers' normalised form
    assert nt.Burgers(d_x=16, device="cpu").get_device_field() is None
    # the FHN ODE has the one-thread-per-slice kernel's field
    # (tests/test_torch_odes.py holds its constants)
    assert isinstance(nt.FHNODE(normalization="-11",
                                device="cpu").get_device_field(), OdeField)


@pytest.mark.parametrize("kind", ["fhn", "burgers"])
def test_configs_match_jax(kind):
    oj, ot = _pair(kind, d_x=128, norm="-11")
    cj = jconfigs.Config(oj).get()
    ct = nt.Config(ot).get()
    assert set(cj) == set(ct)
    for key in cj:
        if key == "u0":
            np.testing.assert_array_equal(ct[key], cj[key])
        else:
            assert ct[key] == cj[key], key


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.Burgers(d_x=16, normalization="-11")
    ode = nt.FHNODE(normalization="-11", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.RKSolver(ode.get_vector_field(), 4, 8, G="RK2", F="RK4")
