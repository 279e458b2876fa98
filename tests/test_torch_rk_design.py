"""The fan-out kernels' design, checked on the CPU (csrc/rk_fanout.cu runs
only on a card; tests/test_torch_gpu.py holds it there):

* csrc/tableaus.cuh, the tableaus the kernels are compiled for: every
  hexadecimal literal is bitwise ops/butcher.py's double, the nonzero
  pattern is the coefficients', and the file is what
  ``butcher.cuda_header`` generates;
* the kernels' look-ahead stage sums: a torch transcription of their order
  (kept here, not in the package) gives ``ops/rk.py:rk_step``'s values bit
  for bit, for RK1, RK2, RK4 and RK8, on the seven ODE fields, Burgers and
  FHN-PDE;
* ``chip_smoke.chain_depth``, the dependent operations through one RK
  step, against hand counts;
* ``rk_fanout`` refuses a tableau whose coefficients are not the compiled
  ones (the check is in Python: it runs on CPU tensors too).
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
import nngparareal_torch as nt
from nngparareal_torch.ops import butcher, rk_cuda
from nngparareal_torch.ops.butcher import Tableau, get_tableau
from nngparareal_torch.ops.rk import rk_step, stage_coefficients

TABLEAUS = ["RK1", "RK2", "RK4", "RK8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _header_structs():
    """name -> struct body of csrc/tableaus.cuh."""
    text = rk_cuda.TABLEAUS_H.read_text()
    return dict(re.findall(r"struct (\w+) \{\n(.*?)\n\};", text, re.S))


def _array(body, decl):
    """The values of ``decl = {...};`` in a struct body, row by row."""
    src = re.search(re.escape(decl) + r" = \{(.*?)\};", body, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", src) or [src]
    return [[x.strip() for x in r.split(",") if x.strip()] for r in rows]


@pytest.mark.parametrize("name", TABLEAUS)
def test_header_literals_are_butcher_doubles(name):
    body = _header_structs()[name]
    tab = get_tableau(name)
    S = tab.stages
    assert f"static constexpr int S = {S};" in body
    assert (f"static constexpr int id = {TABLEAUS.index(name)};" in body)
    a = _array(body, "static constexpr double a[S][S]")
    b = _array(body, "static constexpr double b[S]")[0]
    nz_a = _array(body, "static constexpr int nz_a[S][S]")
    nz_b = _array(body, "static constexpr int nz_b[S]")[0]
    assert len(a) == len(nz_a) == S and len(b) == len(nz_b) == S
    for i in range(S):
        assert len(a[i]) == len(nz_a[i]) == S
        for j in range(S):
            want = float(tab.a[i][j]) if j < len(tab.a[i]) else 0.0
            assert float.fromhex(a[i][j]).hex() == want.hex(), (i, j)
            assert nz_a[i][j] == ("1" if want != 0.0 else "0"), (i, j)
    for i in range(S):
        assert float.fromhex(b[i]).hex() == float(tab.b[i]).hex(), i
        assert nz_b[i] == ("1" if tab.b[i] != 0.0 else "0"), i
    # the wrapper passes the same id
    assert rk_cuda.compiled_tableau_id(name) == TABLEAUS.index(name)


def test_header_is_generated_from_butcher():
    assert rk_cuda.TABLEAUS_H.read_text() == butcher.cuda_header()
    assert set(_header_structs()) == set(butcher.TABLEAUS)


def lookahead_step(f, tab, t, u, h):
    """One RK step in the kernels' order: when k_s is ready, (h a_is) k_s
    goes into the running sum of every later stage i with a_is != 0 (each
    sum started at u), and b_s k_s into the weight sum (started at its
    first term); then u + h * weight sum."""
    S = tab.stages
    acc = [None] * S
    bsum = None
    for s in range(S):
        v = u if acc[s] is None else acc[s]
        k = f(t + tab.c[s] * h, v)
        for i in range(s + 1, S):
            a = tab.a[i][s] if s < len(tab.a[i]) else 0.0
            if a != 0.0:
                acc[i] = (u if acc[i] is None else acc[i]) + (h * a) * k
        if tab.b[s] != 0.0:
            term = tab.b[s] * k
            bsum = term if bsum is None else bsum + term
    return u + h * bsum


ODES = ["FHNODE", "Rossler", "Hopf", "DblPend", "Brusselator", "Lorenz",
        "ThomasLabyrinth"]


def _system(name):
    if name == "Burgers":
        return nt.Burgers(d_x=16, normalization="-11", device="cpu")
    if name == "FHNPDE":
        return nt.FHNPDE(d_x=4, normalization="-11", device="cpu")
    return getattr(nt, name)(normalization="-11", device="cpu")


@pytest.mark.parametrize("tab", TABLEAUS)
@pytest.mark.parametrize("name", ODES + ["Burgers", "FHNPDE"])
def test_lookahead_order_is_rk_step_bitwise(name, tab):
    ode = _system(name)
    tab = get_tableau(tab)
    f = ode.get_vector_field()
    rng = np.random.default_rng(7)
    B, d = 6, ode.get_dim()
    u = torch.as_tensor(ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0,
                                                              (B, d)))
    h = torch.as_tensor(rng.uniform(0.01, 0.05, (B, 1)))
    t = torch.as_tensor(rng.uniform(0.0, 1.0, (B, 1)))
    want, got = u, u
    coefs = stage_coefficients(tab, h)
    for n in range(3):
        want = rk_step(f, tab, t + n * h, want, h, coefs)
        got = lookahead_step(f, tab, t + n * h, got, h)
        assert torch.equal(got, want), n
    assert torch.isfinite(got).all()


# Hand counts of the dependent operations through one step (a division or
# sin as one), each field with its [-1,1] map (5: v + 1, * 0.5, * span,
# + mn before the raw field, * scale after):
#   RK4 x Rossler: the longest cycle through an evaluation is u1 -> f1 =
#     u0 + a*u1 (mul, add), 2 + 5 = 7 a stage; 4 stages, 3 stage sums
#     whose last term is a mul and an add (6), the weight sum's last term
#     (2), h * acc (1), u + . (1): 28 + 6 + 4 = 38. Raw: 4 x 2 + 6 + 4 = 18.
#   RK8 x Hopf: u0 -> f0 = -u1 + u0*mu, mu = q - u0*u0 - u1*u1 (mul, sub,
#     sub, mul, add), 5 + 5 = 10; 11 stages, 10 stage sums (20), 4 at the
#     end: 110 + 20 + 4 = 134 (the time coordinate's division runs ahead).
#     Raw: 55 + 20 + 4 = 79.
#   RK8 x Burgers (per cell, FMAs): 4 after the neighbours' loads, 11
#     stages, 10 one-FMA stage sums, the weight sum's and u's FMAs:
#     44 + 10 + 2 = 56 (the 11 exchanges not counted).
@pytest.mark.parametrize("name,norm,tab,depth", [
    ("Rossler", "-11", "RK4", 38),
    ("Rossler", None, "RK4", 18),
    ("Hopf", "-11", "RK8", 134),
    ("Hopf", None, "RK8", 79),
    ("Burgers", "-11", "RK8", 56),
])
def test_chain_depth_matches_hand_count(name, norm, tab, depth):
    if name == "Burgers":
        ode = nt.Burgers(d_x=16, normalization=norm, device="cpu")
    else:
        ode = getattr(nt, name)(normalization=norm, device="cpu")
    assert chip_smoke.chain_depth(get_tableau(tab),
                                  ode.get_device_field()) == depth


def test_chain_bound_counts_the_exchange_and_latencies():
    """The chain bound scales with the measured latencies: Burgers RK8 at
    8 cycles an operation and 50 a store-barrier-load round is
    56 * 8 + 11 * 50 cycles a step."""
    field = nt.Burgers(d_x=16, normalization="-11",
                       device="cpu").get_device_field()
    lat = {"op": 8.0, "div": 100.0, "trig": 200.0, "sync": 50.0}
    assert chip_smoke.chain_cycles(get_tableau("RK8"), field, lat) == (
        56 * 8.0 + 11 * 50.0)


@pytest.mark.parametrize("bad", ["b", "a", "name"])
def test_rk_fanout_refuses_a_tableau_it_is_not_compiled_for(bad):
    ode = _system("Rossler")
    rk4 = get_tableau("RK4")
    tab = {
        "b": Tableau("RK4", rk4.a, (0.25, 0.25, 0.25, 0.25), rk4.c, 4),
        "a": Tableau("RK4", ((0.0,) * 4, (0.5, 0.0, 0.0, 0.0),
                             (0.0, 0.5 + 2 ** -40, 0.0, 0.0),
                             (0.0, 0.0, 1.0, 0.0)), rk4.b, rk4.c, 4),
        "name": Tableau("RK3", rk4.a, rk4.b, rk4.c, 4),
    }[bad]
    U = torch.as_tensor(ode.u0[None, :]).repeat(3, 1)
    t0 = torch.zeros(3, dtype=torch.float64)
    before = rk_cuda.rk_fanout.launches_by_shape.copy()
    with pytest.raises(ValueError, match="tableau"):
        rk_cuda.rk_fanout(t0, t0 + 0.1, U, tab, 5, ode.get_device_field(),
                          ode.get_vector_field())
    assert rk_cuda.rk_fanout.launches_by_shape == before
    # the compiled tableaus themselves pass, by name or object
    assert [rk_cuda.compiled_tableau_id(t) for t in TABLEAUS] == [0, 1, 2, 3]
    assert rk_cuda.compiled_tableau_id(rk4) == 2
