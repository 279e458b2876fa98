"""Port end to end on the FHN ODE: the published iteration counts K.

FHN ODE (N=40, RK2/RK4, [-1,1]-normalised): bare Parareal K=11 at
eps=5e-7 and K=14 at 5e-9, nnGParareal (m=15) K=5 at 5e-7, as
tests/test_parareal.py:29-50 hold the JAX package. The port has the grid
search only; its K is 5 too (PARITY.md, nnGP(grid) column). K is exact.
"""

import pytest
import torch

import nngparareal_torch as nt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPS = 5e-7


def _fhn(epsilon=EPS):
    ode = nt.FHNODE(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"], device="cpu")
    return nt.Parareal(ode, solver, cfg["tspan"], cfg["N"], epsilon=epsilon,
                       verbose=None, device="cpu")


@pytest.mark.parametrize("epsilon,k", [(5e-7, 11), (5e-9, 14)])
def test_fhn_bare_parareal(epsilon, k):
    out = _fhn(epsilon).run(model="parareal", measure_serial_fine=False)
    assert out["converged"]
    assert out["k"] == k


def test_fhn_nngp_k5():
    out = _fhn().run(model="nngp", nn=15, optimizer="grid",
                     measure_serial_fine=False)
    assert out["converged"]
    assert out["k"] == 5
    assert out["x"].shape == out["D"].shape and out["x"].shape[0] > 0
