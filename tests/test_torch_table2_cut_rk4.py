"""Port parity for the Table-2 driver at cut configurations: Rossler and
the FHN ODE, whose fine solver is RK4.

The port's ``experiments.run_table2`` (``device="cpu"``) against the JAX
package, both models, with the same cut applied to the configuration in
both packages (the CPU runs the port's fields as torch ops, step by step):

* FHN ODE: the fine step count per slice cut 10x (400 RK4 steps).
* Rossler: the fine step count per slice cut 100x (1125 RK4 steps), and
  8 slices of the configuration's width over [0, 68] in place of 40 over
  [0, 340]. Its coarse RK1 x2250 per slice is not cut: fewer coarse
  steps make its first coarse solve blow up.

K and conv_int are equal, and the final iterates agree within eps of
max|u| (tests/test_torch_table2.py:check_against_jax).
"""

import pytest
import torch

from test_torch_table2 import check_against_jax, check_row, runs_of


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut_fhn(cfg):
    cfg["Nf"] //= 10


def _cut_rossler(cfg):
    cfg["Nf"] //= 100
    cfg["N"] //= 5
    cfg["tspan"] = [0, cfg["tspan"][1] / 5]


CUTS = {"FHNODE": (_cut_fhn, 40), "Rossler": (_cut_rossler, 8)}


@pytest.fixture(scope="module", params=sorted(CUTS))
def cut_run(request):
    edit, N = CUTS[request.param]
    return request.param, N, runs_of(request.param, edit, controls=False)


@pytest.mark.parametrize("model", ["parareal", "nngp"])
def test_cut_table2_matches_jax(cut_run, model):
    check_against_jax(cut_run[2], model)


def test_cut_table2_row(cut_run):
    name, N, runs = cut_run
    check_row(runs["port"][0], name, N)
