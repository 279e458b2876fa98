"""Port parity for Table 2 under the JAX package's default nnGP search,
Nelder-Mead, at cut configurations: Rossler and the Brusselator, whose
fine solver is RK4.

As tests/test_torch_table2_nm_cut_rk8.py: the port's
``experiments.run_table2`` with no ``nngp_kw`` against the JAX package's
nnGP with its defaults, the same cut in both packages. Rossler's fine
step count per slice is cut 100x, as tests/test_torch_table2_cut_rk4.py
cuts it (its coarse RK1 x2250 is not: fewer coarse steps make its first
coarse solve blow up); the Brusselator's RK4 x1000 is not cut. Both run
the first 8 slices of their configured width.

K and conv_int are equal, and the final iterates agree within eps of
max|u| (tests/test_torch_table2.py:check_against_jax).
"""

import pytest
import torch

from test_torch_table2 import check_against_jax, check_row, runs_of
from test_torch_table2_nm_cut_rk8 import MODELS, cut

CUTS = {"Rossler": cut(100), "Brusselator": cut(1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CUTS))
def cut_run(request):
    return request.param, runs_of(request.param, CUTS[request.param],
                                  controls=False, models=MODELS, search={})


def test_cut_nm_table2_matches_jax(cut_run):
    check_against_jax(cut_run[1], "nngp")


def test_cut_nm_table2_row(cut_run):
    name, runs = cut_run
    check_row(runs["port"][0], name, 8, models=MODELS)
