"""Port parity for the Table-2 driver at cut configurations: Hopf (N=32)
and the double pendulum, whose fine solver is RK8.

The port's ``experiments.run_table2`` (``device="cpu"``) against the JAX
package, both models, with the same cut applied to the configuration in
both packages (the CPU runs the port's fields as torch ops, step by step):
the fine step count per slice cut 40x for Hopf (136 RK8 steps) and 50x
for DblPend (135 RK8 steps). The coarse solvers are not cut.

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


def _cut(factor):
    def edit(cfg):
        cfg["Nf"] //= factor
    return edit


CUTS = {"Hopf": (_cut(40), 32), "DblPend": (_cut(50), 32)}


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
