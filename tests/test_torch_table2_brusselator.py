"""Port parity for the Table-2 driver: the Brusselator at its full
configuration (N=25 over [0, 100], RK4 x10 / RK4 x1000 per slice, nnGP
m=14 with the grid search, eps=5e-7).

The port's ``experiments.run_table2`` (``device="cpu"``) against the JAX
package, with the checks and the control of tests/test_torch_table2.py:
K equal and equal to the CPU IEEE-f64 oracle of PARITY.md:9-16
(Parareal 19, nnGP 18). The nnGP's grid search is near a tie in its early
sweeps: under the control (u0 moved by 4e-16) the JAX run converges in 17
iterations instead of 18, and its conv_int departs from the unmoved run's
at the seventh entry (``test_brusselator_nngp_control_is_near_a_tie``).
The port's nnGP conv_int agrees with JAX's for its first 11 entries: the
twelfth is 17 against JAX's 16, and the six after it are JAX's again.
"""

import pytest
import torch

from test_torch_table2 import _agree, check_against_jax, check_row, runs_of


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def brusselator():
    return runs_of("Brusselator")


@pytest.mark.parametrize("model,k,agree", [("parareal", 19, None),
                                           ("nngp", 18, 11)])
def test_brusselator_table2_matches_jax(brusselator, model, k, agree):
    check_against_jax(brusselator, model, k, agree)


def test_brusselator_table2_row(brusselator):
    check_row(brusselator["port"][0], "Brusselator", 25)


def test_brusselator_nngp_control_is_near_a_tie(brusselator):
    oj, oc = brusselator["nngp"], brusselator["nngp_control"]
    assert (oj["k"], oc["k"]) == (18, 17)
    assert _agree(oc["conv_int"], oj["conv_int"]) == 6
