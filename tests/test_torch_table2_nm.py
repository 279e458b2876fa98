"""Port parity for Table 2 under the JAX package's default nnGP search,
Nelder-Mead: the FHN ODE at its full configuration (N=40 over [0, 40],
RK2 x4 / RK4 x4000 per slice, m=15, eps=5e-7).

The port's ``experiments.run_table2`` with the nnGP and no ``nngp_kw``
(``device="cpu"``) against the JAX package's ``Parareal.run(model="nngp",
nn=15)``, which runs Nelder-Mead with its defaults (one restart per
(coordinate, jitter) task, fatol = xatol = 0.1, at most 200 iterations,
starts drawn from seed 45). K is 5 in both, the CPU IEEE-f64 oracle of
PARITY.md:9-16; conv_int is equal, and the final iterates agree within
eps of max|u| (tests/test_torch_table2.py:check_against_jax).

The port stops each search once every simplex has frozen: every search
ran at most 200 iterations, one search per active interval.
"""

import pytest
import torch

from test_torch_table2 import check_against_jax, check_row, runs_of

NM = {}  # no nngp_kw: the default search
MODELS = ("nngp",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fhn():
    return runs_of("FHNODE", controls=False, models=MODELS, search=NM)


def test_fhn_nm_table2_matches_jax(fhn):
    check_against_jax(fhn, "nngp", k_oracle=5)


def test_fhn_nm_table2_row(fhn):
    row, outs = fhn["port"]
    check_row(row, "FHNODE", 40, models=MODELS)
    tm = outs["nngp"]["timings"]
    starts = [0] + outs["nngp"]["conv_int"][:-1]
    intervals = sum(40 - (i + 1) for i in starts if i + 1 < 40)
    its = tm["nm_iterations"]
    assert len(its) == intervals
    assert all(0 <= i <= 200 for i in its) and max(its) > 0
    assert tm["nm_graph_replays"] == 0  # the CPU runs no graph
