"""Port parity for Table 2 under the JAX package's default nnGP search,
Nelder-Mead, at cut configurations: Hopf (N=32) and the double pendulum,
whose fine solver is RK8.

The port's ``experiments.run_table2`` with the nnGP and no ``nngp_kw``
(``device="cpu"``) against the JAX package's nnGP with its defaults, with
the same cut applied to the configuration in both packages: the fine
step count per slice cut as tests/test_torch_table2_cut_rk8.py cuts it
(40x for Hopf, 50x for DblPend), and the first 8 slices of the
configuration's width in place of all 32. Every interval runs a
Nelder-Mead search, whatever the fine step count: the slice count is what
keeps the CPU run short (a search takes ~0.3 s here).

K and conv_int are equal, and the final iterates agree within eps of
max|u| (tests/test_torch_table2.py:check_against_jax).
"""

import pytest
import torch

from test_torch_table2 import check_against_jax, check_row, runs_of

MODELS = ("nngp",)
SLICES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut(factor, slices=SLICES):
    """Nf // factor, and the first ``slices`` slices of the configured
    width."""
    def edit(cfg):
        cfg["Nf"] //= factor
        width = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
        cfg["tspan"] = [cfg["tspan"][0], cfg["tspan"][0] + slices * width]
        cfg["N"] = slices
    return edit


CUTS = {"Hopf": cut(40), "DblPend": cut(50)}


@pytest.fixture(scope="module", params=sorted(CUTS))
def cut_run(request):
    return request.param, runs_of(request.param, CUTS[request.param],
                                  controls=False, models=MODELS, search={})


def test_cut_nm_table2_matches_jax(cut_run):
    check_against_jax(cut_run[1], "nngp")


def test_cut_nm_table2_row(cut_run):
    name, runs = cut_run
    # Hopf's name carries the N its Config was built for
    check_row(runs["port"][0], name, 32, models=MODELS)
