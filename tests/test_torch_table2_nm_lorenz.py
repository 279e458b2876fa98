"""Port parity for Table 2 under the JAX package's default nnGP search,
Nelder-Mead: Lorenz at its full configuration (N=50 over [0, 18], RK4 x6 /
RK4 x450 per slice, m=14, eps=5e-7).

Lorenz is chaotic, and so is the search's path at the rounding level: the
lane-major NLL of the port rounds its exponentials otherwise than XLA
does (SLEEF's exp against XLA's own), and a simplex takes another step
at a near tie. The JAX package against itself with u0 moved by 4e-16 (the
control, tests/test_torch_table2_nm_lorenz_control.py) shows the spread:
K=10 where the unmoved run gives 9, its conv_int agreeing with the
unmoved run's for 6 leading entries. So:

* the JAX run gives K=9 with conv_int JAX_CONV_INT (the CPU oracle of
  PARITY.md:9-16; tests/test_torch_table2_nm_lorenz_jax.py runs it, and
  tests/test_torch_table2_nm_lorenz_control.py the control: one run a
  file, so that pytest-xdist gives each its own worker);
* the port's K is JAX's or the control's (9 or 10), and its conv_int
  agrees with JAX's for no fewer leading entries than the control's do;
* the port's converged iterate agrees with the fine solves from its own
  converged starts within 2e-5, the bound tests/test_parareal.py puts on
  the JAX package (and chip_smoke.py on the port's chip runs).
"""

import numpy as np
import pytest
import torch

from test_torch_table2 import _agree, check_row, port_run

MODELS = ("nngp",)
JAX_K = 9
JAX_CONV_INT = [1, 2, 3, 5, 8, 18, 32, 37, 50]
CONTROL_K = 10
CONTROL_AGREE = 6
SERIAL_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lorenz():
    return port_run("Lorenz", models=MODELS, search={})


def test_lorenz_nm_port_within_the_control(lorenz):
    row, outs = lorenz
    ot = outs["nngp"]
    check_row(row, "Lorenz", 50, models=MODELS)
    assert ot["converged"] and row["runs"][0]["k"] == ot["k"]
    assert ot["k"] in (JAX_K, CONTROL_K)
    assert _agree(ot["conv_int"], JAX_CONV_INT) >= CONTROL_AGREE


def test_lorenz_nm_port_agrees_with_fine_solves(lorenz):
    import nngparareal_torch as nt

    _, outs = lorenz
    out = outs["nngp"]
    ode = nt.Lorenz(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    t, u = out["t"], out["u"]
    ends = s.run_F_batch(t[:-1], t[1:], torch.as_tensor(u[:-1])).numpy()
    assert np.abs(ends - u[1:]).max() <= SERIAL_ATOL
