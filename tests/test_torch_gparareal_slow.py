"""GParareal at the full Table-2 FHN configuration, in the port on the CPU
against the JAX package (slow: minutes; set RUN_SLOW=1, as
tests/test_parareal.py's GParareal runs are).

FHN ODE (N=40, RK2 x4 / RK4 x4000 per slice, eps=5e-7): the JAX package on
the CPU gives K=5 with Nelder-Mead at the Table-2 settings (fatol = xatol
= 1e-6; conv_int [1, 2, 3, 7, 40]) and with the grid search (conv_int
[1, 2, 3, 9, 40]), as tests/test_parareal.py:53-68 holds it. The port's
``run_table2`` with ``models=("gpjax",)`` gives K=5 and JAX's conv_int
under both (measured: about ten minutes for the two, both packages).
"""

import os

import pytest

from test_torch_gparareal_cut import _one_torch_thread, port_gp_run  # noqa: F401
from test_torch_table2 import jax_run

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
pytestmark = pytest.mark.skipif(not RUN_SLOW,
                                reason="minutes on CPU (set RUN_SLOW=1)")


@pytest.mark.parametrize("gp_kw", [None, dict(optimizer="grid")],
                         ids=["nm", "grid"])
def test_full_fhn_gparareal_k5(gp_kw):
    summary, out = port_gp_run(gp_kw, edit=lambda cfg: None)
    want = jax_run("FHNODE", "gpjax", fatol=1e-6, xatol=1e-6,
                   **(gp_kw or {}))
    print("port", out["conv_int"], "jax", want["conv_int"])
    assert out["converged"] and want["converged"]
    assert summary["k"] == out["k"] == want["k"] == 5
    assert out["conv_int"] == want["conv_int"]
