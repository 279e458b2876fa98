"""The port's GParareal end to end on a cut FHN, against the JAX package's
K and conv_int.

FHN ODE (Table 2, eps=5e-7) cut to its first 16 slices of the configured
width, with the fine step count per slice cut 10x (RK4 x400), run through
the port's ``experiments.run_table2`` with ``models=("gpjax",)`` on the
CPU: Nelder-Mead with the JAX driver's Table-2 settings (fatol = xatol =
1e-6, at most 400 iterations), and the grid search (``gp_kw``). The JAX
package on the CPU gives K=6, conv_int [1, 2, 3, 5, 14, 16] under both
searches (tests/test_torch_gparareal_cut_jax.py runs it); the port gives
the same K and the same conv_int. Its fits run on both sides of the
48-row switch: buckets 16 and 32 (the column-loop Cholesky), then 64 and
128 (the library's).
"""

import pytest
import torch

from nngparareal_torch import driver as tdriver
from nngparareal_torch import experiments as texp

from test_torch_table2_nm_cut_rk8 import cut

EPS = 5e-7
SLICES = 16
FINE_CUT = 10
# the JAX package on the CPU, both searches (test_torch_gparareal_cut_jax)
JAX_K = 6
JAX_CONV_INT = [1, 2, 3, 5, 14, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_gp_run(gp_kw=None, edit=cut(FINE_CUT, SLICES)):
    """The port's run_table2 for the cut FHN with GParareal alone: its
    summary row and the run's output."""
    outs = []
    run = tdriver.Parareal.run

    def keep(self, *args, **kwargs):
        assert kwargs["fatol"] == kwargs["xatol"] == 1e-6
        out = run(self, *args, measure_serial_fine=False, **kwargs)
        outs.append(out)
        return out

    class Cut(texp.Config):
        def get(self):
            cfg = super().get()
            edit(cfg)
            return cfg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdriver.Parareal, "run", keep)
        mp.setattr(texp, "Config", Cut)
        rows = texp.run_table2(EPS, models=("gpjax",), results_dir=None,
                               systems=["FHN_ODE"], device="cpu",
                               gp_kw=gp_kw)
    (row,) = rows
    (summary,) = row["runs"]
    assert summary["name"] == "gpjax"
    return summary, outs[0]


@pytest.mark.parametrize("gp_kw", [None, dict(optimizer="grid")],
                         ids=["nm", "grid"])
def test_cut_fhn_gparareal_gives_jax_k_and_conv_int(gp_kw):
    summary, out = port_gp_run(gp_kw)
    assert out["converged"]
    assert summary["k"] == out["k"] == JAX_K
    assert out["conv_int"] == JAX_CONV_INT
    tm = out["timings"]
    buckets = tm["gp_buckets"]
    assert min(buckets) <= 48 < max(buckets)  # both sides of the switch
    assert buckets == [16, 32, 64, 64, 128, 128]
    assert tm["alpha_unusable"] == 0
    if gp_kw is None:
        # one Nelder-Mead search a fit, none past its 400 iterations
        assert len(tm["nm_iterations"]) == len(buckets)
        assert max(tm["nm_iterations"]) <= 400
    else:
        assert "nm_iterations" not in tm
