"""GParareal with ``score_lanes=True`` (the grid search scored through the
blocked lane-major NLL, ``ops/gp_lanes.py:nll_lanes_big``) on the cut FHN
of tests/test_torch_gparareal_cut.py: 16 slices, the fine step count cut
10x, the grid search at the JAX driver's Table-2 settings, on the CPU.

Its fits run at buckets 16, 32, 64, 64, 128 and 128 rows, so the blocked
factor runs whole (16, 32, 64, 128: one to eight blocks of 16). The JAX
package on the CPU gives K=6, conv_int [1, 2, 3, 5, 14, 16] with
``score_lanes=True`` (as without it); the port gives the same. The JAX
run (~20 s, its blocked graphs compiled at every bucket) is
``test_jax_cut_fhn_score_lanes``, skipped unless RUN_SLOW=1: with the
port's ~30 s run the file would pass its share of the suite's time.
"""

import os

import pytest

from test_torch_gparareal_cut import (FINE_CUT, SLICES,  # noqa: F401
                                      _one_torch_thread, port_gp_run)
from test_torch_table2_nm_cut_rk8 import cut

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
LANES = dict(optimizer="grid", score_lanes=True)
# the JAX package on the CPU, score_lanes=True (test_jax_cut_fhn_score_lanes)
JAX_LANES_K = 6
JAX_LANES_CONV_INT = [1, 2, 3, 5, 14, 16]


def test_cut_fhn_score_lanes_gives_jax_k_and_conv_int():
    summary, out = port_gp_run(LANES)
    assert out["converged"]
    assert summary["k"] == out["k"] == JAX_LANES_K
    assert out["conv_int"] == JAX_LANES_CONV_INT
    tm = out["timings"]
    assert tm["gp_buckets"] == [16, 32, 64, 64, 128, 128]
    assert tm["alpha_unusable"] == 0 and "nm_iterations" not in tm


@pytest.mark.skipif(not RUN_SLOW, reason="the JAX run (set RUN_SLOW=1)")
def test_jax_cut_fhn_score_lanes():
    from test_torch_table2 import jax_run

    out = jax_run("FHNODE", "gpjax", cut(FINE_CUT, SLICES), fatol=1e-6,
                  xatol=1e-6, **LANES)
    assert out["converged"]
    assert (out["k"], out["conv_int"]) == (JAX_LANES_K, JAX_LANES_CONV_INT)
