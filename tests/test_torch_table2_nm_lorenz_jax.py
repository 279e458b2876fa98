"""The JAX package on Lorenz under Nelder-Mead (Table 2, full
configuration, m=14, eps=5e-7), the oracle of
tests/test_torch_table2_nm_lorenz.py: its nnGP converges in 9 iterations
with conv_int JAX_CONV_INT, the CPU value of PARITY.md:9-16.
tests/test_torch_table2_nm_lorenz_control.py runs its control.
"""

from test_torch_table2 import jax_run
from test_torch_table2_nm_lorenz import JAX_CONV_INT, JAX_K


def test_lorenz_nm_jax_run_is_the_oracle():
    out = jax_run("Lorenz", "nngp", search={})
    assert out["converged"] and out["k"] == JAX_K
    assert out["conv_int"] == JAX_CONV_INT
