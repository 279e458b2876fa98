"""The JAX package's own spread on Lorenz under Nelder-Mead (Table 2, full
configuration, m=14, eps=5e-7): with u0 moved by 4e-16 (sign draw 0, the
control of tests/test_torch_table2.py) its nnGP converges in 10
iterations where the unmoved run takes 9
(tests/test_torch_table2_nm_lorenz_jax.py), and its conv_int agrees with
the unmoved run's for the first 6 entries only.
tests/test_torch_table2_nm_lorenz.py holds the port to this spread.
"""

from test_torch_table2 import NUDGE, _agree, jax_run
from test_torch_table2_nm_lorenz import (CONTROL_AGREE, CONTROL_K,
                                         JAX_CONV_INT)


def test_lorenz_nm_control_spread():
    oc = jax_run("Lorenz", "nngp", nudge=NUDGE, sign_seed=0, search={})
    assert oc["converged"] and oc["k"] == CONTROL_K
    assert _agree(oc["conv_int"], JAX_CONV_INT) == CONTROL_AGREE
