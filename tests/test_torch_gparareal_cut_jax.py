"""The JAX package's GParareal on the cut FHN of
tests/test_torch_gparareal_cut.py, and a JAX checkpoint resumed in the
port.

* On the CPU the JAX package gives K=6, conv_int [1, 2, 3, 5, 14, 16] with
  Nelder-Mead (fatol = xatol = 1e-6, the JAX driver's Table-2 settings)
  and with the grid search: the values the port's runs are held to.
* The JAX grid run's checkpoint after its third iteration, resumed in the
  port (``Parareal.load_int_dump`` with the JAX GParareal's thetas,
  jitters, hyperparameter history and generator), reaches the same K and
  conv_int.
"""

import os

import pytest
import torch

import nngparareal_torch as nt
from nngparareal_torch.convert import load_checkpoint

from test_torch_gparareal_cut import (EPS, FINE_CUT, JAX_CONV_INT, JAX_K,
                                      SLICES, _one_torch_thread)  # noqa: F401
from test_torch_table2 import jax_run
from test_torch_table2_nm_cut_rk8 import cut

GP = dict(fatol=1e-6, xatol=1e-6)


def test_jax_cut_fhn_gparareal_nm():
    out = jax_run("FHNODE", "gpjax", cut(FINE_CUT, SLICES), **GP)
    assert out["converged"]
    assert (out["k"], out["conv_int"]) == (JAX_K, JAX_CONV_INT)


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_gp_ckpt"))
    out = jax_run("FHNODE", "gpjax", cut(FINE_CUT, SLICES),
                  optimizer="grid", store_int=True, int_dir=jdir, **GP)
    name = f"FHN_ODE_{SLICES}_GP_int"
    return out, os.path.join(jdir, name, f"{name}_2")


def test_jax_cut_fhn_gparareal_grid(jax_grid):
    out, _ = jax_grid
    assert out["converged"]
    assert (out["k"], out["conv_int"]) == (JAX_K, JAX_CONV_INT)


def test_jax_gparareal_checkpoint_resumes_in_the_port(jax_grid):
    full, path = jax_grid
    ode = nt.FHNODE(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    cut(FINE_CUT, SLICES)(cfg)
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=EPS,
                    verbose=None, device="cpu")
    ckpt = load_checkpoint(path)
    assert ckpt["model_name"] == "GP" and ckpt["k"] == 2
    out = p.load_int_dump(path, model="gpjax", optimizer="grid",
                          measure_serial_fine=False, **GP)
    assert out["converged"]
    assert out["k"] == full["k"] == JAX_K
    assert out["conv_int"] == full["conv_int"]
    assert out["conv_int"][:3] == ckpt["conv_int"]
