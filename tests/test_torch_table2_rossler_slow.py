"""Rossler's nnGP at its full Table-2 configuration, in the port on the
CPU (slow: about ten minutes; set RUN_SLOW=1, as tests/test_parity_slow.py
is run).

Rossler (N=40 over [0, 340], RK1 x2250 / RK4 x112 500 per slice, m=15,
grid search, eps=5e-7) gives K=13 in the JAX package on the CPU, and 11
through the port, on the CPU as on the card. These tests show where the
difference comes from:

* The port's run on the CPU reaches K=11. Iteration by iteration it stays
  within 10x of the gap that the control (the JAX package against itself
  with u0 moved by 4e-16, sign draws 0-4) opens: both are ~1e-8 after the
  coarse initialisation and ~0.6 after the first nnGP iteration, where
  the model, fit on a handful of points, amplifies any last-ulp change.
* Resumed from the JAX run's checkpoint after its fifth iteration, the
  port reaches the JAX run's K=13, and its conv_int agrees with JAX's for
  the first 8 entries. So from the same state the port's nnGP makes the
  JAX package's choices, and the K=11 comes from the rounding-level gap
  that the first five iterations amplify.
"""

import os

import numpy as np
import pytest
import torch

import nngparareal_torch as nt

from test_torch_table2 import (EPS, GRID, NN, NUDGE, _agree, jax_run,
                               port_run)

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
pytestmark = pytest.mark.skipif(not RUN_SLOW,
                                reason="minutes on CPU (set RUN_SLOW=1)")

RESUME_AFTER = 5  # the JAX checkpoint the port resumes from: iteration 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rossler(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    runs = {"jax": jax_run("Rossler", "nngp", store_int=True,
                           int_dir=jdir)}
    runs["controls"] = [jax_run("Rossler", "nngp", nudge=NUDGE, sign_seed=s)
                        for s in range(5)]
    name = "Rossler_40_NNGP_int"
    runs["jax_ckpt"] = os.path.join(jdir, name,
                                    f"{name}_{RESUME_AFTER - 1}")
    return runs


def _gaps(a, b):
    """Max |a - b| of two runs' iterates, per iteration both have."""
    k = min(a["u_hist"].shape[2], b["u_hist"].shape[2])
    return np.abs(a["u_hist"][:, :, :k] - b["u_hist"][:, :, :k]).max(
        axis=(0, 1))


def test_rossler_port_nngp_full_size_on_cpu(rossler):
    oj = rossler["jax"]
    assert oj["converged"] and oj["k"] == 13
    _, outs = port_run("Rossler", models=("nngp",))
    ot = outs["nngp"]
    assert ot["converged"] and ot["k"] == 11
    assert ot["conv_int"] == [1, 2, 3, 4, 5, 13, 17, 25, 29, 34, 40]
    port = _gaps(ot, oj)
    control = np.max([_gaps(oc, oj)[:len(port)]
                      for oc in rossler["controls"]], axis=0)
    k = len(control)
    # the gaps per iteration, for the record (run with -s to see them)
    print(f"\nRossler port vs JAX, max |du| per iteration: {port}\n"
          f"the control draws' largest: {control}")
    assert np.all(port[:k] <= 10 * control), (port, control)


def test_rossler_port_resumes_jax_after_iteration_5(rossler):
    oj = rossler["jax"]
    ode = nt.Rossler(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=EPS,
                    verbose=None, device="cpu")
    out = p.load_int_dump(rossler["jax_ckpt"], model="nngp",
                          nn=NN["Rossler"], measure_serial_fine=False,
                          **GRID)
    assert out["converged"] and out["k"] == oj["k"] == 13
    assert out["conv_int"][:RESUME_AFTER] == oj["conv_int"][:RESUME_AFTER]
    assert _agree(out["conv_int"], oj["conv_int"]) == 8, (
        out["conv_int"], oj["conv_int"])
