"""Port parity for models/gp_scipy.py, the GP column's host oracle.

``gpjax_scipy`` (per-task scipy Nelder-Mead, warm-started, with the
random-restart rescue) on the full Table-2 FHN (N=40, RK2 x4 / RK4 x4000
per slice, eps=5e-7, fatol = xatol = 1e-6 as the JAX driver sets them) in
the port (``device="cpu"``) and in the JAX package: both train with numpy
and scipy, on datasets that the two drivers' sweeps round differently in
the last bits. K and conv_int are equal, K=5, conv_int [1, 2, 3, 7, 40]
(PARITY.md:262-267 has 5 for it), and the final iterates agree within
eps of max|u| (both runs stop once an iteration moves no slice end by
eps; measured 3.3e-8). The model's
own contract: a prediction before any fit is the bare correction, on the
query's device.
"""

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt

import nngparareal_torch as nt
from nngparareal_torch.models import Dataset, GPScipy

GP = dict(fatol=1e-6, xatol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fhn(pkg, **dev):
    ode = pkg.FHNODE(normalization="-11", **dev)
    cfg = pkg.Config(ode).get()
    s = pkg.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                     G=cfg["G"], F=cfg["F"], **dev)
    return pkg.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=5e-7,
                        verbose=None, **dev)


def test_gp_scipy_fhn_matches_jax():
    got = _fhn(nt, device="cpu").run(model="gpjax_scipy",
                                     measure_serial_fine=False, **GP)
    want = _fhn(jt).run(model="gpjax_scipy", measure_serial_fine=False, **GP)
    assert got["converged"] and want["converged"]
    assert got["k"] == want["k"] == 5
    assert got["conv_int"] == want["conv_int"] == [1, 2, 3, 7, 40]
    scale = np.abs(want["u"]).max()
    assert np.abs(got["u"] - want["u"]).max() <= 5e-7 * scale


def test_gp_scipy_predicts_the_bare_correction_before_a_fit():
    m = GPScipy(2, 4)
    uF = torch.tensor([1.0, 2.0])
    uG = torch.tensor([0.5, 0.25])
    ds = Dataset.empty(8, 2, device="cpu")
    pred = m.predict_fn(ds, torch.zeros(2), uF, uG, 0)
    assert torch.equal(pred, uF - uG)
    m.fit(ds, 0)  # no valid rows
    assert torch.equal(m.predict_fn(ds, torch.zeros(2), uF, uG, 0), uF - uG)
