"""``Parareal.load_int_dump`` keeps the resumed run in ``self.runs``, as the
JAX package's does (ROADMAP.md, fault 5).

A checkpoint the JAX package wrote after FHN's fourth bare-Parareal
iteration (``store_int=True, early_stop=4``) is resumed in both packages
with ``cstm_mdl_name="a"``: the ``runs`` keys, K and conv_int are equal,
and the final iterates agree within 1e-12 (bare Parareal has no model
search to sit at a tie; the two fan-outs part by XLA's FMA contractions
alone, a few ulp). Without the keyword the run is kept under the model's
name, and a model instance is taken as it is.
"""

import os

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt

import nngparareal_torch as nt
from nngparareal_torch.models import BareParareal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fhn(pkg, **kw):
    ode = pkg.FHNODE(normalization="-11", **kw)
    cfg = pkg.Config(ode).get()
    s = pkg.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                     G=cfg["G"], F=cfg["F"], **kw)
    return pkg.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=5e-7,
                        verbose=None, **kw)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The JAX checkpoint of iteration 4 (k=3), resumed in both packages
    under the name "a"."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    pj = _fhn(jt)
    pj.run(model="parareal", store_int=True, early_stop=4, int_dir=d,
           measure_serial_fine=False)
    ckpt = os.path.join(d, "FHN_ODE_40_Parareal_int", "FHN_ODE_40_Parareal_int_3")
    pj = _fhn(jt)
    oj = pj.load_int_dump(ckpt, model="parareal", cstm_mdl_name="a",
                          measure_serial_fine=False)
    pt = _fhn(nt, device="cpu")
    ot = pt.load_int_dump(ckpt, model="parareal", cstm_mdl_name="a",
                          measure_serial_fine=False)
    return ckpt, (pj, oj), (pt, ot)


def test_resumed_run_kept_under_its_name(resumed):
    _, (pj, oj), (pt, ot) = resumed
    assert list(pt.runs) == list(pj.runs) == ["a"]
    assert pt.runs["a"] is ot and pj.runs["a"] is oj


def test_resumed_run_matches_jax(resumed):
    _, (pj, oj), (pt, ot) = resumed
    assert ot["converged"] and oj["converged"]
    assert ot["k"] == oj["k"] == 11
    assert ot["conv_int"] == oj["conv_int"]
    np.testing.assert_allclose(ot["u"], oj["u"], rtol=0,
                               atol=1e-12 * np.abs(oj["u"]).max())


@pytest.mark.parametrize("model", ["name", "instance"])
def test_resumed_run_kept_under_the_models_name(resumed, model):
    """One more iteration from the checkpoint (``early_stop=5``): kept as
    runs["Parareal"], the model's name; an instance is used as it is."""
    ckpt = resumed[0]
    pt = _fhn(nt, device="cpu")
    mdl = "parareal" if model == "name" else BareParareal(pt.n, pt.N)
    out = pt.load_int_dump(ckpt, model=mdl, early_stop=5,
                           measure_serial_fine=False)
    assert list(pt.runs) == ["Parareal"] and pt.runs["Parareal"] is out
    assert out["k"] == 5 and len(out["conv_int"]) == 5
