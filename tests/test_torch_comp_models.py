"""Port parity for the driver's shadow harness (``comp_models``) and its
debug record, the port of tests/test_comp_models.py.

FHN at its configuration, bare Parareal for three iterations with two
shadow models (kNN-mean nn=12, and the nnGP nn=12 with the grid search),
in both packages on the CPU:

* ``debug_dict``: ``all_pred_err``, ``mean_errs``, ``max_errs`` and
  ``one_step_error`` against JAX's, and the kNN-mean shadow's errors
  (``err_store_mdls``): rtol 1e-12.
* The nnGP shadow's errors: its grid search at iteration 0 sits at a near
  tie that JAX's own control (u0 moved by 4e-16, each coordinate up or
  down) moves by ~2.6e-4; the port lies within 10x that control's gap in
  every iteration. The nnGP shadow beats kNN-mean, as in JAX.
* ``cstm_mdl_name``, ``add_model`` and ``self.runs``; the shadows' names
  (a name, an instance, or (name, keywords) with ``cstm_name``).

Figure 2's second study (scripts/figure2_rossler.py:53-59: the scipy
GParareal on Rossler with nnGP grid shadows at m = 10, 25, 40) runs on
the CPU under RUN_SLOW (~14 minutes): K 12-13 (the JAX package's and
results/figure2_rossler.pkl's 12; JAX with u0 moved by 4e-16 gives 13),
and every shadow's log10 mean error at k = 5, 6, 7 within half a decade
of the main model's, as in the pickle. Its per-iteration errors are no
oracle: the scipy fits sit at near ties, and at k <= 7 the current JAX
package parts from the pickle by up to 0.17 decades, its control by up
to 0.61, the port by up to 0.86. On the card the study waits for batched
shadow predictions (ROADMAP.md).
"""

import os

import numpy as np
import pytest
import torch

import nngparareal_torch as nt
from nngparareal_torch.models import KNNMean

from test_torch_knn_elm import _one_torch_thread, fhn_pair  # noqa: F401

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"

SHADOWS = [("knn_mean", {"nn": 12}), ("nngp", {"nn": 12, "optimizer": "grid"})]
KNN, GP = "knn_mean:kNN-mean", "nngp:NNGP"


def _run(p, **kw):
    return p.run(model="parareal", early_stop=3, comp_models=SHADOWS,
                 measure_serial_fine=False, **kw)


@pytest.fixture(scope="module")
def runs():
    pj, pt = fhn_pair()
    oj = _run(pj)
    ot = _run(pt, cstm_mdl_name="para_study", add_model=True)
    pc, _ = fhn_pair(nudge=4e-16, sign_seed=0)
    return oj, ot, pt, _run(pc)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def test_debug_record_matches_jax(runs):
    oj, ot, _, _ = runs
    dj, dt = oj["debug_dict"], ot["debug_dict"]
    assert sorted(dt) == sorted(dj)
    assert ot["k"] == oj["k"] == 3 and ot["conv_int"] == oj["conv_int"]
    for key in ("all_pred_err", "mean_errs", "max_errs"):
        assert len(dt[key]) == len(dj[key]) == 3
        for a, b in zip(dt[key], dj[key]):
            assert a.shape == b.shape
            assert _rel(a, b) <= 1e-12, key
    assert dt["one_step_error"].shape == dj["one_step_error"].shape == (3, 2)
    assert _rel(dt["one_step_error"], dj["one_step_error"]) <= 1e-12


def test_knn_shadow_errors_match_jax(runs):
    oj, ot, _, _ = runs
    assert sorted(ot["debug_dict"]["err_store_mdls"]) == [KNN, GP]
    got = ot["debug_dict"]["err_store_mdls"][KNN]
    want = oj["debug_dict"]["err_store_mdls"][KNN]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _rel(a, b) <= 1e-12


def test_nngp_shadow_within_the_jax_control(runs):
    oj, ot, _, oc = runs
    got = ot["debug_dict"]["err_store_mdls"][GP]
    want = oj["debug_dict"]["err_store_mdls"][GP]
    ctl = oc["debug_dict"]["err_store_mdls"][GP]
    for k, (a, b, c) in enumerate(zip(got, want, ctl)):
        assert np.isfinite(a).all()
        gap, ctl_gap = np.abs(a - b).max(), np.abs(c - b).max()
        assert gap <= 10.0 * ctl_gap, (k, gap, ctl_gap)
    # local-GP predictions beat the naive k-NN mean, as in JAX
    errs = ot["debug_dict"]["err_store_mdls"]
    knn_err = np.mean([e.mean() for e in errs[KNN][1:]])
    gp_err = np.mean([e.mean() for e in errs[GP][1:]])
    assert gp_err < knn_err


def test_runs_are_kept_by_name(runs):
    _, ot, pt, _ = runs
    assert pt.runs["para_study"] is ot
    assert ot["mdl"].name == "Parareal"
    out = pt.run(model="parareal", early_stop=1, measure_serial_fine=False)
    assert pt.runs["Parareal"] is out and "mdl" not in out
    assert out["debug_dict"] == {}


def test_shadow_specs_and_names():
    _, pt = fhn_pair()
    mdl = KNNMean(pt.n, pt.N, nn=3)
    out = pt.run(model="parareal", early_stop=1, measure_serial_fine=False,
                 comp_models=["knn_mean", mdl,
                              ("knn_mean", {"nn": 2, "cstm_name": "2-NN"})])
    errs = out["debug_dict"]["err_store_mdls"]
    assert list(errs) == ["knn_mean", "kNN-mean", "2-NN"]
    assert all(len(e) == 1 and e[0].shape == (pt.N - 1, pt.n)
               for e in errs.values())
    # a shadow sets debug, and makes a bare run collect its dataset
    assert out["x"].shape == (pt.N, pt.n)
    with pytest.raises(ValueError, match="Unknown model"):
        pt.run(model="parareal", early_stop=1, comp_models=["vanderpol"])


@pytest.mark.skipif(not RUN_SLOW, reason="the scipy GP on Rossler with "
                    "three nnGP shadows: ~14 minutes on the CPU")
def test_figure2_second_study():
    ode = nt.Rossler(normalization="-11", device="cpu")
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                    G=cfg["G"], F=cfg["F"], device="cpu")
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], epsilon=5e-7,
                    verbose=None, device="cpu")
    shadows = [("nngp", {"nn": nn, "optimizer": "grid",
                         "cstm_name": f"NNGP{nn}"}) for nn in (10, 25, 40)]
    out = p.run(model="gpjax_scipy", comp_models=shadows, debug=True,
                cstm_mdl_name="gp_study", measure_serial_fine=False)
    assert out["converged"] and out["k"] in (12, 13)
    assert p.runs["gp_study"] is out
    main = out["debug_dict"]["all_pred_err"]
    for name, errs in out["debug_dict"]["err_store_mdls"].items():
        assert len(errs) == 12
        for k in (4, 5, 6):
            gap = np.log10(np.nanmean(errs[k])) - np.log10(main[k].mean())
            assert abs(gap) <= 0.5, (name, k, gap)
