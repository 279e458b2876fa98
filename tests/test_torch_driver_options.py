"""Port parity for the options of the driver's loop and ``PararealLight``,
against the JAX package on the CPU.

The runs use FHN cut to its first 16 slices with Nf // 10 (``cut``), bare
Parareal or the nnGP with the grid search.

``lag_k`` and ``cap_iters`` are held in tests/test_torch_driver_lag_k.py.

* ``clip_iterates=False`` computes no bounds (one coarse chain, not two)
  and matches JAX's unclipped run; ``int_name`` names the checkpoints'
  directory and files as JAX does; a run's ``verbose=None`` prints
  nothing (JAX's run() still prints its elapsed time by the instance's
  verbose, the loop nothing).
* The ``timings`` keys equal JAX's (bare Parareal, and the nnGP without
  ``calc_detail_avg``, where both estimate the per-interval time and
  say so in ``timing_detail_note``). The values of ``sweep_mode`` and
  ``sync_mode`` are the port's own: it records the one sweep it has,
  "host", and "fast" only where it dropped the fan-out's wait
  (driver.py's docstring).
* Every ``sweep_mode`` and ``sync_mode`` gives the default run's iterates
  bitwise; ``host_cpu`` and unknown modes raise with a reason.
* ``mesh=`` (3 blocks on the CPU, so every fan-out is padded at some
  iteration) gives the default run's iterates, and with ``debug`` its
  truth errors, bitwise.
* ``calc_detail_avg``: a (K, N) record, positive on exactly the intervals
  each sweep predicted, as JAX's host sweep records them.
* ``PararealLight`` gives Parareal's run bitwise and JAX's K, keeps no
  history, and refuses ``store_int`` and ``load_int_dump``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import nngparareal_tpu as jt
from nngparareal_tpu.driver import PararealLight as JLight

import nngparareal_torch as nt

from test_torch_knn_elm import _one_torch_thread, cut, fhn_pair  # noqa: F401

GRID = dict(model="nngp", nn=15, optimizer="grid", measure_serial_fine=False)
BARE = dict(model="parareal", measure_serial_fine=False)
CUT = cut(10, 16)


def _count_chains(p):
    """Count the calls of the solver's coarse chain."""
    calls = []
    chain = p.solver.run_G_chain

    def counted(*a, **kw):
        calls.append(1)
        return chain(*a, **kw)

    p.solver.run_G_chain = counted
    return calls


def test_clip_iterates_false():
    pj, pt = fhn_pair(edit=CUT)
    calls = _count_chains(pt)
    oj = pj.run(**BARE, clip_iterates=False)
    ot = pt.run(**BARE, clip_iterates=False)
    assert len(calls) == 1
    assert ot["k"] == oj["k"] and ot["conv_int"] == oj["conv_int"]
    np.testing.assert_allclose(ot["u"], oj["u"], rtol=0,
                               atol=1e-12 * np.abs(oj["u"]).max())
    pt.run(**BARE, early_stop=1)
    assert len(calls) == 3


@pytest.mark.parametrize("int_name", [None, "fhn_run"])
def test_int_name_file_names(tmp_path, int_name):
    pj, pt = fhn_pair(edit=CUT)
    names = []
    for p, sub in ((pj, "jax"), (pt, "port")):
        d = tmp_path / sub
        p.run(**BARE, store_int=True, early_stop=2, int_dir=str(d),
              int_name=int_name)
        names.append(sorted((os.path.relpath(os.path.join(root, f), d))
                            for root, _, fs in os.walk(d) for f in fs))
    assert names[0] == names[1]
    base = int_name or "FHN_ODE_16_Parareal_int"
    assert names[1] == [os.path.join(base, f"{base}_{k}") for k in (0, 1)]


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_run_verbose():
    pj, pt = fhn_pair(edit=CUT)
    pj.verbose = pt.verbose = "v"
    assert _printed(lambda: pt.run(**BARE, early_stop=2, verbose=None)) == []
    jax_lines = _printed(lambda: pj.run(**BARE, early_stop=2, verbose=None))
    assert [ln.split(":")[0] for ln in jax_lines] == ["Elapsed Parareal time"]
    # and the other way round: the loop's lines, as JAX prints them
    pj.verbose = pt.verbose = None
    want = _printed(lambda: pj.run(**BARE, early_stop=2, verbose="v"))
    got = _printed(lambda: pt.run(**BARE, early_stop=2, verbose="v"))
    assert [ln for ln in got if not ln.startswith("Elapsed")] == want
    assert len(want) == 5


@pytest.fixture(scope="module")
def cut_runs():
    """The cut FHN, bare and nnGP grid, two iterations, in both packages;
    the port's nnGP also with calc_detail_avg, and JAX's with it on its
    host sweep."""
    pj, pt = fhn_pair(edit=CUT)
    out = {}
    for name, kw in (("parareal", BARE), ("nngp", GRID)):
        out[name] = (pj.run(**kw, early_stop=2), pt.run(**kw, early_stop=2))
    out["detail"] = (
        pj.run(**GRID, early_stop=2, calc_detail_avg=True, sweep_mode="host"),
        pt.run(**GRID, early_stop=2, calc_detail_avg=True))
    out["port"] = pt
    return out


@pytest.mark.parametrize("model", ["parareal", "nngp"])
def test_timings_keys_match_jax(cut_runs, model):
    oj, ot = cut_runs[model]
    assert set(ot["timings"]) == set(oj["timings"])
    assert ot["timings"]["sweep_mode"] == "host"
    assert ot["timings"]["sync_mode"] == "attrib"
    if model == "nngp":
        assert ot["timings"]["calc_detail_avg"] is None
        assert "estimate" in ot["timings"]["timing_detail_note"]


def test_calc_detail_avg(cut_runs):
    """JAX's warm-up sweep runs from interval 0 and records its walls into
    row 0 too: interval 0 of row 0 is set there and never predicted."""
    oj, ot = cut_runs["detail"]
    dj = oj["timings"]["calc_detail_avg"]
    dt = ot["timings"]["calc_detail_avg"]
    assert dt.shape == dj.shape == (2, 16)
    np.testing.assert_array_equal(dt[:, 1:] > 0, dj[:, 1:] > 0)
    np.testing.assert_array_equal(dt[1] > 0, dj[1] > 0)
    # each sweep predicts the intervals from its freeze point on
    starts = [1, ot["conv_int"][0] + 1]
    for k, I in enumerate(starts):
        assert (dt[k, I:] > 0).all() and not dt[k, :I].any()
    assert "timing_detail_note" not in ot["timings"]
    assert ot["timings"]["avg_serial_train_time"] > 0.0
    np.testing.assert_array_equal(ot["u"], cut_runs["nngp"][1]["u"])


@pytest.mark.parametrize("kw", [
    dict(sweep_mode="auto"), dict(sweep_mode="scan"), dict(sweep_mode="host"),
    dict(sweep_mode="python"), dict(sync_mode="fast"),
    dict(sync_mode="fast", debug=True), dict(warmup=False),
], ids=["auto", "scan", "host", "python", "fast", "fast-debug", "no-warmup"])
def test_modes_change_no_value(cut_runs, kw):
    pt = cut_runs["port"]
    ot = pt.run(**GRID, early_stop=2, **kw)
    np.testing.assert_array_equal(ot["u"], cut_runs["nngp"][1]["u"])
    tm = ot["timings"]
    assert tm["sweep_mode"] == "host"
    fast = kw.get("sync_mode") == "fast" and not kw.get("debug")
    assert tm["sync_mode"] == ("fast" if fast else "attrib")
    assert (tm["fused_iter_t"] > 0.0) == fast
    assert (tm["sweep_time"] > 0.0) != fast


@pytest.mark.parametrize("kw,exc,match", [
    (dict(sweep_mode="host_cpu"), ValueError, "IEEE"),
    (dict(sweep_mode="lanes"), ValueError, "sweep_mode"),
    (dict(sync_mode="never"), ValueError, "sync_mode"),
], ids=["host_cpu", "unknown-sweep", "unknown-sync"])
def test_refusals(kw, exc, match):
    _, pt = fhn_pair(edit=CUT)
    with pytest.raises(exc, match=match):
        pt.run(**BARE, **kw)
    assert pt.runs == {}


def test_mesh_gives_the_default_run():
    """The fine fan-out over 3 blocks on the CPU (16 slices: padded by 2,
    then by every shortfall as slices converge), and the debug truth
    through the same mesh: the iterates and the truth errors bitwise the
    unsharded run's."""
    _, pt = fhn_pair(edit=CUT)
    mesh = nt.make_mesh(devices=["cpu"] * 3)
    one = pt.run(**BARE, debug=True)
    sharded = pt.run(**BARE, debug=True, mesh=mesh)
    assert (sharded["k"], sharded["conv_int"]) == (one["k"], one["conv_int"])
    np.testing.assert_array_equal(sharded["u"], one["u"])
    for a, b in zip(sharded["debug_dict"]["all_pred_err"],
                    one["debug_dict"]["all_pred_err"]):
        np.testing.assert_array_equal(a, b)


def test_parareal_light(tmp_path):
    ode = nt.FHNODE(normalization="-11", device="cpu")
    _, pt = fhn_pair(edit=CUT)
    light = nt.PararealLight(ode, pt.solver, pt.tspan, pt.N, verbose=None,
                             device="cpu")
    ol = light.run(**BARE, keep_history=True)
    op = pt.run(**BARE)
    np.testing.assert_array_equal(ol["u"], op["u"])
    assert ol["conv_int"] == op["conv_int"] and "u_hist" not in ol
    oj = JLight(jt.FHNODE(normalization="-11"), fhn_pair(edit=CUT)[0].solver,
                pt.tspan, pt.N, verbose=None).run(**BARE)
    assert (ol["k"], ol["conv_int"]) == (oj["k"], oj["conv_int"])
    with pytest.raises(NotImplementedError, match="storing"):
        light.run(**BARE, store_int=True, int_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="loading"):
        light.load_int_dump(str(tmp_path / "none"))
