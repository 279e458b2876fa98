"""Port parity for the reporting layer (reporting.py), the io and timing
helpers (utils/io.py, utils/timing.py) and ``Parareal.store``, against the
JAX package on the CPU.

* The cost calculators, ``est_serial``, ``calc_speedup`` and
  ``conv_intervals_per_iter`` give JAX's values on the same run dicts.
* ``print_times`` and ``print_speedup`` (Markdown and LaTeX) print JAX's
  strings, character for character, for two ``Parareal`` objects given the
  same run dicts and ``fine_t``.
* The plots render under Agg; ``store_fig`` writes png and pdf.
* The Figure-1 mechanics data (a toy 1-D ODE, bare Parareal with history
  and every slice's fine trajectory) lies within 1e-12 of JAX's; the
  animation writes a GIF.
* ``store(slim=True)`` writes JAX's payload keys, read back with
  ``read_pickle``; ``slim_run``, ``print_cond`` (a tensor or an array)
  and ``Timer`` behave as JAX's.
"""

import contextlib
import io
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from nngparareal_tpu import reporting as jrep  # noqa: E402
from nngparareal_tpu import utils as jutils  # noqa: E402

from nngparareal_torch import reporting as trep  # noqa: E402
from nngparareal_torch import utils as tutils  # noqa: E402

from test_torch_knn_elm import _one_torch_thread, cut, fhn_pair  # noqa: E402,F401

GRID = dict(model="nngp", nn=15, optimizer="grid")


@pytest.fixture(scope="module")
def pair():
    """The port's cut FHN with a bare run (debug, for plot_all_err) and an
    nnGP run named "NNGP"; JAX's Parareal handed the same run dicts and
    the same fine solve."""
    pj, pt = fhn_pair(edit=cut(10, 16))
    pt.run(model="parareal", debug=True)
    pt.run(**GRID, cstm_mdl_name="NNGP")
    pj.runs = pt.runs
    pj.fine, pj.fine_t = pt.fine, pt.fine_t = np.zeros(2), 0.123456
    return pj, pt


CALCULATORS = {
    "est_serial": lambda m, run, n: m.est_serial(run, 16),
    "get_act_cost": lambda m, run, n: m.get_act_cost(run),
    "get_act_mdl_cost": lambda m, run, n: m.get_act_mdl_cost(run),
    "calc_speedup": lambda m, run, n: m.calc_speedup(run, N=16),
    "calc_speedup_serial": lambda m, run, n: m.calc_speedup(run, serial=3.0),
    "calc_exp_gp_cost": lambda m, run, n: m.calc_exp_gp_cost(run, 47, n),
    "calc_exp_nngp_cost_rough": lambda m, run, n: m.calc_exp_nngp_cost_rough(
        run, 47, 16, n, n_restarts=2),
    "calc_exp_nngp_cost_precise": lambda m, run, n:
        m.calc_exp_nngp_cost_precise(run, 47, 16, n),
    "calc_exp_speedup": lambda m, run, n: m.calc_exp_speedup(
        run, m.calc_exp_nngp_cost_precise, N=16, n_cores=47, d=n),
}


@pytest.mark.parametrize("name", list(CALCULATORS))
@pytest.mark.parametrize("key", ["Parareal", "NNGP"])
def test_calculators_match_jax(pair, name, key):
    pj, pt = pair
    run = pt.runs[key]
    want = CALCULATORS[name](jrep, run, pt.n)
    assert np.isfinite(want)
    assert CALCULATORS[name](trep, run, pt.n) == want


@pytest.mark.parametrize("key", ["Parareal", "NNGP"])
def test_conv_intervals_per_iter_matches_jax(pair, key):
    run = pair[1].runs[key]
    want = jrep.conv_intervals_per_iter(run["err"], 5e-7)
    got = trep.conv_intervals_per_iter(run["err"], 5e-7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(np.nansum(got[0])) == 16


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


TABLES = {
    "print_times": lambda p: p.print_times(),
    "print_times_mdl": lambda p: p.print_times(mdl_speedup="Parareal"),
    "print_speedup_md": lambda p: p.print_speedup(),
    "print_speedup_latex": lambda p: p.print_speedup(
        md=False, mdl_title="FHN", mdls={"Parareal": "Parareal",
                                         "NNGP": "NNGP"}),
    "print_speedup_F_t": lambda p: p.print_speedup(F_t=0.01),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_match_jax(pair, name):
    pj, pt = pair
    want, want_out = _printed(lambda: TABLES[name](pj))
    got, got_out = _printed(lambda: TABLES[name](pt))
    assert got == want and got_out == want_out
    assert "NNGP" in got or "NN-GParareal" in got


def test_print_times_measures_the_fine_solve(pair):
    """With no fine solve known, print_times runs one: Nf steps over the
    whole span (the JAX package's quirk, kept)."""
    pt = pair[1]
    _, p = fhn_pair(edit=cut(10, 16))
    p.runs = pt.runs
    _printed(p.print_times)
    assert p.fine_t > 0.0
    np.testing.assert_array_equal(
        p.fine, p.solver.run_F(p.tspan[0], p.tspan[-1], p.u0).numpy())


def test_plots_render(pair, tmp_path):
    import matplotlib.pyplot as plt

    pt = pair[1]
    figs = pt.plot()
    assert len(figs) == 2
    assert len(trep.plot_run(pt, skip=(2,))) == 1
    assert trep.plot_dataset_geometry(pt.runs["NNGP"]) is not None
    assert trep.plot_dataset_geometry(pt.runs["Parareal"]) is None
    err_figs = pt.plot_all_err("Parareal")
    assert len(err_figs) == len(
        pt.runs["Parareal"]["debug_dict"]["all_pred_err"]) > 0
    assert pt.plot_all_err("NNGP") is None
    tutils.store_fig(figs[0], "test_fig", img_dir=str(tmp_path))
    assert (tmp_path / "test_fig.png").stat().st_size > 0
    assert (tmp_path / "test_fig.pdf").stat().st_size > 0
    plt.close("all")


def test_mechanics_data_matches_jax():
    want = jrep._mechanics_data(2, 6)
    got = trep._mechanics_data(2, 6, device="cpu")
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    assert len(got[4]) == len(want[4]) == 2
    for segs_g, segs_w in zip(got[4], want[4]):
        for (ts_g, tr_g), (ts_w, tr_w) in zip(segs_g, segs_w):
            np.testing.assert_array_equal(ts_g, ts_w)
            np.testing.assert_allclose(tr_g, tr_w, rtol=1e-12, atol=0)


def test_mechanics_figure_and_animation(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    monkeypatch.chdir(tmp_path)
    fig = trep.plot_parareal_mechanics(n_iters=2, N=4, path="mech",
                                       device="cpu")
    assert len(fig.axes) == 2
    assert (tmp_path / "img" / "mech.png").exists()
    out = trep.animate_parareal_mechanics("mech_anim", n_iters=1, N=4,
                                          device="cpu")
    assert out == os.path.join("img", "mech_anim.gif")
    assert os.path.getsize(out) > 1000
    plt.close("all")


@pytest.mark.parametrize("call", [
    lambda: trep._mechanics_data(2, 6),
    lambda: trep.plot_parareal_mechanics(n_iters=2, N=4),
    lambda: trep.animate_parareal_mechanics("never", n_iters=1, N=4),
], ids=["data", "plot", "animate"])
def test_mechanics_run_on_the_card_by_default(call, monkeypatch, tmp_path):
    """Fault 6: the mechanics helpers are entry points like the others.
    Given no device they take the card, and with none they raise rather
    than drop to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not (tmp_path / "img").exists()


def test_dataset_empty_runs_on_the_card_by_default(monkeypatch):
    """Fault 7: ``Dataset.empty`` given no device takes the card, as the
    entry points do, and with none it raises rather than build on the
    CPU."""
    from nngparareal_torch.models.base import Dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dataset.empty(8, 2)
    ds = Dataset.empty(8, 2, device="cpu")
    assert ds.X.device.type == ds.D.device.type == "cpu"
    assert tuple(ds.valid.shape) == (8,)


def test_store_payload_matches_jax(pair, tmp_path):
    pj, pt = pair
    want = pj.store("jax.pkl", path=str(tmp_path), slim=True)
    got = pt.store("port.pkl", path=str(tmp_path), slim=True)
    back = tutils.read_pickle("port.pkl", path=str(tmp_path))
    assert set(back) == set(got) == set(want)
    assert {k: back[k] for k in ("ode_name", "tspan", "N", "epsilon", "n",
                                 "fine_t")} == {
        k: want[k] for k in ("ode_name", "tspan", "N", "epsilon", "n",
                             "fine_t")}
    assert set(back["runs"]) == {"Parareal", "NNGP"}
    for name, run in back["runs"].items():
        assert set(run) == set(jutils.slim_run(pt.runs[name]))
        assert "x" not in run and "u" not in run
        assert run["k"] == pt.runs[name]["k"]
        assert isinstance(run["err"], np.ndarray)
    full = tutils.read_pickle("port.pkl", path=str(tmp_path))
    assert full["runs"]["NNGP"]["conv_int"] == pt.runs["NNGP"]["conv_int"]
    pt.store("full.pkl", path=str(tmp_path))
    np.testing.assert_array_equal(
        tutils.read_pickle("full.pkl", str(tmp_path))["runs"]["NNGP"]["u"],
        pt.runs["NNGP"]["u"])


def test_clear_plot_obj():
    _, pt = fhn_pair(edit=cut(10, 16))
    pt.runs["a"] = {}
    pt.clear_plot_obj()
    assert pt.runs == {}


def test_slim_run_matches_jax():
    run = {"u": 1, "u_hist": 2, "x": 3, "D": 4, "err": 5, "k": 6}
    assert tutils.slim_run(run) == jutils.slim_run(run) == {"err": 5, "k": 6}
    assert tutils.slim_run(run, drop=("k",)) == jutils.slim_run(
        run, drop=("k",))


@pytest.mark.parametrize("jitted", [False, True])
def test_print_cond_matches_jax(jitted):
    A = np.random.default_rng(0).standard_normal((6, 6))
    K = A @ A.T + 1e-3 * np.eye(6)
    _, want = _printed(lambda: jutils.print_cond(jnp.asarray(K), jitted))
    for arg in (K, torch.as_tensor(K)):
        _, got = _printed(lambda: tutils.print_cond(arg, jitted))
        assert got == want


def test_timer():
    t = tutils.Timer()
    assert t.time("a", lambda x: x + 1, torch.ones(3)).tolist() == [2.0] * 3
    t.time("a", lambda: None)
    t.add("b", 0.5)
    assert t.get("a") > 0.0 and t.get("b") == 0.5 and t.get("c") == 0.0
    assert set(t.totals) == {"a", "b"}
    j = jutils.Timer()
    assert [m for m in dir(t) if not m.startswith("_")] == [
        m for m in dir(j) if not m.startswith("_")]


def test_public_names_match_jax():
    """Every public function of the JAX package's reporting and utils has
    its namesake here."""
    def public(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and not n.startswith("_")
                and getattr(v, "__module__", "").startswith(mod.__name__)}

    assert public(jrep) <= set(dir(trep))
    assert set(jutils.__all__) == set(tutils.__all__)
