"""Port parity for the FHN-PDE slice: system, config, fan-out, driver.

The same numpy inputs (seeded ``np.random.default_rng``) go through the
JAX package (on the CPU, f64) and nngparareal_torch (``device="cpu"``):

* ``FHNPDE`` at dx in {4, 6}: u0 bitwise equal (the legacy-seeded draw),
  the field within rtol 1e-14 on random states (the same arithmetic; a few
  ulp of slack for XLA's op fusion), ``dense_laplacian`` equal, and the
  ``Config`` dicts of dx in {10, 12, 14, 16} equal. The port's fused
  normalised field is bitwise the generic normalisation wrapper.
* The plain RK8 fan-out (dx=4, B=8, 50 steps) against the JAX f64 fan-out
  within rtol 1e-13 (XLA contracts some a*b+c into FMAs under jit), and
  its ``thresh`` paging bitwise equal to one page.
* The kernel's wrapper takes the plain version for CPU tensors (atol 0),
  and ``get_device_field`` carries the constants of the instance.
* ``run_fhn_pde`` builds the JAX package's run (fine steps, paging,
  coarse, tspan, N, eps, model keywords) at dx in {10, 16}.
* End to end at dx=4 (d=32), N=16 over [0, 4.6875] (16 slices of dx=10's
  width), RK2 x3 / RK8 x100 per slice, nnGP nn=20 with the grid search,
  eps=5e-7: the same K (5) and converged prefix per iteration, the coarse
  initialisation (iteration 0) within 1e-12 and the end within eps/10.
  In between, the first corrector sweep fits its local GPs to the 16
  rows of one iteration with m=20, and its grid search is so close to a
  tie there that the JAX package run against itself, with u0 moved by
  4e-16 (the gap the two packages start with), differs by ~2e-3 after
  iteration 1. So iterations 1 onwards are held to that control: the
  port's gap from the JAX run stays within 10x the JAX package's own gap
  under the perturbation (measured ratios 0.4-0.95). A checkpoint the
  JAX package wrote at k=2 resumes in the port to the same K.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu import experiments as jexp
from nngparareal_tpu.ops import rk as jrk
from nngparareal_tpu.systems import configs as jconfigs

import nngparareal_torch as nt
from nngparareal_torch import experiments as texp
from nngparareal_torch.ops import rk as trk
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.ops.rk_cuda import FhnPdeField


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-14
EPS = 5e-7
EARLY = 1e-12  # the coarse initialisation
FINAL = EPS / 10  # final iterate, after the GP amplification
NUDGE = 4e-16  # the control's move of u0


def _pair(d_x, norm="-11"):
    return (jt.FHNPDE(d_x=d_x, normalization=norm),
            nt.FHNPDE(d_x=d_x, normalization=norm, device="cpu"))


def _states(B, d, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (B, d))


@pytest.mark.parametrize("d_x", [4, 6])
@pytest.mark.parametrize("norm", ["-11", None])
def test_fhnpde_matches_jax(d_x, norm):
    oj, ot = _pair(d_x, norm)
    assert ot.name == oj.name and ot.get_dim() == oj.get_dim() == 2 * d_x ** 2
    np.testing.assert_array_equal(ot.get_init_cond().numpy(),
                                  oj.get_init_cond())
    np.testing.assert_array_equal(ot.dense_laplacian(), oj.dense_laplacian())
    U = _states(7, ot.get_dim())
    fj = jax.jit(jax.vmap(lambda u: oj.get_vector_field()(0.0, u)))
    want = np.asarray(fj(jnp.asarray(U)))
    got = ot.get_vector_field()(0.0, torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # one state (d,) and a batch (B, d) go through the same field
    one = ot.get_vector_field()(0.0, torch.as_tensor(U[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_fused_normalised_field_is_the_generic_wrapper():
    """``FHNPDE._f_norm11`` against ``ODE.get_vector_field``'s generic
    wrapper raw((u + 1) / 2 * (mx - mn) + mn) * scale: bitwise equal."""
    _, ot = _pair(6)
    U = torch.as_tensor(_states(5, 72, seed=3))
    mn, mx = (torch.as_tensor(x) for x in (ot.normalizer.mn,
                                           ot.normalizer.mx))
    scale = torch.as_tensor(ot.normalizer.get_scale())
    want = ot._f(0.0, (U + 1.0) / 2.0 * (mx - mn) + mn) * scale
    f = ot.get_vector_field()
    assert f == ot._f_norm11
    torch.testing.assert_close(f(0.0, U), want, rtol=0, atol=0)


def test_stencil_is_the_dense_laplacian():
    _, ot = _pair(6)
    g = _states(3, 36, seed=2)
    got = ot._lap_stencil(torch.as_tensor(g).reshape(3, 6, 6)).reshape(3, 36)
    np.testing.assert_allclose(got.numpy(), g @ ot.dense_laplacian().T,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d_x", [10, 12, 14, 16, None])
def test_fhn_pde_configs_match_jax(d_x):
    oj, ot = _pair(d_x or 4)
    cj = jconfigs.Config(oj, d_x=d_x).get()
    ct = nt.Config(ot, d_x=d_x).get()
    assert ct == cj


def test_plain_fanout_matches_jax_f64():
    oj, ot = _pair(4)
    rng = np.random.default_rng(3)
    U = oj.get_init_cond()[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (8, 32))
    t0 = rng.uniform(0.0, 1.0, 8)
    t1 = t0 + 150.0 / 512
    want = np.asarray(jrk.make_batched_last_integrator(
        oj.get_vector_field(), "RK8", 50)(jnp.asarray(t0), jnp.asarray(t1),
                                          jnp.asarray(U)))
    args = (torch.as_tensor(t0), torch.as_tensor(t1), torch.as_tensor(U))
    got = trk.make_batched_last_integrator(ot.get_vector_field(), "RK8",
                                           50)(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    # thresh paging (7 pages of 7 steps + 1) changes no value
    paged = trk.make_batched_last_integrator(ot.get_vector_field(), "RK8",
                                             50, thresh=7)(*args)
    torch.testing.assert_close(paged, got, rtol=0, atol=0)


def test_kernel_wrapper_and_device_field():
    oj, ot = _pair(4)
    fld = ot.get_device_field()
    assert fld == FhnPdeField(d_x=4, d_y=4, inv_hx2=1.0 / oj._hx2,
                              inv_hy2=1.0 / oj._hy2, a=2.8e-4, b=5e-3,
                              k=-5e-3, inv_tau=1.0 / 0.1)
    assert fld.grid(32) == (4, 4)
    with pytest.raises(ValueError, match="d=32"):
        fld.grid(16)
    # the kernel knows only the normalised form
    assert nt.FHNPDE(d_x=4, device="cpu").get_device_field() is None

    rng = np.random.default_rng(4)
    U = torch.as_tensor(rng.uniform(-1.0, 1.0, (5, 32)))
    t0 = torch.as_tensor(rng.uniform(0.0, 1.0, 5))
    t1 = t0 + 0.3
    f = ot.get_vector_field()
    before = dict(rk_cuda.rk_fanout.launches_by_field)
    got = rk_cuda.rk_fanout(t0, t1, U, "RK8", 20, fld, f)
    want = trk.make_batched_last_integrator(f, "RK8", 20)(t0, t1, U)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rk_cuda.rk_fanout.launches_by_field == before  # no kernel ran

    # on a card, fine='auto' takes the kernel for FHN-PDE (nothing runs
    # here: the solver only stores the choice)
    s = nt.RKSolver(f, 25, 100, G="RK4", F="RK8", device_field=fld,
                    device="cuda:0")
    assert s.fine == "cuda"
    s = nt.RKSolver(f, 25, 100, G="RK4", F="RK8", device_field=fld,
                    device="cpu")
    assert s.fine == "torch"


@pytest.mark.parametrize("d_x", [10, 16])
def test_run_fhn_pde_builds_the_jax_run(d_x, monkeypatch):
    """Both drivers stop at ``_run_models``; the runs they built agree."""
    seen = {}

    def capture(name):
        def stub(p, model_kwargs, models, results_dir, tag, nngp_kw=None,
                 **common):
            seen[name] = dict(p=p, model_kwargs=model_kwargs, models=models,
                              tag=tag, nngp_kw=nngp_kw, common=common)
            return []
        return stub

    monkeypatch.setattr(jexp, "_run_models", capture("jax"))
    monkeypatch.setattr(texp, "_run_models", capture("torch"))
    kw = dict(models=("nngp",), results_dir=None,
              nngp_kw=dict(optimizer="grid"))
    jexp.run_fhn_pde(d_x, **kw)
    texp.run_fhn_pde(d_x, device="cpu", **kw)
    j, t = seen["jax"], seen["torch"]
    pj, pt = j.pop("p"), t.pop("p")
    assert t == j
    sj, st = pj.solver, pt.solver
    Ng_tot = sj.Ng * pj.N
    assert st.Nf == sj.Nf == int(np.ceil(1e8 / Ng_tot) * Ng_tot) // pj.N
    assert (st.Ng, st.thresh, st.G.name, st.F.name) == (
        sj.Ng, sj.thresh, sj.G.name, sj.F.name)
    assert (pt.tspan, pt.N, pt.epsilon) == (pj.tspan, pj.N, pj.epsilon)
    np.testing.assert_array_equal(pt.u0.numpy(), pj.u0)
    assert isinstance(st.device_field, FhnPdeField)


class _StubParareal:
    N = 4

    def __init__(self):
        self.calls = []

    def run(self, model, **kw):
        self.calls.append((model, kw))
        return {"k": 3, "converged": True, "conv_int": [1, 2, 4],
                "err": np.zeros((5, 3)),
                "timings": {"runtime": 2.0, "F_time": 0.5, "G_time": 0.25,
                            "mdl_tot_t": 1.0, "F_time_serial_avg": 1.5}}


def test_run_models_rows_and_refusals(tmp_path):
    mk = {"nngp": dict(nn=20)}
    rows = texp._run_models(_StubParareal(), mk, ("parareal", "nngp"),
                            str(tmp_path), "tag",
                            nngp_kw=dict(optimizer="grid"), store_int=True)
    want = jexp._run_models(_StubParareal(), mk, ("parareal", "nngp"), None,
                            "tag", nngp_kw=dict(optimizer="grid"),
                            store_int=True)
    assert len(rows) == len(want) == 2
    for r, w in zip(rows, want):
        assert r.keys() == w.keys()
        for key in r:
            np.testing.assert_equal(r[key], w[key])
    from nngparareal_torch.convert import load_checkpoint

    stored = load_checkpoint(os.path.join(tmp_path, "tag.pkl"))
    assert [r["name"] for r in stored] == ["parareal", "nngp"]
    # MODELS_DEFAULT runs every model, GParareal (gpjax) among them, with
    # the keywords the JAX package passes each
    p, pj = _StubParareal(), _StubParareal()
    rows = texp._run_models(p, mk, texp.MODELS_DEFAULT, None, "tag")
    jexp._run_models(pj, mk, jexp.MODELS_DEFAULT, None, "tag")
    assert [m for m, _ in p.calls] == ["parareal", "gpjax", "nngp"]
    assert p.calls == pj.calls
    assert [r["name"] for r in rows] == list(texp.MODELS_DEFAULT)


SMALL = dict(d_x=4, N=16, T=4.6875, Ng=3, Nf=100, G="RK2", F="RK8")
RUN_KW = dict(model="nngp", nn=20, seed=45, optimizer="grid",
              measure_serial_fine=False)


def _small_jax(nudge=0.0):
    ode = jt.FHNPDE(d_x=SMALL["d_x"], normalization="-11")
    s = jt.RKSolver(ode.get_vector_field(), SMALL["Ng"], SMALL["Nf"],
                    G=SMALL["G"], F=SMALL["F"])
    p = jt.Parareal(ode, s, [0.0, SMALL["T"]], SMALL["N"], epsilon=EPS,
                    verbose=None)
    if nudge:
        signs = np.random.default_rng(0).choice([-1.0, 1.0], p.u0.shape)
        p.u0 = p.u0 + nudge * signs
    return p


def _small_torch():
    ode = nt.FHNPDE(d_x=SMALL["d_x"], normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), SMALL["Ng"], SMALL["Nf"],
                    G=SMALL["G"], F=SMALL["F"],
                    device_field=ode.get_device_field(), device="cpu")
    return nt.Parareal(ode, s, [0.0, SMALL["T"]], SMALL["N"], epsilon=EPS,
                       verbose=None, device="cpu")


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    pj = _small_jax()
    out_j = pj.run(keep_history=True, store_int=True, int_dir=jdir, **RUN_KW)
    out_c = _small_jax(NUDGE).run(keep_history=True, **RUN_KW)
    out_t = _small_torch().run(keep_history=True, **RUN_KW)
    name = f"{pj.ode_name}_{pj.N}_NNGP_int"
    return dict(jax=out_j, control=out_c, torch=out_t,
                jax_ckpt=os.path.join(jdir, name, f"{name}_2"))


def test_small_fhn_pde_nngp_matches_jax(small_runs):
    oj, ot, oc = small_runs["jax"], small_runs["torch"], small_runs["control"]
    assert oj["converged"] and ot["converged"] and oc["converged"]
    assert ot["k"] == oj["k"] == oc["k"] == 5
    assert ot["conv_int"] == oj["conv_int"] == oc["conv_int"]
    hj, ht, hc = oj["u_hist"], ot["u_hist"], oc["u_hist"]
    assert hj.shape == ht.shape == hc.shape
    np.testing.assert_allclose(ht[:, :, 0], hj[:, :, 0], rtol=0, atol=EARLY)
    np.testing.assert_allclose(ot["u"], oj["u"], rtol=0, atol=FINAL)
    # per-iteration gaps: the port from JAX, and JAX from itself under the
    # 4e-16 move of u0
    port = np.abs(ht - hj).max(axis=(0, 1))
    control = np.abs(hc - hj).max(axis=(0, 1))
    assert control[1] > 1e-6  # no bound near 1e-12 holds after a sweep
    assert np.all(port[1:] <= 10 * control[1:]), (port, control)
    # the experiment drivers' summary of the two runs
    sj = jexp._summarize("nngp", oj, SMALL["N"])
    st = texp._summarize("nngp", ot, SMALL["N"])
    assert st.keys() == sj.keys()
    assert (st["k"], st["converged"], st["conv_int"]) == (
        sj["k"], sj["converged"], sj["conv_int"])


def test_resume_jax_fhn_pde_checkpoint_in_port(small_runs):
    full = small_runs["jax"]
    out = _small_torch().load_int_dump(small_runs["jax_ckpt"], **RUN_KW)
    assert out["converged"]
    assert out["k"] == full["k"]
    assert out["conv_int"] == full["conv_int"]
    np.testing.assert_allclose(out["u"], full["u"], rtol=0, atol=FINAL)
