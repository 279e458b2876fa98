"""Port parity, end to end: the iteration count K is the acceptance oracle.

* FHN ODE (N=40, RK2/RK4, [-1,1]-normalised): bare Parareal K=11 at
  eps=5e-7 and K=14 at 5e-9, nnGParareal (m=15) K=5 at 5e-7, as
  tests/test_parareal.py:29-50 hold the JAX package (the port has the grid search only; its published K is
  5 too, PARITY.md).
* Burgers d=16, N=16, RK1/RK8 (4 / 200 steps per slice), nnGP grid m=18:
  the port and the JAX package give the same K and the same converged
  prefix per iteration. The iterates agree to 1e-12 through iteration 2
  and to 5e-8 (eps/10) at the end: XLA contracts some a*b+c into FMAs
  under jit, so the two start 1 ulp apart, and the near-singular GP
  interpolants of later iterations amplify that by ~10x per iteration
  (measured: 4e-16, 4e-15, 2e-13, 3e-12, 1e-12, 4e-12, 9e-11, 7e-9 and
  2e-8 over iterations 0-8).
* The control for that drift, with JAX alone: the JAX package run again
  with u0 moved by 4e-16 (random signs) ends 1.8e-8 from its own first
  run, the same order as the port (measured per iteration: 3e-15, 7e-15,
  1e-13, 9e-13, 2e-12, 4e-12, 3e-11, 7e-9, 1.8e-8). The drift is the
  method's conditioning, not the port's: the test holds that explanation
  (the control drifts past 1e-9, and the port stays within 10x of it).
* A checkpoint the JAX package wrote at k=2, resumed in the port, gives
  the JAX resume's K and u (same bounds); one the port wrote resumes to
  the port's own run (rtol 1e-12: the same arithmetic).
"""

import os
import pickle

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import nngparareal_tpu as jt
import nngparareal_torch as nt
from nngparareal_torch.convert import from_jax_checkpoint, load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPS = 5e-7
EARLY = 1e-12  # iterates through iteration 2
FINAL = EPS / 10  # final iterate, after the GP amplification
NUDGE = 4e-16  # the control's move of u0: the gap the packages start with


BURGERS = dict(d_x=16, N=16, Ng=4, Nf=200, T=5.9)
RUN_KW = dict(model="nngp", nn=18, seed=45, optimizer="grid",
              measure_serial_fine=False)


def _burgers_jax(nudge=0.0):
    ode = jt.Burgers(d_x=BURGERS["d_x"], normalization="-11")
    s = jt.RKSolver(ode.get_vector_field(), BURGERS["Ng"], BURGERS["Nf"],
                    G="RK1", F="RK8")
    p = jt.Parareal(ode, s, [0.0, BURGERS["T"]], BURGERS["N"],
                    epsilon=EPS, verbose=None)
    if nudge:
        signs = np.random.default_rng(0).choice([-1.0, 1.0], p.u0.shape)
        p.u0 = p.u0 + nudge * signs
    return p


def _burgers_torch():
    ode = nt.Burgers(d_x=BURGERS["d_x"], normalization="-11", device="cpu")
    s = nt.RKSolver(ode.get_vector_field(), BURGERS["Ng"], BURGERS["Nf"],
                    G="RK1", F="RK8", device_field=ode.get_device_field(),
                    device="cpu")
    return nt.Parareal(ode, s, [0.0, BURGERS["T"]], BURGERS["N"],
                       epsilon=EPS, verbose=None, device="cpu")


def _ckpt(root, p, k):
    name = f"{p.ode_name}_{p.N}_NNGP_int"
    return os.path.join(root, name, f"{name}_{k}")


@pytest.fixture(scope="module")
def burgers_runs(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    tdir = str(tmp_path_factory.mktemp("torch_ckpt"))
    pj = _burgers_jax()
    out_j = pj.run(keep_history=True, store_int=True, int_dir=jdir, **RUN_KW)
    out_j_resumed = _burgers_jax().load_int_dump(
        _ckpt(jdir, pj, 2), **RUN_KW)
    out_c = _burgers_jax(NUDGE).run(keep_history=True, **RUN_KW)
    pt = _burgers_torch()
    out_t = pt.run(keep_history=True, store_int=True, int_dir=tdir, **RUN_KW)
    return dict(jax=out_j, jax_resumed=out_j_resumed, control=out_c,
                torch=out_t,
                jax_ckpt=_ckpt(jdir, pj, 2), torch_ckpt=_ckpt(tdir, pt, 2))


def test_burgers_nngp_matches_jax(burgers_runs):
    oj, ot = burgers_runs["jax"], burgers_runs["torch"]
    assert oj["converged"] and ot["converged"]
    assert ot["k"] == oj["k"]
    assert ot["conv_int"] == oj["conv_int"]
    hj, ht = oj["u_hist"], ot["u_hist"]
    assert hj.shape == ht.shape
    np.testing.assert_allclose(ht[:, :, :3], hj[:, :, :3], rtol=0, atol=EARLY)
    np.testing.assert_allclose(ot["u"], oj["u"], rtol=0, atol=FINAL)
    assert ot["x"].shape == oj["x"].shape


def test_final_drift_is_the_methods_conditioning(burgers_runs):
    """JAX against JAX with u0 moved by 4e-16 drifts as far as the port
    does from JAX: past the 1e-9 first asked of the port, at the same K."""
    oj, ot, oc = (burgers_runs[k] for k in ("jax", "torch", "control"))
    assert oc["k"] == oj["k"] and oc["conv_int"] == oj["conv_int"]
    control = np.abs(oc["u"] - oj["u"]).max()
    port = np.abs(ot["u"] - oj["u"]).max()
    assert control > 1e-9, control
    assert port <= 10 * control, (port, control)


def test_resume_jax_checkpoint_in_port(burgers_runs):
    ref = burgers_runs["jax_resumed"]
    out = _burgers_torch().load_int_dump(burgers_runs["jax_ckpt"], **RUN_KW)
    assert out["converged"] and ref["converged"]
    assert out["k"] == ref["k"] == burgers_runs["jax"]["k"]
    assert out["conv_int"] == ref["conv_int"]
    np.testing.assert_allclose(out["u"], ref["u"], rtol=0, atol=FINAL)


def test_resume_own_checkpoint(burgers_runs):
    full = burgers_runs["torch"]
    out = _burgers_torch().load_int_dump(burgers_runs["torch_ckpt"], **RUN_KW)
    assert out["k"] == full["k"] and out["conv_int"] == full["conv_int"]
    np.testing.assert_allclose(out["u"], full["u"], rtol=1e-12, atol=0)
    # the port writes the JAX package's layout: JAX resumes it too
    p = load_checkpoint(burgers_runs["torch_ckpt"])
    assert set(p) == set(load_checkpoint(burgers_runs["jax_ckpt"]))


def test_converter_refuses_jax_objects(tmp_path):
    good = load_checkpoint(_write(tmp_path / "ok", _payload(np.zeros(3))))
    conv = from_jax_checkpoint(good, device="cpu")
    assert conv["u"].dtype == torch.float64 and conv["k"] == 2
    with pytest.raises(TypeError, match="JAX object"):
        from_jax_checkpoint(_payload(jnp.zeros(3)))
    with pytest.raises(pickle.UnpicklingError, match="JAX object"):
        load_checkpoint(_write(tmp_path / "bad", _payload(jnp.zeros(3))))


def test_converter_takes_the_card_by_default(tmp_path):
    """Like every entry point, the converter puts tensors on the card unless
    asked for the CPU, and raises when there is no card."""
    good = load_checkpoint(_write(tmp_path / "ok", _payload(np.zeros(3))))
    if torch.cuda.is_available():
        assert from_jax_checkpoint(good)["u"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_jax_checkpoint(good)


def _payload(u):
    z = np.zeros((4, 3))
    return {"k": 2, "I": 1, "u": u, "uG": z, "uF": z, "ds_X": z, "ds_D": z,
            "ds_valid": np.zeros(4), "model_state": {"time_k": 2}}


def _write(path, payload):
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)
    return path
