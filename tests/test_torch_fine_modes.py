"""The solver's fine modes (``RKSolver(fine=...)``) on the CPU: the JAX
package's tests/test_fine_auto.py and test_rk_pallas.py cases in the
port, and the 'pallas' mode against the JAX package's Pallas kernel in
interpret mode.

JAX's Pallas interpreter runs inside a jitted program, where XLA on the
CPU rewrites compensated arithmetic (``ds32.backend_preserves_ds()`` is
False here), so the port's 'pallas' mode (on CPU tensors the kernel's
plain version) is held to it within that program's own error, not
bitwise (``test_pallas_mode_matches_the_pallas_kernel``); the bitwise
oracles of ds values are the eager ones in tests/test_torch_ds32.py,
test_torch_ds_lift.py and test_torch_rk_ds.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops.rk_pallas import make_pallas_fanout_ds

import nngparareal_torch as nt
from nngparareal_torch.solver import FINE_MODES, RKSolver, select_fine_mode


def _solver(ode, fine, **kw):
    args = dict(Ng=4, Nf=32, G="RK1", F="RK4", device="cpu",
                fine_ds=ode.get_ds_vector_field(),
                device_field=ode.get_device_field())
    args.update(kw)
    return RKSolver(ode.get_vector_field(), fine=fine, **args)


def _batch(ode, B=4):
    t0s = torch.linspace(0.0, 0.4, B + 1, dtype=torch.float64)[:-1]
    U = ode.get_init_cond().expand(B, -1).contiguous()
    return t0s, t0s + 0.1, U


def test_auto_never_picks_double_single():
    """'auto' is f64: the plain integrator on the CPU, the f64 kernel on a
    card, with or without a ds field (Hopper has f64 units)."""
    assert select_fine_mode("cpu", True) == "torch"
    assert select_fine_mode(torch.device("cuda"), True) == "cuda"
    with pytest.raises(NotImplementedError, match="fine='torch'"):
        select_fine_mode(torch.device("cuda"), False)
    assert set(FINE_MODES) == {"auto", "f64", "ds", "pallas", "cuda",
                               "torch"}


@pytest.mark.parametrize("fine", [None, "auto", "f64"])
def test_auto_and_f64_resolve_to_f64_on_cpu_and_match(fine):
    ode = nt.Burgers(d_x=32, normalization="-11", device="cpu")
    s = _solver(ode, fine)
    s64 = RKSolver(ode.get_vector_field(), 4, 32, G="RK1", F="RK4",
                   fine="torch", device="cpu")
    assert s.fine == "torch"
    t0s, t1s, U = _batch(ode)
    assert torch.equal(s.run_F_batch(t0s, t1s, U),
                       s64.run_F_batch(t0s, t1s, U))
    assert torch.equal(s.run_F(0.0, 0.1, U[0]), s64.run_F(0.0, 0.1, U[0]))
    assert torch.equal(s.fine_step_raw(0.0, 0.1, U[0]),
                       s64.fine_step_raw(0.0, 0.1, U[0]))


@pytest.mark.parametrize("fine", ["ds", "pallas"])
def test_explicit_double_single_runs_ds(fine):
    """tests/test_fine_auto.py:test_explicit_ds_not_overridden_on_cpu:
    near the f64 values, not their bitstream."""
    ode = nt.Hopf(normalization="-11", device="cpu")
    s = _solver(ode, fine)
    assert s.fine == fine
    t0s, t1s, U = _batch(ode)
    out = s.run_F_batch(t0s, t1s, U).numpy()
    s64 = _solver(ode, "f64")
    out64 = s64.run_F_batch(t0s, t1s, U).numpy()
    np.testing.assert_allclose(out, out64, rtol=1e-9)
    assert not np.array_equal(out, out64)


@pytest.mark.parametrize("fine", ["ds", "pallas"])
def test_single_slice_surfaces_run_in_ds(fine):
    """fine_step_raw and run_F are run_F_batch's row; the coarse solves
    and the trajectory stay f64."""
    ode = nt.Lorenz(normalization="-11", device="cpu")
    s = _solver(ode, fine, Nf=20, F="RK8")
    s64 = _solver(ode, "torch", Nf=20, F="RK8")
    u = ode.get_init_cond()
    t0, w = 0.0, 0.125
    row = s.run_F_batch(torch.tensor([t0], dtype=torch.float64),
                        torch.tensor([t0 + w], dtype=torch.float64),
                        u[None])[0]
    assert torch.equal(s.fine_step_raw(t0, w, u), row)
    assert torch.equal(s.run_F(t0, t0 + w, u), row)
    assert not torch.equal(row, s64.run_F(t0, t0 + w, u))
    assert torch.equal(s.coarse_step_raw(t0, w, u),
                       s64.coarse_step_raw(t0, w, u))
    assert torch.equal(s.run_F_full(t0, t0 + w, u),
                       s64.run_F_full(t0, t0 + w, u))


def test_legacy_fine_pallas_flag_and_what_raises():
    ode = nt.Burgers(d_x=32, normalization="-11", device="cpu")
    f = ode.get_vector_field()
    s = RKSolver(f, 4, 64, G="RK1", F="RK8", fine_ds=ode.get_ds_vector_field(),
                 fine_pallas=True, device_field=ode.get_device_field(),
                 device="cpu")
    assert s.fine == "pallas" and s.fine_pallas
    for fine in ("ds", "pallas"):
        with pytest.raises(ValueError, match="fine_ds"):
            RKSolver(f, 4, 64, fine=fine, device="cpu")
    with pytest.raises(ValueError, match="fine_ds"):
        RKSolver(f, 4, 64, fine_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="device_field"):
        RKSolver(f, 4, 64, fine="pallas", fine_ds=ode.get_ds_vector_field(),
                 device="cpu")
    with pytest.raises(ValueError, match="fine='xla'"):
        RKSolver(f, 4, 64, fine="xla", device="cpu")


def test_requires_fine_ds():
    """tests/test_rk_pallas.py:test_requires_fine_ds."""
    ode = nt.Lorenz(normalization="-11", device="cpu")
    with pytest.raises(ValueError, match="fine_ds"):
        RKSolver(ode.get_vector_field(), 4, 64, fine_pallas=True,
                 device="cpu")


def test_pallas_mode_on_the_card_raises_without_one(monkeypatch):
    """Given no device, or "cuda", a 'pallas' solver takes the card: with
    none it raises (torch's own error for "cuda": an AssertionError from a
    build without CUDA, a RuntimeError from one with it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ode = nt.Lorenz(normalization="-11", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _solver(ode, "pallas", device=None)
    with pytest.raises((RuntimeError, AssertionError)):
        _solver(ode, "pallas", device="cuda")


@pytest.mark.parametrize("name", ["Lorenz", "Hopf"])
def test_pallas_mode_matches_the_pallas_kernel(name):
    """tests/test_rk_pallas.py: B=16, 12 RK8 steps over slices of width
    0.05, against the Pallas kernel in interpret mode.

    That kernel runs jitted on the CPU, where XLA collapses part of its
    compensated arithmetic: measured, it lies 2.1e-9 (Lorenz) and 9.8e-10
    (Hopf) from the f64 integrator, while the port lies within 1e-14 of
    it (and bitwise on JAX's eager ds fan-out, tests/test_torch_rk_ds.py).
    So the port is held to the f64 values at 1e-13, and to the
    interpreter at rtol 1e-7 with atol 5e-9, its own CPU error."""
    oj = getattr(jt, name)(normalization="-11")
    ot = getattr(nt, name)(normalization="-11", device="cpu")
    rng = np.random.default_rng(0)
    B = 16
    U = rng.uniform(-0.5, 0.5, (B, ot.get_dim()))
    t0s, t1s = np.zeros(B), np.full(B, 0.05)
    want = np.asarray(make_pallas_fanout_ds(
        oj.get_ds_vector_field(), "RK8", 12, interpret=True)(
            jnp.asarray(t0s), jnp.asarray(t1s), jnp.asarray(U)))
    got = _solver(ot, "pallas", Nf=12, F="RK8").run_F_batch(t0s, t1s, U)
    f64 = _solver(ot, "torch", Nf=12, F="RK8").run_F_batch(t0s, t1s, U)
    assert (got - f64).abs().max().item() <= 1e-13
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=5e-9)
