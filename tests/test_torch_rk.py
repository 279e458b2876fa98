"""Port parity: the torch f64 RK integrators (the plain version of the CUDA
fan-out kernel) against the JAX package.

(a) ``make_batched_last_integrator`` against the JAX f64 fan-out for
    RK1/2/4/8 on Burgers d=16, B=5, 50 steps. Tolerance rtol 1e-13: the
    same arithmetic, except that XLA contracts some a*b+c into FMAs under
    jit, a few ulp per step.
(b) the same against the Pallas kernel ``make_pallas_fanout_ds`` run in
    interpret mode, as tests/test_rk_pallas.py runs it, on Burgers d=64
    (the (B, d) layout of the flagship), B=2, 2 RK8 steps. Tolerance: the
    double-single floor, rtol 1e-9 of max|U|, where the backend preserves
    compensated arithmetic (``ds32.backend_preserves_ds``). XLA:CPU does
    not (it re-associates the compensated sums, see that function), so on
    the CPU the Pallas result is f32-accurate and the bound is 2**-23 of
    max|U|.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops import ds32
from nngparareal_tpu.ops import rk as jrk
from nngparareal_tpu.ops.rk_pallas import make_pallas_fanout_ds

import nngparareal_torch as nt
from nngparareal_torch.ops import rk as trk
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.solver import select_fine_mode


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burgers(d_x):
    return (jt.Burgers(d_x=d_x, normalization="-11"),
            nt.Burgers(d_x=d_x, normalization="-11", device="cpu"))


def _inputs(B, d, seed=0, width=0.05):
    rng = np.random.default_rng(seed)
    U = rng.uniform(-0.5, 0.5, (B, d))
    t0 = rng.uniform(0.0, 1.0, B)
    return t0, t0 + width, U


@pytest.mark.parametrize("tab", ["RK1", "RK2", "RK4", "RK8"])
def test_plain_fanout_matches_jax_f64(tab):
    oj, ot = _burgers(16)
    t0, t1, U = _inputs(5, 16)
    want = np.asarray(jrk.make_batched_last_integrator(
        oj.get_vector_field(), tab, 50)(jnp.asarray(t0), jnp.asarray(t1),
                                        jnp.asarray(U)))
    got = trk.make_batched_last_integrator(ot.get_vector_field(), tab, 50)(
        torch.as_tensor(t0), torch.as_tensor(t1), torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_paged_single_slice_matches_jax():
    """``thresh`` paging (3 pages of 16 + 2) against the JAX pager."""
    oj, ot = _burgers(16)
    t0, t1, U = _inputs(1, 16, seed=3)
    want = np.asarray(jrk.make_last_integrator(
        oj.get_vector_field(), "RK4", 50, thresh=16)(t0[0], t1[0],
                                                     jnp.asarray(U[0])))
    run = trk.make_last_integrator(ot.get_vector_field(), "RK4", 50, thresh=16)
    got = run(t0[0], t1[0], torch.as_tensor(U[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
    unpaged = trk.make_last_integrator(ot.get_vector_field(), "RK4", 50)
    np.testing.assert_array_equal(
        unpaged(t0[0], t1[0], torch.as_tensor(U[0])).numpy(), got)


def test_plain_fanout_matches_pallas_interpret():
    oj, ot = _burgers(64)
    B, steps = 2, 2
    U = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 64))
    t0, t1 = np.zeros(B), np.full(B, 0.05)
    run_p = make_pallas_fanout_ds(oj.get_ds_vector_field(), "RK8", steps,
                                  interpret=True)
    want = np.asarray(run_p(jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(U)))
    got = trk.make_batched_last_integrator(ot.get_vector_field(), "RK8", steps)(
        torch.as_tensor(t0), torch.as_tensor(t1), torch.as_tensor(U)).numpy()
    rel = 1e-9 if ds32.backend_preserves_ds() else 2.0 ** -23
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(U).max())


def test_kernel_wrapper_takes_plain_version_on_cpu():
    _, ot = _burgers(16)
    t0, t1, U = (torch.as_tensor(x) for x in _inputs(4, 16, seed=5))
    before = rk_cuda.rk_fanout.launches
    f = ot.get_vector_field()
    got = rk_cuda.rk_fanout(t0, t1, U, "RK8", 20, ot.get_device_field(), f)
    want = trk.make_batched_last_integrator(f, "RK8", 20)(t0, t1, U)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rk_cuda.rk_fanout.launches == before  # no kernel ran
    with pytest.raises(TypeError, match="no form"):
        rk_cuda.rk_fanout(t0, t1, U, "RK8", 20, f, f)


def test_solver_fanout_and_fine_mode_selection():
    oj, ot = _burgers(16)
    s = nt.RKSolver(ot.get_vector_field(), 4, 30, G="RK1", F="RK8",
                    device_field=ot.get_device_field(), device="cpu")
    assert s.fine == "torch"  # the CPU takes the plain version
    sj = jt.RKSolver(oj.get_vector_field(), 4, 30, G="RK1", F="RK8")
    t0, t1, U = _inputs(3, 16, seed=7)
    np.testing.assert_allclose(
        s.run_F_batch(t0, t1, U).numpy(),
        np.asarray(sj.run_F_batch(t0, t1, U)), rtol=1e-13, atol=1e-15)
    t = np.linspace(0.0, 5.9, 9)
    np.testing.assert_allclose(
        s.run_G_chain(t, U[0]).numpy(),
        np.asarray(sj.run_G_chain(jnp.asarray(t), jnp.asarray(U[0]))),
        rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        s.run_F(0.1, 0.2, U[1]).numpy(),
        np.asarray(sj.run_F(0.1, 0.2, U[1])), rtol=1e-13, atol=1e-15)
    assert select_fine_mode("cpu", True) == "torch"
    assert select_fine_mode("cuda", True) == "cuda"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_fine_mode("cuda", False)
