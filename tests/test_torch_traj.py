"""Port parity for the trajectory API: ``ops/rk.py``'s ``integrate_traj``,
``integrate_traj_times`` and ``make_traj_integrator``, ``RKSolver``'s
``run_F_full``, ``run_G_full``, ``fine_step_raw`` and the ``*_timed``
methods, ``ScipySolver.fine_step_raw``, and ``Parareal.build_cont_traj``,
against the JAX package on the CPU.

Every trajectory step is the same sequence of IEEE f64 operations in both
packages (the port's ``rk_step`` unrolls the tableau in JAX's order), so
each trajectory is compared bitwise against the JAX function run one
operation at a time (``jax.disable_jit()``): Lorenz (d=3) and Burgers d=16
([-1,1]-normalised), RK4 and RK8, from seeded states. Under jit, XLA
contracts some a*b+c into FMAs, a few ulp a step (tests/test_torch_rk.py
holds the fan-out to rtol 1e-13 for that reason), so against the jitted
JAX functions, the ones its users call, the bound is rtol 1e-13.
``build_cont_traj`` integrates its N slices as one batch in the port (one
slice after another in JAX); each slice's rows are also held bitwise
against the port's own one-slice trajectory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops import rk as jrk

import nngparareal_torch as nt
from nngparareal_torch.ops import rk as trk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYSTEMS = {
    "lorenz": lambda pkg, **kw: pkg.Lorenz(normalization="-11", **kw),
    "burgers16": lambda pkg, **kw: pkg.Burgers(d_x=16, normalization="-11",
                                               **kw),
}


def _pair(system):
    """The system's vector field in both packages and a seeded state near
    its u0."""
    oj = SYSTEMS[system](jt)
    ot = SYSTEMS[system](nt, device="cpu")
    rng = np.random.default_rng(7)
    u0 = np.asarray(oj.get_init_cond()) + 1e-3 * rng.standard_normal(
        oj.get_dim())
    return oj.get_vector_field(), ot.get_vector_field(), u0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _jax_both(fn):
    """JAX's ``fn()`` one operation at a time (IEEE, no contraction) and
    jitted, as numpy arrays."""
    with jax.disable_jit():
        eager = np.asarray(fn())
    return eager, np.asarray(fn())


def _matches_jax(got, fn):
    """Bitwise JAX's op-by-op result; within rtol 1e-13 of its jitted one."""
    eager, jitted = _jax_both(fn)
    _same(got, eager)
    np.testing.assert_allclose(_np(got), jitted, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("tableau", ["RK4", "RK8"])
def test_integrate_traj_bitwise(system, tableau):
    fj, ft, u0 = _pair(system)
    t0, dt, steps = 0.3, 0.01, 40
    got = trk.integrate_traj(ft, tableau, t0, dt, steps, torch.as_tensor(u0))
    assert got.shape == (steps + 1, u0.shape[0])
    _same(got[0], u0)
    _matches_jax(got, lambda: jrk.integrate_traj(fj, tableau, t0, dt, steps,
                                                 jnp.asarray(u0)))


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_integrate_traj_times_bitwise(system):
    """A non-uniform grid, given as an array."""
    fj, ft, u0 = _pair(system)
    t = np.cumsum(np.r_[0.1, np.random.default_rng(3).uniform(0.002, 0.02,
                                                               30)])
    got = trk.integrate_traj_times(ft, "RK4", t, torch.as_tensor(u0))
    assert got.shape == (t.shape[0], u0.shape[0])
    _matches_jax(got, lambda: jrk.integrate_traj_times(
        fj, "RK4", jnp.asarray(t), jnp.asarray(u0)))


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_make_traj_integrator_bitwise(system):
    fj, ft, u0 = _pair(system)
    got = trk.make_traj_integrator(ft, "RK8", 25)(0.0, 0.4,
                                                  torch.as_tensor(u0))
    _matches_jax(got, lambda: jrk.make_traj_integrator(fj, "RK8", 25)(
        0.0, 0.4, jnp.asarray(u0)))


def _solvers(system, **kw):
    fj, ft, u0 = _pair(system)
    sj = jt.RKSolver(fj, 3, 30, G="RK2", F="RK4", **kw)
    st = nt.RKSolver(ft, 3, 30, G="RK2", F="RK4", device="cpu")
    return sj, st, u0


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("method", ["run_F_full", "run_G_full"])
def test_solver_full_trajectories(system, method):
    sj, st, u0 = _solvers(system)
    got = getattr(st, method)(0.2, 0.5, u0)
    steps = st.Nf if method == "run_F_full" else st.Ng
    assert got.shape == (steps + 1, u0.shape[0])
    _matches_jax(got, lambda: getattr(sj, method)(0.2, 0.5, jnp.asarray(u0)))
    # the timed twin returns the same values and its seconds
    timed, secs = getattr(st, method + "_timed")(0.2, 0.5, u0)
    _same(timed, got)
    assert secs > 0.0


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_fine_step_raw_and_timed(system):
    sj, st, u0 = _solvers(system)
    _matches_jax(st.fine_step_raw(0.2, 0.3, torch.as_tensor(u0)),
                 lambda: sj.fine_step_raw(0.2, 0.3, jnp.asarray(u0)))
    # the one-slice solves, through the timed methods
    got, secs = st.run_F_timed(0.2, 0.5, u0)
    _matches_jax(got, lambda: sj.run_F(0.2, 0.5, jnp.asarray(u0)))
    got, secs = st.run_G_timed(0.2, 0.5, u0)
    _matches_jax(got, lambda: sj.run_G(0.2, 0.5, jnp.asarray(u0)))
    assert secs > 0.0


def test_scipy_solver_fine_step_raw():
    """ScipySolver's raw step is its RK side's, as in JAX."""
    fj, ft, u0 = _pair("lorenz")
    sj = jt.ScipySolver(fj, 3, 30, G="RK2")
    st = nt.ScipySolver(ft, 3, 30, G="RK2", device="cpu")
    _matches_jax(st.fine_step_raw(0.1, 0.2, torch.as_tensor(u0)),
                 lambda: sj.fine_step_raw(0.1, 0.2, jnp.asarray(u0)))
    with pytest.raises(NotImplementedError):
        st.run_F_full(0.0, 0.1, u0)


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_build_cont_traj(system):
    """The same {"t", "u"} dict in both packages: bitwise, and each of the
    port's batched slices equal to its one-slice trajectory."""
    N = 4
    fj, ft, _ = _pair(system)
    oj = SYSTEMS[system](jt)
    ot = SYSTEMS[system](nt, device="cpu")
    pj = jt.Parareal(oj, jt.RKSolver(fj, 2, 30, G="RK1", F="RK4"),
                     [0.0, 0.8], N, verbose=None)
    pt = nt.Parareal(ot, nt.RKSolver(ft, 2, 30, G="RK1", F="RK4",
                                      device="cpu"),
                     [0.0, 0.8], N, verbose=None, device="cpu")
    rng = np.random.default_rng(11)
    u = (np.asarray(oj.get_init_cond())[None]
         + 1e-2 * rng.standard_normal((N + 1, oj.get_dim())))
    run = {"t": np.linspace(0.0, 0.8, N + 1), "u": u}
    got = pt.build_cont_traj(run)
    assert got.shape == (N * 31, oj.get_dim())
    _matches_jax(got, lambda: pj.build_cont_traj(run))
    want = got
    for i in range(N):
        _same(got[31 * i:31 * (i + 1)],
              pt.solver.run_F_full(run["t"][i], run["t"][i + 1], u[i]))
        _same(got[31 * i], u[i])
    # a stored run's name, and the one stored run by default
    pt.runs["only"] = run
    _same(pt.build_cont_traj(), want)
    _same(pt.build_cont_traj("only"), want)
    pt.runs["other"] = run
    with pytest.raises(Exception, match="Multiple runs"):
        pt.build_cont_traj()
