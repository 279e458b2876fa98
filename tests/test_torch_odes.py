"""Port parity for the ODE zoo: systems, fields, configs, the registry and
the fan-out kernel's ODE fields.

The same numpy inputs (seeded ``np.random.default_rng``) go through the
JAX package (on the CPU, f64) and nngparareal_torch (``device="cpu"``):

* the seven ODE systems: u0, bounds, name and dimension equal, raw and
  [-1,1]-normalised;
* their fields on 64 random states each: the JAX field runs op by op
  (``vmap``, unjitted), so the polynomial fields agree to rtol 1e-15;
  DblPend and ThomasLabyrinth call sin and cos, whose implementations
  differ between XLA and torch by a few ulp: rtol 4e-15 of max|f|;
* every ``Config`` entry field for field (Hopf N in {32, 512}, TomLab N in
  {32..512}), the ``_{N}`` suffix of the name, and the errors for a
  missing or invalid N;
* ``make_system`` on the aliases, the ``_n`` suffix and embedded N;
* each system's device field (the kernel's constants: Hopf's maxtime and
  the [-1,1] map, held against the JAX normaliser's arrays) run through a
  plain torch transcription of its CUDA functor (``_functor_field``)
  equals ``get_vector_field()`` bitwise; on CPU tensors the kernel's
  wrapper takes the plain integrator, and the coarse solves stay the torch
  integrator;
* the plain RK fan-out of each system against the JAX f64 fan-out, RK4 at
  B=8 over 50 steps: rtol 1e-13 (XLA contracts some a*b+c into FMAs under
  jit).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops import rk as jrk
from nngparareal_tpu.systems import configs as jconfigs
from nngparareal_tpu.systems import registry as jregistry

import nngparareal_torch as nt
from nngparareal_torch.ops import rk as trk
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.ops.rk_cuda import ODE_DIMS, OdeField
from nngparareal_torch.systems import registry as tregistry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYSTEMS = ["FHNODE", "Rossler", "Hopf", "DblPend", "Brusselator", "Lorenz",
           "ThomasLabyrinth"]
TRIG = ("DblPend", "ThomasLabyrinth")
KINDS = dict(zip(SYSTEMS, ["fhn_ode", "rossler", "hopf", "dblpend",
                           "brusselator", "lorenz", "tomlab"]))
NORMS = ["-11", None]


def _pair(name, norm):
    return (getattr(jt, name)(normalization=norm),
            getattr(nt, name)(normalization=norm, device="cpu"))


def _states(ode, B=64, seed=1):
    """B states in the box of the system's bounds, normalised or not."""
    rng = np.random.default_rng(seed)
    d = ode.get_dim()
    if not ode.normalizer.is_identity:
        return rng.uniform(-1.0, 1.0, (B, d))
    lo, hi = ode.normalizer.mn, ode.normalizer.mx
    return lo + (hi - lo) * rng.uniform(size=(B, d))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", SYSTEMS)
def test_system_matches_jax(name, norm):
    oj, ot = _pair(name, norm)
    assert ot.name == oj.name and ot.get_dim() == oj.get_dim()
    np.testing.assert_array_equal(ot.normalizer.mn, oj.normalizer.mn)
    np.testing.assert_array_equal(ot.normalizer.mx, oj.normalizer.mx)
    np.testing.assert_array_equal(ot.get_init_cond().numpy(),
                                  oj.get_init_cond())
    if name == "Hopf":
        assert ot.maxtime == oj.maxtime == 500.0
        hj = jt.Hopf(tspan=(-5.0, 70.0), normalization=norm)
        ht = nt.Hopf(tspan=(-5.0, 70.0), normalization=norm, device="cpu")
        assert ht.maxtime == hj.maxtime
        np.testing.assert_array_equal(ht.u0, hj.u0)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", SYSTEMS)
def test_field_matches_jax(name, norm):
    oj, ot = _pair(name, norm)
    U = _states(ot)
    want = np.asarray(jax.vmap(oj.get_vector_field(), in_axes=(None, 0))(
        0.0, jnp.asarray(U)))
    got = ot.get_vector_field()(0.0, torch.as_tensor(U)).numpy()
    rtol = 4e-15 if name in TRIG else 1e-15
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    # one state (d,) and a batch (B, d) go through the same field
    one = ot.get_vector_field()(0.0, torch.as_tensor(U[3])).numpy()
    np.testing.assert_array_equal(one, got[3])


CONFIGS = [(name, None) for name in SYSTEMS
           if name not in ("Hopf", "ThomasLabyrinth")]
CONFIGS += [("Hopf", N) for N in (32, 512)]
CONFIGS += [("ThomasLabyrinth", N) for N in (32, 64, 128, 256, 512)]


@pytest.mark.parametrize("name,N", CONFIGS)
def test_config_matches_jax(name, N):
    oj, ot = _pair(name, "-11")
    cj = jconfigs.Config(oj, N=N).get()
    ct = nt.Config(ot, N=N).get()
    assert set(ct) == set(cj)
    for key in cj:
        if key == "u0":
            np.testing.assert_array_equal(ct[key], cj[key])
        else:
            assert ct[key] == cj[key] and type(ct[key]) is type(cj[key]), key
    # the config sets the default initial condition, and names the N
    np.testing.assert_array_equal(ot.u0, oj.u0)
    assert ot.name == oj.name
    if N is not None:
        assert ot.name.endswith(f"_{N}")


@pytest.mark.parametrize("name,N,match", [
    ("Hopf", None, "N must be provided"),
    ("ThomasLabyrinth", None, "Invalid N"),
    ("ThomasLabyrinth", 100, "Invalid N"),
])
def test_config_refuses_missing_or_invalid_N(name, N, match):
    oj, ot = _pair(name, "-11")
    with pytest.raises(Exception, match=match):
        jconfigs.Config(oj, N=N)
    with pytest.raises(Exception, match=match):
        nt.Config(ot, N=N)


@pytest.mark.parametrize("key", [
    "fhn", "fhn_ode_n", "rossler_long_n", "Rossler", "hopf", "non_aut512_n",
    "hopf64", "dbl_pend_n", "DblPend", "brus_2d_n", "brusselator", "lorenz",
    "Lorenz_n", "tom_lab64", "tom_lab_n", "thomaslabyrinth",
])
def test_make_system_matches_jax(key):
    oj, pj = jregistry.make_system(key)
    ot, pt = tregistry.make_system(key, device="cpu")
    assert type(ot).__name__ == type(oj).__name__
    assert pt == pj
    assert ot.normalizer.norm_type == oj.normalizer.norm_type
    assert ot.name == oj.name
    np.testing.assert_array_equal(ot.u0, oj.u0)


def test_make_system_refusals():
    with pytest.raises(KeyError, match="Unknown system"):
        tregistry.make_system("vanderpol", device="cpu")
    with pytest.raises(TypeError, match="d_x"):
        tregistry.make_system("burgers_n", device="cpu")
    ot, _ = tregistry.make_system("fhn_pde_n", d_x=4, device="cpu")
    assert isinstance(ot, nt.FHNPDE)
    # DiffReact is ported (tests/test_torch_diffreact.py); like the PDEs
    # it needs its grid width
    with pytest.raises(TypeError, match="d_x"):
        tregistry.make_system("diffreact", device="cpu")
    ot, _ = tregistry.make_system("diffreact", d_x=4, device="cpu")
    assert isinstance(ot, nt.DiffReact)


# plain torch transcriptions of the kernel's raw ODE functors
# (csrc/rk_fanout.cu), (u, consts) -> the field's components. The functors
# write their own constants (0.2, 5.7, 28, 8/3, ...) into the CUDA source,
# so these copies pin only what the device field carries: the kind, Hopf's
# maxtime and the [-1,1] map. test_torch_gpu.py::test_ode_kernel_matches_plain
# holds the functors themselves against the systems' fields on the card.


def _fhn_ode(u, c):
    u0, u1 = u.unbind(-1)
    return [3.0 * (u0 - (u0 * u0 * u0) / 3.0 + u1),
            -(1.0 / 3.0) * (u0 - 0.2 + 0.2 * u1)]


def _rossler(u, c):
    u0, u1, u2 = u.unbind(-1)
    return [-u1 - u2, u0 + 0.2 * u1, 0.2 + u2 * (u0 - 5.7)]


def _hopf(u, c):
    u0, u1, u2 = u.unbind(-1)
    mu = u2 / c[0] - u0 * u0 - u1 * u1
    return [-u1 + u0 * mu, u0 + u1 * mu, torch.ones_like(mu)]


def _dblpend(u, c):
    u0, u1, u2, u3 = u.unbind(-1)
    cd, sd = torch.cos(u0 - u2), torch.sin(u0 - u2)
    sin0, sin2 = torch.sin(u0), torch.sin(u2)
    sq1, sq3 = u1 * u1, u3 * u3
    den = -1.0 / (2.0 - cd * cd)
    return [u1, den * (sq1 * cd * sd + sq3 * sd + 2.0 * sin0 - cd * sin2),
            u3, den * (-2.0 * sq1 * sd - sq3 * sd * cd - 2.0 * cd * sin0
                       + 2.0 * sin2)]


def _brusselator(u, c):
    u0, u1 = u.unbind(-1)
    sq0_u1 = u0 * u0 * u1
    return [1.0 + sq0_u1 - 4.0 * u0, 3.0 * u0 - sq0_u1]


def _lorenz(u, c):
    u0, u1, u2 = u.unbind(-1)
    return [10.0 * (u1 - u0), 28.0 * u0 - u1 - u0 * u2,
            u0 * u1 - (8.0 / 3.0) * u2]


def _tomlab(u, c):
    x = u.unbind(-1)
    return [-0.5 * x[i] + 10.0 * torch.sin(x[(i + 1) % 3]) for i in range(3)]


FUNCTORS = {"fhn_ode": _fhn_ode, "rossler": _rossler, "hopf": _hopf,
            "dblpend": _dblpend, "brusselator": _brusselator,
            "lorenz": _lorenz, "tomlab": _tomlab}


def _functor_field(fld, u):
    """The field at states u (..., d) from the device field ``fld`` alone,
    as the kernel's functor computes it: raw((u + 1)/2 * span + mn) * scale,
    or raw(u) for the identity map."""
    raw = lambda x: torch.stack(FUNCTORS[fld.name](x, fld.consts), dim=-1)
    if fld.mn is None:
        return raw(u)
    mn, span, scale = (torch.tensor(x, dtype=u.dtype, device=u.device)
                       for x in (fld.mn, fld.span, fld.scale))
    return raw((u + 1.0) / 2.0 * span + mn) * scale


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", SYSTEMS)
def test_device_field_reproduces_the_field(name, norm):
    """The kernel's constants, fed through the plain transcription of its
    functor, give the system's own torch field bit for bit."""
    oj, ot = _pair(name, norm)
    fld = ot.get_device_field()
    assert isinstance(fld, OdeField) and fld.name == KINDS[name]
    assert fld.values == ot.get_dim() == ODE_DIMS[fld.name]
    assert fld.grid(ot.get_dim()) == ()
    with pytest.raises(ValueError, match="d="):
        fld.grid(ot.get_dim() + 1)
    assert fld.consts == ((oj.maxtime,) if name == "Hopf" else ())
    if norm is None:
        assert fld.mn is fld.span is fld.scale is None
        assert fld.constants()[0] is None
    else:
        nj = oj.normalizer
        assert fld.mn == tuple(nj.mn)
        assert fld.span == tuple(nj.mx - nj.mn)
        assert fld.scale == tuple(nj.get_scale())
        # the host array the C entry point reads: mn, span, scale
        assert list(fld.constants()[0]) == [*fld.mn, *fld.span, *fld.scale]
    U = torch.as_tensor(_states(ot, seed=2))
    want = ot.get_vector_field()(0.0, U)
    torch.testing.assert_close(_functor_field(fld, U), want, rtol=0,
                               atol=0)


def test_ode_field_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="no ODE field"):
        OdeField("vanderpol")


@pytest.mark.parametrize("name", SYSTEMS)
def test_cpu_fanout_and_coarse_stay_plain(name):
    """On CPU tensors the wrapper integrates with the plain version, and
    the solver's coarse solves stay the torch integrator (bitwise)."""
    ot = getattr(nt, name)(normalization="-11", device="cpu")
    f, fld = ot.get_vector_field(), ot.get_device_field()
    rng = np.random.default_rng(3)
    U = torch.as_tensor(ot.u0 + 0.05 * rng.uniform(-1.0, 1.0, (5, ot.get_dim())))
    t0 = torch.linspace(0.0, 0.4, 5, dtype=torch.float64)
    t1 = t0 + 0.1
    before = rk_cuda.rk_fanout.launches
    got = rk_cuda.rk_fanout(t0, t1, U, "RK8", 20, fld, f)
    want = trk.make_batched_last_integrator(f, "RK8", 20)(t0, t1, U)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    s = nt.RKSolver(f, 7, 20, G="RK4", F="RK8", device_field=fld,
                    device="cpu")
    assert s.fine == "torch" and not s.coarse_kernel
    u = s.coarse_step_raw(0.3, 0.1, U[0])
    torch.testing.assert_close(
        u, trk.integrate_last(f, "RK4", 0.3, 0.1 / 7, 7, U[0]),
        rtol=0, atol=0)
    assert rk_cuda.rk_fanout.launches == before  # no kernel ran


@pytest.mark.parametrize("name", SYSTEMS)
def test_plain_fanout_matches_jax(name):
    oj, ot = _pair(name, "-11")
    rng = np.random.default_rng(4)
    U = _states(ot, B=8, seed=4)
    t0 = rng.uniform(0.0, 1.0, 8)
    t1 = t0 + 0.2 * rng.uniform(0.5, 1.0, 8)
    fan_j = jrk.make_batched_last_integrator(oj.get_vector_field(), "RK4", 50)
    want = np.asarray(fan_j(jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(U)))
    fan_t = trk.make_batched_last_integrator(ot.get_vector_field(), "RK4", 50)
    got = fan_t(torch.as_tensor(t0), torch.as_tensor(t1),
                torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
