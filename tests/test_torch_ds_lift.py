"""The port's ds lifter (``nngparareal_torch/ops/ds_lift.py``) and its
systems' ds fields against the JAX package's on the CPU.

The JAX package's lifted fields and steps are evaluated eagerly, one
primitive at a time (the fields under ``jax.disable_jit()``), never as a
jitted program: on the CPU, XLA rewrites compensated arithmetic inside
jitted programs (``ds32.backend_preserves_ds()`` is False here), so only
eager JAX is an oracle of ds values. Where the port's torch field
and the JAX field take their operations in the same order, the lifted
values are bitwise JAX's; where they differ (FHN's ``u0*u0*u0`` against
``u[0]**3``, FHN-PDE's fused normalisation and its ``lap*a`` against
``a*lap``), within 1e-13 of max(1, |f|). Against the port's own f64
field: within 1e-11 (tests/test_ds_lift.py's bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops import ds32 as jds
from nngparareal_tpu.ops.ds_lift import ds_lift as jds_lift
from nngparareal_tpu.ops.rk_ds import rk_step_ds as jrk_step_ds

import nngparareal_torch as nt
from nngparareal_torch.ops import ds32 as tds
from nngparareal_torch.ops.ds_lift import DSPair, ds_lift
from nngparareal_torch.ops.rk_ds import rk_step_ds

ZOO = [
    ("FHNODE", {}), ("Rossler", {}), ("Hopf", {}), ("DblPend", {}),
    ("Brusselator", {}), ("Lorenz", {}), ("ThomasLabyrinth", {}),
    ("Burgers", {"d_x": 32}), ("FHNPDE", {"d_x": 6}),
]
# the fields whose torch expression differs in order from JAX's
NOT_BITWISE = {"FHNODE", "FHNPDE"}


def _eager_jax(f_ds, t, u):
    with jax.disable_jit():
        kh, kl = f_ds(jnp.asarray(t), jds.ds_from_f64(jnp.asarray(u)))
    return np.asarray(kh), np.asarray(kl)


def _port(f_ds, t, u):
    kh, kl = f_ds(t, tds.ds_from_f64(torch.tensor(u)))
    return kh.numpy(), kl.numpy()


def _systems(name, kw, norm):
    return (getattr(jt, name)(normalization=norm, **kw),
            getattr(nt, name)(normalization=norm, device="cpu", **kw))


# every field normalised, and the ODE fields raw too (the PDEs' ds
# fields are the [-1,1]-normalised ones)
CASES = ([(name, kw, "-11") for name, kw in ZOO]
         + [(name, kw, None) for name, kw in ZOO[:7]])


@pytest.mark.parametrize("name,kw,norm", CASES,
                         ids=[f"{c[0]}-{c[2] or 'raw'}" for c in CASES])
def test_lifted_field_matches_jax_and_f64(name, kw, norm):
    oj, ot = _systems(name, kw, norm)
    fj, ft = oj.get_ds_vector_field(), ot.get_ds_vector_field()
    f64 = ot.get_vector_field()
    rng = np.random.default_rng(3)
    for _ in range(3):
        u = rng.uniform(-0.9, 0.9, ot.get_dim())
        if norm is None:
            u = ot.u0 + 0.05 * u
        (jh, jl), (th, tl) = _eager_jax(fj, 0.3, u), _port(ft, 0.3, u)
        want = jh.astype(np.float64) + jl
        got = th.astype(np.float64) + tl
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-13 * scale
        if name not in NOT_BITWISE:
            np.testing.assert_array_equal(th, jh)
            np.testing.assert_array_equal(tl, jl)
        exact = f64(0.3, torch.tensor(u)).numpy()
        assert np.abs(got - exact).max() <= 1e-11 * scale


def test_burgers_hand_field_and_dense_operators_are_jax():
    oj, ot = _systems("Burgers", {"d_x": 32}, "-11")
    from nngparareal_tpu.ops.rk_ds import make_burgers_ds_field as jmake
    from nngparareal_torch.ops.rk_ds import make_burgers_ds_field as tmake

    u = np.random.default_rng(5).uniform(-0.9, 0.9, (4, 32))
    jh, jl = _eager_jax(jmake(oj), 0.0, u)
    th, tl = _port(tmake(ot), 0.0, u)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)
    for a, b in zip(ot.dense_operators(), oj.dense_operators()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="normalized"):
        nt.Burgers(d_x=8, device="cpu").get_ds_vector_field()


@pytest.mark.parametrize("name", ["Lorenz", "ThomasLabyrinth", "DblPend",
                                  "Hopf"])
def test_thirty_rk4_steps_match_jax_eager_and_f64(name):
    """tests/test_ds_lift.py's 30 eager RK4 steps, both packages."""
    oj, ot = _systems(name, {}, "-11")
    fj, ft = oj.get_ds_vector_field(), ot.get_ds_vector_field()
    f64 = ot.get_vector_field()
    u0 = ot.u0
    jh, jl = jds.ds_from_f64(jnp.asarray(u0))
    th, tl = tds.ds_from_f64(torch.tensor(u0))
    u = torch.tensor(u0)
    dt = 1e-3
    from nngparareal_torch.ops.rk import rk_step

    for n in range(30):
        jh, jl = jrk_step_ds(fj, "RK4", n * dt, jh, jl, jnp.asarray(dt))
        th, tl = rk_step_ds(ft, "RK4", n * dt, th, tl, dt)
        u = rk_step(f64, "RK4", n * dt, u, dt)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tds.ds_to_f64(th, tl) - u).abs().max().item() < 1e-11


def test_diffreact_raises_naming_matmul():
    ot = nt.DiffReact(d_x=4, normalization="-11", device="cpu")
    f_ds = ot.get_ds_vector_field()
    z = torch.zeros(ot.get_dim(), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="'matmul'"):
        f_ds(0.0, (z, z))


def test_rules_match_the_jax_lifter():
    """pow with negative, zero and float-integer exponents, abs, maximum,
    minimum, where, comparisons, cat and a tensor constant on the left:
    bitwise the JAX lifter's rules."""

    def fj(t, u):
        c = jnp.asarray([0.25, -1.5, 3.0])
        m = jnp.maximum(u, 0.3 * u) + jnp.minimum(u ** 2.0, jnp.abs(u))
        w = jnp.where(u > 0.1, u ** -2, 1.0 / (u - 2.0))
        return jnp.concatenate([(c * m + w)[:2], (u ** 0 + m)[2:]])

    def ft(t, u):
        c = torch.tensor([0.25, -1.5, 3.0], dtype=torch.float64)
        m = torch.maximum(u, 0.3 * u) + torch.minimum(u ** 2.0, torch.abs(u))
        w = torch.where(u > 0.1, u ** -2, 1.0 / (u - 2.0))
        return torch.cat([(c * m + w)[:2], (u ** 0 + m)[2:]])

    u = np.array([0.7, -0.4, 0.05])
    jh, jl = _eager_jax(jds_lift(fj), 0.0, u)
    th, tl = _port(ds_lift(ft), 0.0, u)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)


def test_a_field_without_a_rule_raises_naming_it():
    def f(t, u):
        return torch.exp(u)

    z = torch.zeros(3, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="'exp'"):
        ds_lift(f)(0.0, (z, z))
    with pytest.raises(NotImplementedError, match="non-integer"):
        ds_lift(lambda t, u: u ** 0.5)(0.0, (z, z))


def test_out_writes_both_halves():
    x = DSPair(torch.tensor([1.0, 2.0]), torch.tensor([1e-9, -1e-9]))
    out = torch.empty_like(x)
    assert isinstance(out, DSPair)
    res = torch.add(x, 0.5, out=out)
    assert res is out
    want = tds.ds_add(x.hi, x.lo, torch.tensor(0.5), torch.tensor(0.0))
    assert torch.equal(out.hi, want[0]) and torch.equal(out.lo, want[1])
