"""The port's double-single RK (``nngparareal_torch/ops/rk_ds.py``) and the
ds kernel's wrapper (``ops/rk_cuda_ds.py``) on the CPU.

JAX's ds fan-out runs here under ``jax.disable_jit()`` (its
``lax.fori_loop`` then steps in Python, one primitive at a time): on the
CPU, XLA rewrites compensated arithmetic inside a jitted program, and
``ds32.backend_preserves_ds()`` is False here, so a jitted JAX ds run is
no oracle. Against eager JAX the port's fan-out is bitwise; against the
port's own f64 integrator, Burgers d=32 over 800 RK8 steps is within
5e-9 (tests/test_rk_ds.py), where plain f32 drifts above 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngparareal_tpu as jt
from nngparareal_tpu.ops.rk_ds import (
    make_batched_last_integrator_ds as jmake_ds,
)

import nngparareal_torch as nt
from nngparareal_torch.ops import rk_cuda, rk_cuda_ds
from nngparareal_torch.ops.rk import integrate_last
from nngparareal_torch.ops.rk_ds import make_batched_last_integrator_ds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,kw,B,steps", [
    ("Lorenz", {}, 3, 1),
    ("Burgers", {"d_x": 16}, 2, 1),
], ids=["Lorenz", "Burgers"])
def test_batched_fanout_bitwise_jax_eager(name, kw, B, steps):
    oj = getattr(jt, name)(normalization="-11", **kw)
    ot = getattr(nt, name)(normalization="-11", device="cpu", **kw)
    rng = np.random.default_rng(0)
    U = ot.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (B, ot.get_dim()))
    t0s = np.linspace(0.0, 0.3, B)
    t1s = t0s + np.linspace(0.05, 0.08, B)  # each slice its own width
    with jax.disable_jit():
        want = jmake_ds(oj.get_ds_vector_field(), "RK8", steps, jit=False)(
            jnp.asarray(t0s), jnp.asarray(t1s), jnp.asarray(U))
    got = make_batched_last_integrator_ds(
        ot.get_ds_vector_field(), "RK8", steps, jit=False, pack=True,
        min_rows=8)(torch.tensor(t0s), torch.tensor(t1s), torch.tensor(U))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_burgers_ds_tracks_f64_where_f32_drifts():
    ode = nt.Burgers(d_x=32, normalization="-11", device="cpu")
    f64 = ode.get_vector_field()
    u0 = ode.get_init_cond()
    t0, t1, steps = 0.0, 0.25, 800
    want = integrate_last(f64, "RK8", t0, (t1 - t0) / steps, steps, u0)
    fan = make_batched_last_integrator_ds(ode.get_ds_vector_field(), "RK8",
                                          steps)
    got = fan(torch.tensor([t0], dtype=torch.float64),
              torch.tensor([t1], dtype=torch.float64), u0[None])[0]
    assert (got - want).abs().max().item() <= 5e-9

    # plain f32 over 2000 steps of the same span drifts above 1e-6
    steps32 = 2000
    want32 = integrate_last(f64, "RK8", t0, (t1 - t0) / steps32, steps32,
                            u0)
    got32 = integrate_last(
        lambda t, u: f64(t, u.double()).float(), "RK8", np.float32(t0),
        np.float32((t1 - t0) / steps32), steps32, u0.float())
    assert (got32.double() - want32).abs().max().item() > 1e-6


def test_paging_changes_no_value():
    ode = nt.Hopf(normalization="-11", device="cpu")
    f_ds = ode.get_ds_vector_field()
    U = torch.tensor(ode.u0[None, :] + 0.05 * np.random.default_rng(1)
                     .uniform(-1.0, 1.0, (3, 3)))
    t0s = torch.zeros(3, dtype=torch.float64)
    t1s = torch.full((3,), 0.2, dtype=torch.float64)
    whole = make_batched_last_integrator_ds(f_ds, "RK4", 10)
    paged = make_batched_last_integrator_ds(f_ds, "RK4", 10, thresh=4)
    assert not getattr(whole, "paged", False) and paged.paged
    assert torch.equal(paged(t0s, t1s, U), whole(t0s, t1s, U))
    # warm runs one page of each size, 4 then the 2 left over
    warm = make_batched_last_integrator_ds(f_ds, "RK4", 6)
    assert torch.equal(paged.warm(t0s, t1s, U), warm(t0s, t1s * 0.6, U))


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the ds kernel's fan-out is its plain version: the
    batched ds integrator with slice 0's width for every slice; no launch
    is counted."""
    ode = nt.Lorenz(normalization="-11", device="cpu")
    f_ds = ode.get_ds_vector_field()
    fan = rk_cuda_ds.make_cuda_fanout_ds(f_ds, "RK8", 5,
                                         ode.get_device_field())
    t = torch.linspace(0.0, 1.0, 6, dtype=torch.float64)
    U = torch.tensor(np.random.default_rng(2).uniform(-0.5, 0.5, (5, 3)))
    before = dict(rk_cuda.rk_fanout.launches_by_field)
    got = fan(t[:-1], t[1:], U)
    assert rk_cuda.rk_fanout.launches_by_field == before
    w0 = (t[1] - t[0]).item()
    want = make_batched_last_integrator_ds(f_ds, "RK8", 5)(
        torch.zeros(5, dtype=torch.float64),
        torch.full((5,), w0, dtype=torch.float64), U)
    assert torch.equal(got, want)
    assert "lorenz_ds" in rk_cuda.rk_fanout.launches_by_field


def test_uniform_width_guard_and_autonomy():
    ode = nt.Lorenz(normalization="-11", device="cpu")
    fan = rk_cuda_ds.make_cuda_fanout_ds(ode.get_ds_vector_field(), "RK4",
                                         4, ode.get_device_field())
    U = torch.zeros((3, 3), dtype=torch.float64)
    t0s = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    with pytest.raises(ValueError, match="uniform slice widths"):
        fan(t0s, t0s + torch.tensor([1.0, 1.0, 1.5], dtype=torch.float64), U)
    fan(t0s, t0s + 1.0, U)  # one width: no raise

    def reads_t(t, u):
        uh, ul = u
        return uh * t, ul * t

    assert not rk_cuda_ds.ds_field_is_autonomous(reads_t, 3)
    assert rk_cuda_ds.ds_field_is_autonomous(ode.get_ds_vector_field(), 3)
    burgers = nt.Burgers(d_x=16, normalization="-11", device="cpu")
    assert rk_cuda_ds.ds_field_is_autonomous(
        burgers.get_ds_vector_field(), 16)
    fan_t = rk_cuda_ds.make_cuda_fanout_ds(reads_t, "RK4", 4,
                                           ode.get_device_field())
    with pytest.raises(NotImplementedError, match="autonomous"):
        fan_t(t0s, t0s + 1.0, U)


def test_step_pairs_follow_the_pallas_layout():
    """The coefficient pairs in rk_pallas.py:_coef_layout's order, split
    from vals * dt in f64, as the Pallas kernel's wrapper splits them."""
    from nngparareal_tpu.ops.butcher import get_tableau as jget
    from nngparareal_tpu.ops.rk_pallas import _coef_layout

    dt = 5.9 / 128 / 40000
    for name in ("RK1", "RK2", "RK4", "RK8"):
        vals, _, _ = _coef_layout(jget(name))
        np.testing.assert_array_equal(rk_cuda_ds.coef_layout(name), vals)
        hi, lo = rk_cuda_ds.step_pairs(name, dt)
        c = vals * dt
        np.testing.assert_array_equal(hi, c.astype(np.float32))
        np.testing.assert_array_equal(
            lo, (c - c.astype(np.float32).astype(np.float64)).astype(
                np.float32))


def test_each_ds_library_builds_its_own_field():
    """ops/rk_cuda.py:LIBRARIES builds csrc/ds_fanout.cu once per field
    with -DDS_PART=n; the source's part n must hold that field's entry
    point, and no other."""
    import re

    text = rk_cuda.DS_SOURCE.read_text()
    parts = {}
    for m in re.finditer(r"#(?:el)?if DS_PART == (\d+)\n(.*?)(?=\n#)",
                         text, re.S):
        names = re.findall(r"ds_(?:fanout|slice)_(\w+?)_launch|"
                           r"DS_SLICE_ENTRY\((\w+),", m.group(2))
        parts[int(m.group(1))] = {a or b for a, b in names}
    want = {}
    for name, (source, extra) in rk_cuda.LIBRARIES.items():
        if name == "rk_fanout":
            continue
        assert source == rk_cuda.DS_SOURCE
        part, = [int(x.split("=")[1]) for x in extra]
        want[part] = {name.replace("ds_fanout_", "")}
    assert parts == want
    assert set().union(*want.values()) == set(rk_cuda.FIELD_NAMES)
