"""The port's double-single arithmetic (``nngparareal_torch/ops/ds32.py``)
against the JAX package's (``nngparareal_tpu/ops/ds32.py``) on the CPU.

JAX runs here eagerly, one primitive at a time, never under ``jit``: on
the CPU, XLA rewrites compensated arithmetic inside a jitted program
(``t - (t - a) -> a``), and ``ds32.backend_preserves_ds()`` is False
here, so a jitted JAX ds value is not an oracle. Eager JAX and eager
torch round the same f32 operations in the same order, so every
primitive must agree bit for bit, on 5 000 seeded values; each is also
held to its accuracy against f64 at tests/test_ds_lift.py's bounds. The
CUDA kernel's header (csrc/ds32.cuh) must hold the same f32 constants.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nngparareal_tpu.ops import ds32 as jds
from nngparareal_torch.ops import ds32 as tds
from nngparareal_torch.ops import rk_cuda

N = 5000


def _pair_inputs(seed=1):
    """Seeded operands: a in [-5, 5], b in +-[0.5, 4] (no division by a
    value near 0), each split into a pair by both packages."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5.0, 5.0, N)
    b = rng.uniform(0.5, 4.0, N) * rng.choice([-1.0, 1.0], N)
    return a, b


def _same(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("op", ["ds_add", "ds_sub", "ds_mul", "ds_div"])
def test_pair_operations_bitwise_jax_eager(op):
    a, b = _pair_inputs()
    ja, jb = jds.ds_from_f64(jnp.asarray(a)), jds.ds_from_f64(jnp.asarray(b))
    ta = tds.ds_from_f64(torch.tensor(a))
    tb = tds.ds_from_f64(torch.tensor(b))
    _same(ja, ta)
    _same(getattr(jds, op)(*ja, *jb), getattr(tds, op)(*ta, *tb))


@pytest.mark.parametrize("op", ["two_sum", "two_prod", "fast_two_sum"])
def test_error_free_transforms_bitwise_jax_eager(op):
    a, b = _pair_inputs(2)
    ja = jnp.asarray(a, dtype=jnp.float32)
    jb = jnp.asarray(b, dtype=jnp.float32)
    ta = torch.tensor(a, dtype=torch.float32)
    tb = torch.tensor(b, dtype=torch.float32)
    _same(getattr(jds, op)(ja, jb), getattr(tds, op)(ta, tb))


def test_f32_operand_forms_bitwise_jax_eager():
    """ds_add_f32 and ds_mul_f32 with a tensor and with a constant: a
    Python float is split in f32, as JAX splits a numpy f32 scalar."""
    a, b = _pair_inputs(3)
    ja = jds.ds_from_f64(jnp.asarray(a))
    ta = tds.ds_from_f64(torch.tensor(a))
    jb = jnp.asarray(b, dtype=jnp.float32)
    tb = torch.tensor(b, dtype=torch.float32)
    _same(jds.ds_add_f32(*ja, jb), tds.ds_add_f32(*ta, tb))
    _same(jds.ds_mul_f32(*ja, jb), tds.ds_mul_f32(*ta, tb))
    for c in (0.1, -2.0, 1.0 / 3.0, 4097.5):
        _same(jds.ds_mul_f32(*ja, np.float32(c)),
              tds.ds_mul_f32(*ta, tds.f32(c)))
        _same(jds.ds_add_f32(*ja, np.float32(c)),
              tds.ds_add_f32(*ta, tds.f32(c)))


@pytest.mark.parametrize("op", ["ds_sin", "ds_cos"])
def test_trig_bitwise_jax_eager_and_accurate(op):
    x = np.random.default_rng(0).uniform(-14.0, 14.0, size=N)
    j = getattr(jds, op)(*jds.ds_from_f64(jnp.asarray(x)))
    t = getattr(tds, op)(*tds.ds_from_f64(torch.tensor(x)))
    _same(j, t)
    want = np.sin(x) if op == "ds_sin" else np.cos(x)
    assert np.abs(tds.ds_to_f64(*t).numpy() - want).max() < 5e-14


def test_division_accuracy():
    a, b = _pair_inputs()
    q = tds.ds_div(*tds.ds_from_f64(torch.tensor(a)),
                   *tds.ds_from_f64(torch.tensor(b)))
    rel = np.abs(tds.ds_to_f64(*q).numpy() - a / b) / np.abs(a / b)
    assert rel.max() < 5e-14


def test_exactness_and_accuracy_against_f64():
    """tests/test_rk_ds.py's bounds: TwoSum and TwoProd exact, the pair
    round trip within 4e-15, the sum within 3e-14, the product 3e-13."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.normal(size=256), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=256) * 1e-5, dtype=torch.float32)
    s, e = tds.two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(),
                                  a.double() + b.double())
    p, e = tds.two_prod(a, a * 3.7)
    np.testing.assert_array_equal(p.double() + e.double(),
                                  a.double() * (a * 3.7).double())
    x = torch.tensor(rng.normal(size=128), dtype=torch.float64)
    y = torch.tensor(rng.normal(size=128) * 1e-9, dtype=torch.float64)
    xp, yp = tds.ds_from_f64(x), tds.ds_from_f64(y)
    np.testing.assert_allclose(tds.ds_to_f64(*xp), x, rtol=4e-15)
    np.testing.assert_allclose(tds.ds_to_f64(*tds.ds_add(*xp, *yp)), x + y,
                               rtol=3e-14)
    np.testing.assert_allclose(tds.ds_to_f64(*tds.ds_mul(*xp, *yp)), x * y,
                               rtol=3e-13)


def test_eager_torch_keeps_the_ds_floor_where_jitted_xla_does_not():
    """The canary: eager torch on the CPU keeps the aliased product at the
    ds floor; the JAX package's jitted one on the CPU does not (which is
    why the JAX side of these tests runs eagerly)."""
    assert tds.backend_preserves_ds("cpu") is True
    assert jds.backend_preserves_ds() is False


def _hex_floats(text, name):
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    vals = re.findall(r"(-?0x[0-9a-f.]+p[+-]\d+|0\.0)f", body)
    return [float.fromhex(v) for v in vals]


def test_the_cuda_header_holds_the_same_constants():
    text = (rk_cuda.CSRC / "ds32.cuh").read_text()
    for name, coefs in (("kSinCoefs", tds._SIN_COEFS),
                        ("kCosCoefs", tds._COS_COEFS)):
        want = [v for c in coefs for v in tds._ds_const(c)]
        assert _hex_floats(text, name) == want
    for name, val in (("kTwoOverPi", tds._TWO_OVER_PI),
                      ("kPio2C1", tds._PIO2_C1), ("kPio2C2", tds._PIO2_C2),
                      ("kPio2C3", tds._PIO2_C3)):
        lit = re.search(name + r" = (-?0x[0-9a-f.]+p[+-]\d+)f;", text)
        assert float.fromhex(lit.group(1)) == val, name
    # and the JAX package's f32 values
    assert tds._PIO2_C3 == float(np.float32(jds._PIO2_C3))
    assert tds._TWO_OVER_PI == float(np.float32(jds._TWO_OVER_PI))
