"""Double-single (f32 pair) compensated arithmetic in torch.

Port of ``nngparareal_tpu/ops/ds32.py``. A double-single ("ds") number is
an unevaluated sum hi + lo of two f32 values with |lo| <= ulp(hi)/2: about
48 bits of mantissa, about 1e-14 relative, from f32 operations alone.

The algorithms, constants and order of operations are the JAX package's,
op for op: Knuth's TwoSum, Dekker's split and TwoProd (no FMA: the error
term of a product is taken from the exact Veltkamp split), renormalised
add and multiply after Hida, Li and Bailey's double-double kernels with
one correction term, Bailey's long division with two remainder
corrections, and Cody-Waite reduced sin and cos with ds Taylor
polynomials.

Every function here is eager torch: each operation is its own rounded
f32 operation on the tensors' device, never contracted into an FMA. Two
rules keep the card's results those of the CPU:

* every operand is an f32 tensor or a Python float that f32 holds
  exactly (``f32`` rounds a constant to it);
* a division divides by a tensor on the dividend's device, never by a
  Python scalar or a 0-dim CPU tensor: torch on a card turns such a
  division into a product with the rounded reciprocal, and ``ds_div``
  rests on the correctly rounded quotient.

The CUDA kernel (csrc/ds32.cuh) repeats these operations with
``__fadd_rn`` and its kin, which are never contracted either.
"""

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1, Veltkamp split constant for f32 (24-bit mantissa)


def f32(x):
    """The Python float of ``x`` rounded to f32."""
    return float(np.float32(x))


def _divisor(y, like):
    """``y`` as an f32 tensor on ``like``'s device (see the module's
    note on division)."""
    if isinstance(y, torch.Tensor) and y.device == like.device:
        return y
    return torch.as_tensor(y, dtype=torch.float32, device=like.device)


def two_sum(a, b):
    """Exact a + b = s + e with s = fl(a + b); Knuth, branch-free."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = s + e assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo each 12-bit exact. A Python
    float is split in f32 arithmetic too (numpy f32 scalars), not in the
    host's double."""
    if not isinstance(a, torch.Tensor):
        a = np.float32(a)
        t = np.float32(_SPLIT) * a
        hi = t - (t - a)
        return float(hi), float(a - hi)
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact a * b = p + e via Dekker's algorithm (no FMA needed)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


# --- double-single (hi, lo) kernels ------------------------------------


def ds_from_f64(x):
    """Split an f64 tensor into a (hi, lo) f32 pair."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def ds_to_f64(hi, lo):
    return hi.to(torch.float64) + lo.to(torch.float64)


def ds_add(xh, xl, yh, yl):
    """(x + y) renormalised; both low parts ride TwoSum."""
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def ds_add_f32(xh, xl, y):
    """(x + y) with plain-f32 y."""
    sh, se = two_sum(xh, y)
    return fast_two_sum(sh, se + xl)


def ds_mul(xh, xl, yh, yl):
    """(x * y) renormalised; Dekker product + cross terms."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def ds_mul_f32(xh, xl, y):
    """(x * y) with plain-f32 y."""
    ph, pe = two_prod(xh, y)
    pe = pe + xl * y
    return fast_two_sum(ph, pe)


def ds_neg(xh, xl):
    return -xh, -xl


def ds_sub(xh, xl, yh, yl):
    return ds_add(xh, xl, -yh, -yl)


def ds_div(xh, xl, yh, yl):
    """(x / y) by iterated-correction long division (Bailey): two
    remainder corrections keep the relative error at the ds floor. The
    three quotients divide by ``yh`` as a tensor on x's device."""
    yd = _divisor(yh, xh)
    q1 = xh / yd
    p1h, p1l = ds_mul_f32(yh, yl, q1)
    rh, rl = ds_sub(xh, xl, p1h, p1l)
    q2 = rh / yd
    p2h, p2l = ds_mul_f32(yh, yl, q2)
    rh, rl = ds_sub(rh, rl, p2h, p2l)
    q3 = rh / yd
    qh, ql = fast_two_sum(q1, q2)
    return ds_add_f32(qh, ql, q3)


# --- trigonometry ---------------------------------------------------------
#
# The hardware f32 sin and cos are only ~1e-7 accurate, far off the ds
# floor, so both are computed from scratch: Cody-Waite range reduction
# with three f32 constants whose products with the (small-integer)
# quadrant count are exact, then ds Horner Taylor polynomials on
# |r| <= pi/4. Every constant is the JAX package's f32 value.

_TWO_OVER_PI = f32(0.63661977236758134308)
# pi/2 = C1 + C2 + C3 with C1, C2 carrying <= 12 significant bits each so
# n * C1 and n * C2 are exact in f32 for quadrant counts |n| < 2^12
_PIO2_C1 = f32(1.57080078125e00)
_PIO2_C2 = f32(-4.45358455181121826e-06)
_PIO2_C3 = f32(-8.70551630782756547e-10)


def _ds_const(v):
    """The (hi, lo) f32 pair of an f64 constant, as Python floats."""
    hi = np.float32(v)
    lo = np.float32(v - float(hi))
    return float(hi), float(lo)


_SIN_COEFS = [  # sin(r) = r * (1 + r^2*(c1 + r^2*(c2 + ...)))
    -1.0 / 6.0, 1.0 / 120.0, -1.0 / 5040.0, 1.0 / 362880.0,
    -1.0 / 39916800.0, 1.0 / 6227020800.0, -1.0 / 1307674368000.0,
]
_COS_COEFS = [  # cos(r) = 1 + r^2*(c1 + r^2*(c2 + ...))
    -0.5, 1.0 / 24.0, -1.0 / 720.0, 1.0 / 40320.0, -1.0 / 3628800.0,
    1.0 / 479001600.0, -1.0 / 87178291200.0, 1.0 / 20922789888000.0,
]


def _ds_poly(r2h, r2l, coefs):
    """Horner evaluation sum_k coefs[k] * (r^2)^k in ds, highest first."""
    ch, cl = _ds_const(coefs[-1])
    ph = torch.full_like(r2h, ch)
    pl = torch.full_like(r2h, cl)
    for c in reversed(coefs[:-1]):
        ph, pl = ds_mul(ph, pl, r2h, r2l)
        ch, cl = _ds_const(c)
        sh, se = two_sum(ph, ch)
        ph, pl = fast_two_sum(sh, se + (pl + cl))
    return ph, pl


def _sin_cos_reduced(xh, xl):
    """(sin, cos, quadrant) after Cody-Waite reduction to |r| <= pi/4."""
    n = torch.round(xh * _TWO_OVER_PI)  # half to even, as jnp.round
    rh, rl = ds_add_f32(xh, xl, -n * _PIO2_C1)
    rh, rl = ds_add_f32(rh, rl, -n * _PIO2_C2)
    # n*C3 is not exact; feed its ds product in full
    p3h, p3l = two_prod(n, torch.full_like(n, _PIO2_C3))
    rh, rl = ds_sub(rh, rl, p3h, p3l)
    r2h, r2l = ds_mul(rh, rl, rh, rl)
    # sin(r) = r + r^3 * S(r^2)
    sh_, sl_ = _ds_poly(r2h, r2l, _SIN_COEFS)
    sh_, sl_ = ds_mul(sh_, sl_, r2h, r2l)
    sh_, sl_ = ds_mul(sh_, sl_, rh, rl)
    sin_h, sin_l = ds_add(rh, rl, sh_, sl_)
    # cos(r) = 1 + r^2 * C(r^2)
    ch_, cl_ = _ds_poly(r2h, r2l, _COS_COEFS)
    ch_, cl_ = ds_mul(ch_, cl_, r2h, r2l)
    cos_h, cos_l = ds_add_f32(ch_, cl_, 1.0)
    q = n.to(torch.int32) & 3
    return (sin_h, sin_l), (cos_h, cos_l), q


def _quadrant_select(q, a, b):
    """Pick (sin-like, cos-like) values per quadrant for sin(x)."""
    (s_h, s_l), (c_h, c_l) = a, b
    # q==0: sin;  q==1: cos;  q==2: -sin;  q==3: -cos
    h = torch.where(q == 0, s_h, torch.where(q == 1, c_h,
                    torch.where(q == 2, -s_h, -c_h)))
    l = torch.where(q == 0, s_l, torch.where(q == 1, c_l,
                    torch.where(q == 2, -s_l, -c_l)))
    return h, l


def ds_sin(xh, xl):
    s, c, q = _sin_cos_reduced(xh, xl)
    return _quadrant_select(q, s, c)


def ds_cos(xh, xl):
    s, c, q = _sin_cos_reduced(xh, xl)
    # cos(x) = sin(x + pi/2): shift the quadrant
    return _quadrant_select((q + 1) & 3, s, c)


def backend_preserves_ds(device="cpu"):
    """True when eager torch on ``device`` keeps the ds floor: the aliased
    product ``ds_mul(a, b, a, b)``, the case that XLA:CPU collapses under
    ``jit`` in the JAX package, must stay within 1e-12 of the f64 square.
    A test helper: no path of the port routes on it."""
    x = torch.linspace(0.1, 0.9, 64, dtype=torch.float64, device=device)
    xh, xl = ds_from_f64(x)
    oh, ol = ds_mul(xh, xl, xh, xl)
    err = (ds_to_f64(oh, ol) - x * x).abs().max().item()
    return bool(err < 1e-12)
