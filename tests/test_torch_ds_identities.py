"""The exact identities the double-single kernel (csrc/ds32.cuh,
csrc/ds_fanout.cu) rests on to take fewer operations than its plain
version (``nngparareal_torch/ops/ds32.py``) and still give its bits.

Each is checked on the plain version's own functions on the CPU, with
seeded inputs over signs and exponents (and ``hypothesis`` where it is
installed):

* TwoProd's error term by one FMA, ``e = fma(a, b, -p)``: emulated as
  ``f32(f64(a) * f64(b) - f64(p))``, which rounds once only, and nothing,
  because the error of an f32 product is exact in f64 and in f32;
* an exact scaling by a power of two: ``ds_div(x, (2, 0))`` and
  ``ds_mul(x, (s, 0))``, ``ds_mul_f32(x, s)`` are both parts times 1/2 or
  s (the [-1,1] map's halving, FHN-PDE's and DblPend's doubling,
  Burgers' -2, Brusselator's 4, ThomasLabyrinth's -0.5);
* a division by a divisor fixed for the launch: from yi = RN(1/y), q =
  RN(z * yi) and then one or two corrections r = fma(-q, y, z), q =
  fma(r, yi, q) give the correctly rounded quotient, checked against it
  with exact rationals (``fractions.Fraction``), for each divisor of the
  fields: one correction for FHN's 3 (provably enough), two for the
  others;
* the lanes of DblPend and ThomasLabyrinth need no padding (each runs a
  whole reduction on its own argument), only the scalings above.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from nngparareal_torch.ops import ds32

N = 20000


def f32s(seed, n=N, lo=-40, hi=40):
    """Seeded f32 values: random signs, exponents in [lo, hi], powers of
    two and zeros among them."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n)
         * 2.0 ** rng.integers(lo, hi + 1, n)).astype(np.float32)
    x[: n // 50] = (2.0 ** rng.integers(lo, hi + 1, n // 50)).astype(
        np.float32)
    x[n // 50: n // 25] = 0.0
    return x


def fma_error(a, b):
    """The FMA form's error term of a * b, emulated exactly."""
    p = (a * b).astype(np.float32)
    return (a.astype(np.float64) * b.astype(np.float64)
            - p.astype(np.float64)).astype(np.float32)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_fma_two_prod_is_dekkers():
    a, b = f32s(1), f32s(2)
    p, e = ds32.two_prod(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(bits(p.numpy()), bits(a * b))
    np.testing.assert_array_equal(bits(e.numpy()), bits(fma_error(a, b)))


def test_fma_two_prod_is_dekkers_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    # |a|, |b| below 2^60 (no overflow in the split or the product) and
    # the product's error in the normal range (|a * b| >= 2^-90)
    finite = st.floats(min_value=-2.0 ** 60, max_value=2.0 ** 60,
                       width=32, allow_nan=False, allow_infinity=False,
                       allow_subnormal=False)

    @hyp.settings(max_examples=300, deadline=None, derandomize=True)
    @hyp.given(finite, finite)
    def check(a, b):
        if a * b != 0.0 and abs(a * b) < 2.0 ** -90:
            return
        av = np.array([a], np.float32)
        bv = np.array([b], np.float32)
        _, e = ds32.two_prod(torch.tensor(av), torch.tensor(bv))
        assert bits(e.numpy()) == bits(fma_error(av, bv))

    check()


def pairs(seed, n=N):
    """Normalised (hi, lo) pairs of seeded f64 values, |x| in [1e-3, 1e3]
    with both signs."""
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-3.0, 3.0, n)
    return ds32.ds_from_f64(torch.tensor(x))


def test_halving_is_ds_div_by_two():
    xh, xl = pairs(3)
    two, zero = torch.full_like(xh, 2.0), torch.zeros_like(xh)
    qh, ql = ds32.ds_div(xh, xl, two, zero)
    np.testing.assert_array_equal(bits(qh.numpy()), bits((xh * 0.5).numpy()))
    np.testing.assert_array_equal(bits(ql.numpy()), bits((xl * 0.5).numpy()))


@pytest.mark.parametrize("s", [2.0, -2.0, 4.0, -0.5])
def test_power_of_two_scaling_is_ds_mul(s):
    xh, xl = pairs(4)
    sh, zero = torch.full_like(xh, s), torch.zeros_like(xh)
    for ph, pl in (ds32.ds_mul(xh, xl, sh, zero),
                   ds32.ds_mul(sh, zero, xh, xl), ds32.ds_mul_f32(xh, xl, s)):
        np.testing.assert_array_equal(bits(ph.numpy()),
                                      bits((xh * s).numpy()))
        np.testing.assert_array_equal(bits(pl.numpy()),
                                      bits((xl * s).numpy()))


def round_f32(x):
    """The f32 nearest the rational x, ties to even (normal range)."""
    if x == 0:
        return 0.0
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    elif Fraction(2) ** (e + 1) <= a:
        e += 1
    ulp = Fraction(2) ** (e - 23)
    m = a / ulp
    n = m.numerator // m.denominator
    rest = m - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return float(n * ulp) * (1.0 if x > 0 else -1.0)


def div_by(z, y, corrections):
    """csrc/ds32.cuh:div_by, every rounding exact: q = RN(z * yi), then
    r = RN(z - q*y) and q = RN(q + r*yi), each FMA rounded once."""
    z, y = Fraction(z), Fraction(y)
    yi = Fraction(round_f32(1 / y))
    q = Fraction(round_f32(z * yi))
    for _ in range(corrections):
        r = Fraction(round_f32(z - q * y))
        q = Fraction(round_f32(q + r * yi))
    return float(q)


# the divisors fixed for a launch, as the kernel takes them (the f32 high
# part of each constant's pair): FHN's 3; Hopf's maxtime (the default
# tspan's 500, and 100); FHN-PDE's squared spacings (2 / (d_x - 1))^2 at
# d_x = 4, 8, 16, 32
DIVISORS = {3.0: 1, 500.0: 2, 100.0: 2,
            **{(2.0 / (n - 1)) ** 2: 2 for n in (4, 8, 16, 32)}}


@pytest.mark.parametrize("y", list(DIVISORS))
def test_division_by_a_fixed_divisor_is_correctly_rounded(y):
    """The corrections the kernel uses for y give RN(z / y) on every
    dividend: the dividends of ds_div (a value, then its two remainders,
    ~2^-24 and ~2^-48 smaller), both signs, exponents +-40."""
    yh = float(np.float32(y))
    z = f32s(5, n=1500)
    z = z[z != 0.0]
    want = [round_f32(Fraction(float(v)) / Fraction(yh)) for v in z]
    got = [div_by(float(v), yh, DIVISORS[y]) for v in z]
    assert got == want
    # and as torch divides f32 tensors (correctly rounded)
    t = (torch.tensor(z) / torch.tensor(np.float32(yh))).numpy()
    np.testing.assert_array_equal(bits(t), bits(np.array(want, np.float32)))


def test_one_correction_suffices_for_three():
    """For y = 3 the first quotient is within an ulp of z / y, since
    3 * RN(1/3) = 1 + 2^-25 moves it by less than half an ulp; by
    Markstein's theorem one correction then rounds correctly. Another
    divisor's first quotient may be 1.5 ulp off, and the kernel gives it
    two corrections, the theorem's premise after the first."""
    assert 3 * Fraction(round_f32(Fraction(1, 3))) == 1 + Fraction(1, 2 ** 25)
    assert DIVISORS[3.0] == 1
    assert all(c == 2 for y, c in DIVISORS.items() if y != 3.0)
