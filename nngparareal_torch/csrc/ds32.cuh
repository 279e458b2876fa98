// Double-single (f32 pair) arithmetic on the card: the operations of
// nngparareal_torch/ops/ds32.py (the JAX package's ops/ds32.py), value for
// value.
//
// A ds value is an unevaluated sum hi + lo of two floats with
// |lo| <= ulp(hi)/2, about 48 bits of mantissa. Its error terms (TwoSum's,
// TwoProd's) are exact only if every float operation is rounded on its own:
// nvcc's default -fmad=true would contract pe + xh*yl in the product and
// pl + kh*cl in the RK update into FMAs and change the values the method
// rests on. So every operation here is an intrinsic that is never
// contracted (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: IEEE round to
// nearest even), in the order of the torch functions of the same names;
// torch rounds each eager f32 operation the same way on the CPU and on the
// card. Negation is exact. rintf rounds half to even, as torch.round and
// jnp.round do.
//
// Where the card has an exact shortcut, the kernel takes it, and the bits
// stay those of the plain version (tests/test_torch_ds_identities.py and
// tests/test_torch_ds32_host.py hold each one):
//   * TwoProd's error term is one fused multiply-add, e = fma(a, b, -p):
//     the error of a rounded product is a float, so the FMA rounds nothing.
//     ops/ds32.py (JAX has no guaranteed FMA) takes it from Dekker's
//     Veltkamp split, 17 operations, which gives the same e as long as the
//     split does not overflow (|a|, |b| < 2^115) and e is not below the
//     normal range (|e| >= 2^-126): far outside the fields' magnitudes;
//   * a product with a power of two (ds_pow2) scales both parts, which is
//     what ds_mul by the pair (2^k, 0) and ds_div by (2, 0) give for a
//     normalised pair;
//   * a division by a divisor fixed for the launch (ds_div_by) divides its
//     three floats by y.hi in straight-line code: the quotient through the
//     divisor's reciprocal and FMA corrections (div_by), the correctly
//     rounded quotient that __fdiv_rn gives after a branch to its slow path.
//
// The constants are the JAX package's f32 values, bit for bit, as hex
// literals (tests/test_torch_ds32.py holds them against ops/ds32.py).
#pragma once

#include <cuda_runtime.h>

namespace ds {

struct Ds {
    float hi, lo;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Exact a + b = s + e with s = fl(a + b); Knuth, branch-free.
__device__ __forceinline__ Ds two_sum(float a, float b)
{
    const float s = add(a, b);
    const float v = sub(s, a);
    return {s, add(sub(a, sub(s, v)), sub(b, v))};
}

// Exact a + b = s + e assuming |a| >= |b| (Dekker).
__device__ __forceinline__ Ds fast_two_sum(float a, float b)
{
    const float s = add(a, b);
    return {s, sub(b, sub(s, a))};
}

// Exact a * b = p + e: e, the error of the rounded product, is a float
// (see the note at the top), so one FMA gives it exactly.
__device__ __forceinline__ Ds two_prod(float a, float b)
{
    const float p = mul(a, b);
    return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ Ds from_f64(double x)
{
    const float hi = __double2float_rn(x);
    return {hi, __double2float_rn(__dsub_rn(x, (double)hi))};
}

__device__ __forceinline__ double to_f64(Ds x)
{
    return __dadd_rn((double)x.hi, (double)x.lo);
}

__device__ __forceinline__ Ds neg(Ds x) { return {-x.hi, -x.lo}; }

// x where c holds, else y, and x negated where c holds (neg's bits), in bit
// operations: no branch. Where c differs between the lanes of a warp (a
// quadrant, or which lane a thread is), a branch would split the warp and
// fence the scheduling of the code around it.
__device__ __forceinline__ float pick(bool c, float x, float y)
{
    const unsigned m = 0u - (unsigned)c;
    return __uint_as_float((__float_as_uint(x) & m)
                           | (__float_as_uint(y) & ~m));
}

__device__ __forceinline__ Ds pick(bool c, Ds x, Ds y)
{
    return {pick(c, x.hi, y.hi), pick(c, x.lo, y.lo)};
}

__device__ __forceinline__ Ds neg_if(bool c, Ds x)
{
    const unsigned sign = (unsigned)c << 31;
    return {__uint_as_float(__float_as_uint(x.hi) ^ sign),
            __uint_as_float(__float_as_uint(x.lo) ^ sign)};
}

__device__ __forceinline__ Ds ds_add(Ds x, Ds y)
{
    const Ds s = two_sum(x.hi, y.hi);
    return fast_two_sum(s.hi, add(s.lo, add(x.lo, y.lo)));
}

__device__ __forceinline__ Ds ds_add_f32(Ds x, float y)
{
    const Ds s = two_sum(x.hi, y);
    return fast_two_sum(s.hi, add(s.lo, x.lo));
}

__device__ __forceinline__ Ds ds_sub(Ds x, Ds y) { return ds_add(x, neg(y)); }

__device__ __forceinline__ Ds ds_mul(Ds x, Ds y)
{
    const Ds p = two_prod(x.hi, y.hi);
    return fast_two_sum(p.hi, add(p.lo, add(mul(x.hi, y.lo), mul(x.lo, y.hi))));
}

__device__ __forceinline__ Ds ds_mul_f32(Ds x, float y)
{
    const Ds p = two_prod(x.hi, y);
    return fast_two_sum(p.hi, add(p.lo, mul(x.lo, y)));
}

// Bailey's long division with two remainder corrections; div(z) is the
// float z / y.hi rounded to nearest.
template <class Div>
__device__ __forceinline__ Ds long_div(Ds x, Ds y, Div div)
{
    const float q1 = div(x.hi);
    Ds r = ds_sub(x, ds_mul_f32(y, q1));
    const float q2 = div(r.hi);
    r = ds_sub(r, ds_mul_f32(y, q2));
    const float q3 = div(r.hi);
    return ds_add_f32(fast_two_sum(q1, q2), q3);
}

// x / y for a y that changes from call to call: __fdiv_rn, whose check
// branches to a slow path.
__device__ __forceinline__ Ds ds_div(Ds x, Ds y)
{
    return long_div(x, y, [&](float z) { return __fdiv_rn(z, y.hi); });
}

// z / y rounded to nearest from yi = RN(1/y): q = z * yi, then
// `Corrections` times r = z - q*y (exact in one FMA once q is within an ulp
// of z/y) and q = q + r*yi rounded. By Markstein's theorem the correction
// of a q within an ulp gives the correctly rounded quotient, barring
// overflow and underflow. For y = 3 the first q is already within an ulp
// (3 * RN(1/3) = 1 + 2^-25), so one correction suffices; another y takes
// two (tests/test_torch_ds_identities.py checks both with exact rationals).
template <int Corrections>
__device__ __forceinline__ float div_by(float z, float y, float yi)
{
    float q = mul(z, yi);
#pragma unroll
    for (int c = 0; c < Corrections; ++c) {
        const float r = __fmaf_rn(-q, y, z);
        q = __fmaf_rn(r, yi, q);
    }
    return q;
}

// A divisor fixed for a launch: its pair, and the reciprocal of its high
// part, RN(1/y.hi), formed once on the card before the step loop.
struct Divisor {
    Ds y;
    float yi;
};

__device__ __forceinline__ Divisor divisor(Ds y)
{
    return {y, __frcp_rn(y.hi)};
}

// ds_div(x, d.y) without a branch: the same three quotients by div_by.
template <int Corrections>
__device__ __forceinline__ Ds ds_div_by(Ds x, const Divisor& d)
{
    return long_div(x, d.y, [&](float z) {
        return div_by<Corrections>(z, d.y.hi, d.yi);
    });
}

// x * s for a power of two s, both parts scaled exactly: the value of
// ds_mul(x, (s, 0)), and for s = 1/2 of ds_div(x, (2, 0)), for a
// normalised x (barring overflow and underflow).
__device__ __forceinline__ Ds ds_pow2(Ds x, float s)
{
    return {mul(x.hi, s), mul(x.lo, s)};
}

// u + c * k with a ds scalar c (ops/rk_ds.py:ds_axpy).
__device__ __forceinline__ Ds ds_axpy(Ds u, Ds c, Ds k)
{
    const Ds p = ds_mul_f32(k, c.hi);
    return ds_add(u, fast_two_sum(p.hi, add(p.lo, mul(k.hi, c.lo))));
}

// x * c for an f64 constant c split into a pair (ops/rk_ds.py:_ds_scale).
__device__ __forceinline__ Ds ds_scale(Ds x, Ds c)
{
    const Ds p = ds_mul_f32(x, c.hi);
    return fast_two_sum(p.hi, add(p.lo, mul(x.hi, c.lo)));
}

// --- sin and cos: Cody-Waite reduction to |r| <= pi/4, ds Taylor ---------

constexpr float kTwoOverPi = 0x1.45f306p-1f;
constexpr float kPio2C1 = 0x1.922p+0f;
constexpr float kPio2C2 = -0x1.2aep-18f;
constexpr float kPio2C3 = -0x1.de974p-31f;

// 1/(2k+1)! and 1/(2k)! as (hi, lo) pairs, lowest order first
__constant__ Ds kSinCoefs[7] = {
    {-0x1.555556p-3f, 0x1.555556p-28f},  // -0.16666666666666666
    {0x1.111112p-7f, -0x1.dddddep-32f},  // 0.008333333333333333
    {-0x1.a01a02p-13f, 0x1.7f97fap-39f},  // -0.0001984126984126984
    {0x1.71de3ap-19f, 0x1.55b1ccp-45f},  // 2.7557319223985893e-06
    {-0x1.ae6456p-26f, -0x1.fd5138p-52f},  // -2.505210838544172e-08
    {0x1.612462p-33f, -0x1.8af25ep-58f},  // 1.6059043836821613e-10
    {-0x1.ae7f3ep-41f, -0x1.ccee08p-67f},  // -7.647163731819816e-13
};
__constant__ Ds kCosCoefs[8] = {
    {-0x1p-1f, 0.0f},  // -0.5
    {0x1.555556p-5f, -0x1.555556p-30f},  // 0.041666666666666664
    {-0x1.6c16c2p-10f, 0x1.27d27ep-35f},  // -0.001388888888888889
    {0x1.a01a02p-16f, -0x1.7f97fap-42f},  // 2.48015873015873e-05
    {-0x1.27e4fcp-22f, 0x1.10ec14p-47f},  // -2.755731922398589e-07
    {0x1.1eed8ep-29f, 0x1.ff1b14p-54f},  // 2.08767569878681e-09
    {-0x1.93974ap-37f, -0x1.180f94p-62f},  // -1.1470745597729725e-11
    {0x1.ae7f3ep-45f, 0x1.ccee08p-71f},  // 4.779477332387385e-14
};

// Horner evaluation of sum_k c[k] * (r^2)^k in ds, highest first.
template <int N>
__device__ __forceinline__ Ds poly(Ds r2, const Ds (&c)[N])
{
    Ds p = c[N - 1];
#pragma unroll
    for (int k = N - 2; k >= 0; --k) {
        p = ds_mul(p, r2);
        const Ds s = two_sum(p.hi, c[k].hi);
        p = fast_two_sum(s.hi, add(s.lo, add(p.lo, c[k].lo)));
    }
    return p;
}

// sin(x) and cos(x) from one reduction (ds32.py:_sin_cos_reduced and
// _quadrant_select): the values that ds_sin and ds_cos give.
__device__ __forceinline__ void sin_cos(Ds x, Ds& sin_x, Ds& cos_x)
{
    const float n = rintf(mul(x.hi, kTwoOverPi));
    Ds r = ds_add_f32(x, mul(-n, kPio2C1));
    r = ds_add_f32(r, mul(-n, kPio2C2));
    r = ds_sub(r, two_prod(n, kPio2C3));
    const Ds r2 = ds_mul(r, r);
    const Ds s = ds_add(r, ds_mul(ds_mul(poly(r2, kSinCoefs), r2), r));
    const Ds c = ds_add_f32(ds_mul(poly(r2, kCosCoefs), r2), 1.0f);
    const int q = (int)n & 3;
    // sin: q = 0 sin, 1 cos, 2 -sin, 3 -cos; cos is sin at q + 1. Without
    // a branch: each slice has its own quadrant.
    sin_x = neg_if(q & 2, pick(q & 1, c, s));
    cos_x = neg_if((q + 1) & 2, pick(q & 1, s, c));
}

}  // namespace ds
