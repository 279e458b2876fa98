// Double-single (f32 pair) arithmetic on the card: the operations of
// nngparareal_torch/ops/ds32.py (the JAX package's ops/ds32.py), op for op.
//
// A ds value is an unevaluated sum hi + lo of two floats with
// |lo| <= ulp(hi)/2, about 48 bits of mantissa. Its error terms (TwoSum's,
// Dekker's TwoProd's) are exact only if every float operation is rounded
// on its own: nvcc's default -fmad=true would contract a*b - p in TwoProd,
// pe + xh*yl in the product and pl + kh*cl in the RK update into FMAs and
// change the error terms the method rests on. So every operation here is
// an intrinsic that is never contracted (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn: IEEE round to nearest even), in the order of the torch
// functions of the same names; torch rounds each eager f32 operation the
// same way on the CPU and on the card. Negation is exact. rintf rounds
// half to even, as torch.round and jnp.round do.
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

// Veltkamp split: a = hi + lo with hi, lo each 12-bit exact.
__device__ __forceinline__ Ds split(float a)
{
    const float t = mul(4097.0f, a);
    const float hi = sub(t, sub(t, a));
    return {hi, sub(a, hi)};
}

// Exact a * b = p + e via Dekker's algorithm (no FMA).
__device__ __forceinline__ Ds two_prod(float a, float b)
{
    const float p = mul(a, b);
    const Ds as = split(a);
    const Ds bs = split(b);
    const float e = add(add(add(sub(mul(as.hi, bs.hi), p), mul(as.hi, bs.lo)),
                            mul(as.lo, bs.hi)),
                        mul(as.lo, bs.lo));
    return {p, e};
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

// Bailey's long division with two remainder corrections.
__device__ __forceinline__ Ds ds_div(Ds x, Ds y)
{
    const float q1 = __fdiv_rn(x.hi, y.hi);
    Ds r = ds_sub(x, ds_mul_f32(y, q1));
    const float q2 = __fdiv_rn(r.hi, y.hi);
    r = ds_sub(r, ds_mul_f32(y, q2));
    const float q3 = __fdiv_rn(r.hi, y.hi);
    return ds_add_f32(fast_two_sum(q1, q2), q3);
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
    // sin: q = 0 sin, 1 cos, 2 -sin, 3 -cos; cos is sin at q + 1
    sin_x = q == 0 ? s : q == 1 ? c : q == 2 ? neg(s) : neg(c);
    cos_x = q == 0 ? c : q == 1 ? neg(s) : q == 2 ? neg(c) : s;
}

}  // namespace ds
