"""The double-single kernel's arithmetic (``nngparareal_torch/csrc/
ds32.cuh``) built for the CPU with ``g++`` and held, bit for bit, to its
plain version (``nngparareal_torch/ops/ds32.py``, ``ops/rk_ds.py``).

The header is compiled as it is, with a stub ``cuda_runtime.h``:
``__device__`` and its kin defined empty, each intrinsic a plain IEEE
operation (``__fadd_rn`` an f32 add, ``__fmaf_rn`` ``std::fmaf``,
``__frcp_rn`` 1 / y, ``__fdiv_rn`` the f32 quotient), no contraction and
no fast math (``-O2 -ffp-contract=off -fno-fast-math``). The build runs
each operation of the header on seeded inputs; the same build counts the
f32 operations of each (every intrinsic and ``rintf``; a negation, a
conversion and a selection, ``pick`` or ``neg_if``, count none) and the
dependent operations from each input to the result, which ``chip_smoke.py``'s double-single bound
(``DS_OPS``, ``DS_DEPTH``) states in its own constants: the test holds
them to the source.

For the counting, the header's ``float`` is a float that carries its
depth (``F32``, by a macro around the ``#include``): its value is
computed by the same f32 operation as a bare float's. Whether ``g++``
exists is decided in a fixture; without it the tests skip.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from nngparareal_torch.ops import ds32, rk_ds
from nngparareal_torch.ops import rk_cuda

N = 4000

STUB = r"""
#pragma once
#include <cmath>
#include <cstring>

#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__

// An f32 value and the dependent operations behind it (kNone: none from
// the input being followed).
constexpr int kNone = -(1 << 20);
struct F32 {
    float v;
    int d;
    constexpr F32(float x = 0.0f) : v(x), d(kNone) {}
    constexpr F32(float x, int depth) : v(x), d(depth) {}
    explicit operator int() const { return (int)v; }
    explicit operator double() const { return (double)v; }
};

extern long long g_ops;

// A division weighs kDivWeight on the path (chip_smoke.py takes it at its own
// latency): a depth is operations + kDivWeight * divisions.
constexpr int kDivWeight = 1000;
inline int mx(int a, int b) { return a > b ? a : b; }
inline int dep(int a, int b, int w = 1) { return mx(a, b) + w; }
inline F32 operator-(F32 a) { return {-a.v, a.d}; }
inline F32 __fadd_rn(F32 a, F32 b) { ++g_ops; return {a.v + b.v, dep(a.d, b.d)}; }
inline F32 __fsub_rn(F32 a, F32 b) { ++g_ops; return {a.v - b.v, dep(a.d, b.d)}; }
inline F32 __fmul_rn(F32 a, F32 b) { ++g_ops; return {a.v * b.v, dep(a.d, b.d)}; }
inline F32 __fdiv_rn(F32 a, F32 b) { ++g_ops; return {a.v / b.v, dep(a.d, b.d, kDivWeight)}; }
inline F32 __frcp_rn(F32 a) { ++g_ops; return {1.0f / a.v, dep(a.d, kNone)}; }
inline F32 __fmaf_rn(F32 a, F32 b, F32 c)
{
    ++g_ops;
    return {std::fmaf(a.v, b.v, c.v), dep(mx(a.d, b.d), c.d)};
}
inline F32 ds_host_rintf(F32 a) { ++g_ops; return {std::nearbyint(a.v), dep(a.d, kNone)}; }
// a float's bits, carrying its depth through pick and neg_if
struct U32 {
    unsigned v;
    int d;
};
inline U32 __float_as_uint(F32 x)
{
    unsigned u;
    std::memcpy(&u, &x.v, sizeof u);
    return {u, x.d};
}
inline F32 __uint_as_float(U32 u)
{
    float f;
    std::memcpy(&f, &u.v, sizeof f);
    return {f, u.d};
}
inline U32 operator&(U32 a, unsigned m) { return {a.v & m, a.d}; }
inline U32 operator^(U32 a, unsigned m) { return {a.v ^ m, a.d}; }
inline U32 operator|(U32 a, U32 b) { return {a.v | b.v, mx(a.d, b.d)}; }
inline F32 __double2float_rn(double x) { return F32((float)x); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
"""

HARNESS = r"""
#include <cuda_runtime.h>

long long g_ops = 0;

#define rintf(x) ds_host_rintf(x)
#define float F32
#include "ds32.cuh"
#undef float
#undef rintf

using ds::Ds;

// The operations, by id: inputs and outputs are arrays of n floats each.
enum Op {
    kTwoProd, kAdd, kAddF32, kMul, kMulF32, kDiv, kDivBy1, kDivBy2, kPow2,
    kAxpy, kScale, kSinCos, kNumOps
};
constexpr int kIns[kNumOps] = {2, 4, 3, 4, 3, 4, 4, 4, 3, 6, 4, 2};
constexpr int kOuts[kNumOps] = {2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 4};

static void apply(int op, const F32* x, F32* y)
{
    const Ds a{x[0], x[1]};
    Ds r{}, r2{};
    switch (op) {
        case kTwoProd: r = ds::two_prod(x[0], x[1]); break;
        case kAdd: r = ds::ds_add(a, {x[2], x[3]}); break;
        case kAddF32: r = ds::ds_add_f32(a, x[2]); break;
        case kMul: r = ds::ds_mul(a, {x[2], x[3]}); break;
        case kMulF32: r = ds::ds_mul_f32(a, x[2]); break;
        case kDiv: r = ds::ds_div(a, {x[2], x[3]}); break;
        case kDivBy1:
        case kDivBy2: {
            // the divisor's reciprocal is formed before the step loop: not
            // counted, no depth
            const long long before = g_ops;
            ds::Divisor d{{x[2], x[3]}, F32(1.0f / x[2].v)};
            g_ops = before;
            r = op == kDivBy1 ? ds::ds_div_by<1>(a, d) : ds::ds_div_by<2>(a, d);
            break;
        }
        case kPow2: r = ds::ds_pow2(a, x[2]); break;
        case kAxpy: r = ds::ds_axpy(a, {x[2], x[3]}, {x[4], x[5]}); break;
        case kScale: r = ds::ds_scale(a, {x[2], x[3]}); break;
        case kSinCos: ds::sin_cos(a, r, r2); break;
    }
    y[0] = r.hi;
    y[1] = r.lo;
    y[2] = r2.hi;
    y[3] = r2.lo;
}

extern "C" {

// Runs `op` on n elements: in[i * n + j] is input i of element j, out the
// same for the outputs. Returns -1 for an unknown op.
int ds_host_run(int op, int n, const float* in, float* out)
{
    if (op < 0 || op >= kNumOps) {
        return -1;
    }
    for (int j = 0; j < n; ++j) {
        F32 x[6], y[4];
        for (int i = 0; i < kIns[op]; ++i) {
            x[i] = F32(in[i * n + j]);
        }
        apply(op, x, y);
        for (int i = 0; i < kOuts[op]; ++i) {
            out[i * n + j] = y[i].v;
        }
    }
    return 0;
}

// The f32 operations of one `op` on the inputs `in` (one element), and in
// depth[i] the dependent operations on the longest path from input i to
// an output (kNone: none).
long long ds_host_count(int op, const float* in, int* depth)
{
    F32 x[6], y[4];
    long long ops = -1;
    for (int i = 0; i < kIns[op]; ++i) {
        for (int k = 0; k < kIns[op]; ++k) {
            x[k] = F32(in[k], k == i ? 0 : kNone);
        }
        g_ops = 0;
        apply(op, x, y);
        ops = g_ops;
        int d = kNone;
        for (int k = 0; k < kOuts[op]; ++k) {
            d = y[k].d > d ? y[k].d : d;
        }
        depth[i] = d < 0 ? -1 : d;
    }
    return ops;
}
}
"""

OPS = ("two_prod", "add", "add_f32", "mul", "mul_f32", "div", "div_by1",
       "div_by2", "pow2", "axpy", "scale", "sin_cos")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The header built as a shared library for the CPU; skips without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header's host build needs it")
    tmp = tmp_path_factory.mktemp("ds32_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "harness.cpp").write_text(HARNESS)
    lib = tmp / "libds32_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(tmp),
                    "-I", str(rk_cuda.CSRC), "-o", str(lib),
                    str(tmp / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    fp = ctypes.POINTER(ctypes.c_float)
    so.ds_host_run.argtypes = [ctypes.c_int, ctypes.c_int, fp, fp]
    so.ds_host_count.argtypes = [ctypes.c_int, fp,
                                 ctypes.POINTER(ctypes.c_int)]
    so.ds_host_count.restype = ctypes.c_longlong
    return so


def run(host, op, *inputs):
    """The host build's outputs of ``op`` on f32 arrays of one length."""
    x = np.ascontiguousarray(np.stack(inputs), dtype=np.float32)
    n = x.shape[1]
    n_out = 4 if op == "sin_cos" else 2
    y = np.zeros((n_out, n), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = host.ds_host_run(OPS.index(op), n, x.ctypes.data_as(fp),
                          y.ctypes.data_as(fp))
    assert rc == 0
    return tuple(y)


def count(host, op, *inputs):
    """(f32 operations, dependent operations from each input) of one
    ``op`` on one element."""
    x = np.ascontiguousarray(inputs, dtype=np.float32)
    depth = (ctypes.c_int * 6)()
    ops = host.ds_host_count(OPS.index(op),
                             x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             depth)
    return ops, list(depth)[:len(inputs)]


def pairs(seed, n=N, lo=-5.0, hi=5.0):
    """(hi, lo) f32 parts of seeded f64 values with signs and exponents
    over the fields' range (|x| from 1e-3 to 1e3)."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-3.0, 3.0, n))
    h, l = ds32.ds_from_f64(torch.tensor(x))
    return h.numpy(), l.numpy()


def bits(*arrays):
    return [np.asarray(a, np.float32).view(np.uint32) for a in arrays]


def same(got, want):
    """Both parts equal, bit for bit."""
    for g, w in zip(bits(*got), bits(*[t.numpy() if isinstance(t, torch.Tensor)
                                       else t for t in want])):
        np.testing.assert_array_equal(g, w)


T = torch.tensor


@pytest.fixture(scope="module")
def ins():
    xh, xl = pairs(1)
    yh, yl = pairs(2)
    return xh, xl, yh, yl


def test_two_prod_bitwise(host, ins):
    xh, _, yh, _ = ins
    same(run(host, "two_prod", xh, yh), ds32.two_prod(T(xh), T(yh)))


@pytest.mark.parametrize("op", ["add", "mul", "div"])
def test_pair_operations_bitwise(host, ins, op):
    xh, xl, yh, yl = ins
    fn = getattr(ds32, f"ds_{op}")
    same(run(host, op, xh, xl, yh, yl), fn(T(xh), T(xl), T(yh), T(yl)))


@pytest.mark.parametrize("op", ["add_f32", "mul_f32"])
def test_f32_operand_forms_bitwise(host, ins, op):
    xh, xl, yh, _ = ins
    fn = getattr(ds32, f"ds_{op}")
    same(run(host, op, xh, xl, yh), fn(T(xh), T(xl), T(yh)))


# the divisors fixed for a launch: FHN's 3, Hopf's maxtime (its default
# tspan's end, and 100), FHN-PDE's squared spacings (2 / (d_x - 1))^2 at
# d_x = 4, 8, 16, 32, and the pair of 2 of the [-1,1] map
DIVISORS = (3.0, 500.0, 100.0, *[(2.0 / (n - 1)) ** 2 for n in (4, 8, 16, 32)])


@pytest.mark.parametrize("y", DIVISORS)
def test_division_by_a_fixed_divisor_is_ds_div(host, ins, y):
    """ds_div_by (two corrections; one for 3) gives ds_div's bits."""
    xh, xl, _, _ = ins
    yh, yl = (np.full(len(xh), v, np.float32)
              for v in ds32._ds_const(y))
    want = ds32.ds_div(T(xh), T(xl), T(yh), T(yl))
    same(run(host, "div_by2", xh, xl, yh, yl), want)
    if y == 3.0:
        same(run(host, "div_by1", xh, xl, yh, yl), want)


def test_pow2_is_the_product_with_the_pair(host, ins):
    """ds_pow2(x, s) is ds_mul(x, (s, 0)) for s = +-2, 4, -0.5, and
    ds_div(x, (2, 0)) for s = 1/2."""
    xh, xl, _, _ = ins
    n = len(xh)
    for s in (2.0, -2.0, 4.0, -0.5):
        sv, z = np.full(n, s, np.float32), np.zeros(n, np.float32)
        same(run(host, "pow2", xh, xl, sv),
             ds32.ds_mul(T(xh), T(xl), T(sv), T(z)))
    half = np.full(n, 0.5, np.float32)
    two, z = np.full(n, 2.0, np.float32), np.zeros(n, np.float32)
    same(run(host, "pow2", xh, xl, half),
         ds32.ds_div(T(xh), T(xl), T(two), T(z)))


def test_axpy_and_scale_bitwise(host, ins):
    xh, xl, yh, yl = ins
    # step coefficient pairs h * a_ij of the flagship's width
    c = np.random.default_rng(3).uniform(-1.0, 1.0, len(xh)) * 1.15e-6
    ch, cl = (a.numpy() for a in ds32.ds_from_f64(T(c)))
    same(run(host, "axpy", xh, xl, ch, cl, yh, yl),
         rk_ds.ds_axpy(T(xh), T(xl), T(ch), T(cl), T(yh), T(yl)))
    for const in (1.0 / 0.015625, 0.5 / (2 * 0.0472), 0.2, 5.7):
        kh, kl = ds32._ds_const(const)
        n = len(xh)
        same(run(host, "scale", xh, xl, np.full(n, kh, np.float32),
                 np.full(n, kl, np.float32)),
             rk_ds._ds_scale(T(xh), T(xl), const))


def test_sin_cos_bitwise(host):
    x = np.random.default_rng(0).uniform(-14.0, 14.0, N)
    h, l = (a.numpy() for a in ds32.ds_from_f64(T(x)))
    sh, sl, ch, cl = run(host, "sin_cos", h, l)
    same((sh, sl), ds32.ds_sin(T(h), T(l)))
    same((ch, cl), ds32.ds_cos(T(h), T(l)))


# each operation's inputs, grouped by the operand its depth is read from
GROUPS = {"two_prod": {"a": [0, 1]}, "add": {"x": [0, 1], "y": [2, 3]},
          "add_f32": {"x": [0, 1], "y": [2]},
          "mul": {"x": [0, 1], "y": [2, 3]},
          "mul_f32": {"x": [0, 1], "y": [2]},
          "div": {"x": [0, 1], "y": [2, 3]},
          "div_by1": {"x": [0, 1]}, "div_by2": {"x": [0, 1]},
          "pow2": {"x": [0, 1]}, "axpy": {"u": [0, 1], "k": [4, 5]},
          "scale": {"x": [0, 1]}, "sin_cos": {"x": [0, 1]}}
SAMPLE = {"two_prod": (1.3, -0.7), "add": (1.3, 1e-8, -0.7, 2e-9),
          "add_f32": (1.3, 1e-8, -0.7), "mul": (1.3, 1e-8, -0.7, 2e-9),
          "mul_f32": (1.3, 1e-8, -0.7), "div": (1.3, 1e-8, -0.7, 2e-9),
          "div_by1": (1.3, 1e-8, 3.0, 0.0),
          "div_by2": (1.3, 1e-8, 500.0, 0.0), "pow2": (1.3, 1e-8, 0.5),
          "axpy": (1.3, 1e-8, 1e-6, 1e-14, -0.7, 2e-9),
          "scale": (1.3, 1e-8, 64.0, 1e-7), "sin_cos": (1.3, 1e-8)}


@pytest.mark.parametrize("op", OPS)
def test_chip_smoke_counts_are_the_sources(host, op):
    """chip_smoke.py's DS_OPS (f32 operations of one ds operation) and
    DS_DEPTH (dependent operations from each operand to the result) are
    those of csrc/ds32.cuh; a division counts one operation and is
    listed apart (DS_DIVS)."""
    ops, depth = count(host, op, *SAMPLE[op])
    assert chip_smoke.DS_OPS[op] == ops
    got = {}
    for group, idx in GROUPS[op].items():
        d = max(depth[i] for i in idx)
        got[group] = f"{d % 1000}" + "d" * (d // 1000)
    assert chip_smoke.DS_DEPTH[op] == got


@pytest.mark.parametrize("kind", sorted(rk_cuda.ODE_DIMS))
def test_ds_field_traces_have_the_f64_fields_dependencies(kind):
    """chip_smoke.py's ds field expressions (``ds_field_trace``) read the
    same state coordinates for each component as the f64 kernel's hand
    count (``FIELD_DEPTH``), mapped or raw, and the [-1,1] map adds its
    operations: four before the raw field for each coordinate, and the
    scale after it for each component that is not a constant (Hopf's
    third: the kernel's scale of it is the same every step)."""
    d = rk_cuda.ODE_DIMS[kind]
    raw = rk_cuda.OdeField(kind)
    mapped = rk_cuda.OdeField(kind, mn=(0.0,) * d, span=(1.0,) * d,
                              scale=(1.0,) * d)
    want = [[e is None for e in row] for row in chip_smoke.FIELD_DEPTH[kind]]
    ops = {}
    for field in (raw, mapped):
        ops[field.mn is None], paths = chip_smoke.ds_field_trace(
            field, chip_smoke.UNIT)
        assert [[e is None for e in row] for row in paths] == want
    varying = sum(not all(want[i][c] for i in range(d)) for c in range(d))
    assert ops[False] == ops[True] + d * (
        2 * chip_smoke.DS_OPS["add"] + chip_smoke.DS_OPS["pow2"]
        + chip_smoke.DS_OPS["mul"]) + varying * chip_smoke.DS_OPS["mul"]
