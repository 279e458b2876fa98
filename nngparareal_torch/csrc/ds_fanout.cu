// Fine fan-out in double-single (f32 pair) arithmetic: fixed-step explicit
// Runge-Kutta for B time slices, all steps in one kernel, as
// (U) -> U(t0 + steps * h) with one step width h for every slice.
//
// Replaces the Pallas TPU kernel nngparareal_tpu/ops/rk_pallas.py
// (make_pallas_fanout_ds, its body _make_kernel) in its own arithmetic: the
// state is held as (hi, lo) float pairs and every operation is one of
// ds32.cuh's compensated f32 operations, in the order of the torch ds fields
// and of nngparareal_torch/ops/rk_ds.py:rk_step_ds, so that the plain torch
// ds fan-out (ops/rk_ds.py:make_batched_last_integrator_ds, given the
// kernel's step width) gives the same bits. The f64 form of the same TPU
// kernel is rk_fanout.cu; this file holds the two kernel forms again:
//   * ds_cells_kernel, one block per slice and one thread per grid cell, for
//     the PDE fields: Burgers' hand-fused ds field (ops/rk_ds.py:
//     make_burgers_ds_field) and FitzHugh-Nagumo 2D, lifted from its torch
//     field (systems/pdes.py:FHNPDE._f_norm11, which folds the generic
//     [-1,1] map of bounds [-1, 1] into (v + 1) - 1: this kernel takes that
//     order; the JAX package's lifted field takes the generic map's
//     (v + 1) / 2 * 2 + (-1), and in ds the two differ at the floor at most);
//   * ds_slice_kernel, one thread per slice, for the seven ODE fields,
//     lifted from their torch fields (systems/odes.py) with the generic
//     [-1,1] map of systems/base.py, or raw; DblPend and ThomasLabyrinth
//     take four lanes a slice and a rolled stage loop instead
//     (ds_slice_rolled_kernel).
//
// As the Pallas kernel does, the step coefficients h*a_ij and h*b_i are
// formed on the host in f64 from slice 0's width, split into pairs, and
// passed in, in the order of rk_pallas.py:_coef_layout (coef_a, coef_b);
// the fields are autonomous, so no stage time is formed. Each stage's sum
// starts at u and takes its terms (ds_axpy) in increasing j, and so does
// the step's weight sum: rk_step_ds's order. As in rk_fanout.cu, a stage's
// terms are added as soon as its k is ready (look-ahead, but in the rolled
// form), which reorders no sum.
//
// The per-cell kernel exchanges each stage's input through shared memory as
// float2 pairs, double-buffered, one barrier a stage; FHN-PDE stores the
// input after its (v + 1) - 1 fold, as the torch field rolls the folded
// state. Input and output are f64: each value is split into its pair on
// load and joined on store (ds32.cuh:from_f64, to_f64).
//
// What bounds it, and what the design does about it. The bound
// (chip_smoke.py:ds_bound) is the largest of the f32 operations over half
// the 67 TFLOP/s peak, the bytes, and the ds chain at the latency probe's
// f32 latencies, with each operation's count and depth taken from this
// source by its host build (tests/test_torch_ds32_host.py). Every change
// below keeps the plain version's bits (csrc/ds32.cuh's note). Measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W, in turns with the first form of
// this kernel (time_kernels.py --ds and --sass; PERF.md section 6):
//   * Fewer, shallower operations. TwoProd takes its error term by one FMA
//     (2 operations, not Dekker's 17), so a ds multiply is 9 (6 deep) and a
//     ds_axpy 23 (17 from k); a product with a power of two scales both
//     parts; the [-1,1] map halves; FHN's 3, Hopf's maxtime and FHN-PDE's
//     spacings are divisors fixed for the launch (ds32.cuh:ds_div_by).
//   * No branch in the step loop but DblPend's division by 2 - cd^2, whose
//     divisor changes (__fdiv_rn). A branch fences the scheduling of the
//     code around it, and where its direction differs between the lanes of
//     a warp it also runs both sides: the sines' quadrant and the lanes'
//     arguments are picked by bit operations (ds32.cuh:pick).
//   * Per cell, the flagship's Burgers (128 x 128, one block of 4 warps on
//     each of 128 SMs) is bound by its chain, 11 exchange rounds a step,
//     and by the instruction rate of one warp a scheduler; FHN-PDE
//     (512 x 512) by its operations: 256-thread blocks, two an SM.
//   * Per slice, one warp a scheduler at the path shapes (B <= 50): one
//     slice's chain and its warp's instruction rate. DblPend's and
//     ThomasLabyrinth's three reductions for sin and cos run on three of
//     four lanes of the slice and are exchanged (lane_pair). The unrolled
//     step of these two fields (140-215 KB of code at RK8) overflows the
//     instruction cache and ran at 5.6 cycles an instruction, against
//     1.3-1.7 for the other fields' RK4 steps of 15-26 KB: they roll the
//     stage loop (ds_slice_rolled_kernel), one copy of the field's code,
//     at the price of the look-ahead (a stage's input is summed after its
//     last k).
//   * Times at the path shapes, the first form's in brackets: Burgers
//     73.1 ms (178.1) against a 60.2 ms bound, FHN-PDE 7.64 s (14.5)
//     against 5.96 s, the ODE fields 0.46-87 ms (2.4-966 ms) at 30-100 %
//     of their chain bounds.

#include <cuda_runtime.h>

#include <cmath>

#include "ds32.cuh"
#include "rk_common.cuh"
#include "tableaus.cuh"

namespace {

using ds::Ds;

constexpr int kMaxThreads = 512;
constexpr int kSliceThreads = 64;
constexpr int kMaxCoefs = 64;
constexpr int kMaxStages = 16;

// The (hi, lo) pair of an f64 constant, formed at compile time (a field's
// literals) or on the host (its run-time constants): f32(x) and
// f32(x - f32(x)), as ops/ds_lift.py splits a constant.
__host__ __device__ constexpr Ds pair(double x)
{
    return {(float)x, (float)(x - (double)(float)x)};
}

// The step's coefficient pairs, h*a_ij then h*b_i, over the nonzeros.
struct Coefs {
    float hi[kMaxCoefs];
    float lo[kMaxCoefs];
};

// Where h*a_ij's pair sits (rk_pallas.py:_coef_layout: row by row, the
// nonzero a_ij in increasing j), and h*b_i's after all of them.
template <class T>
__host__ __device__ constexpr int coef_a(int i, int j)
{
    int idx = 0;
    for (int r = 0; r < T::S; ++r) {
        for (int c = 0; c < r; ++c) {
            if (r == i && c == j) {
                return idx;
            }
            idx += T::nz_a[r][c] != 0;
        }
    }
    return -1;
}
template <class T>
__host__ __device__ constexpr int coef_b(int i)
{
    int idx = 0;  // after all the a_ij's
    for (int r = 0; r < T::S; ++r) {
        for (int c = 0; c < r; ++c) {
            idx += T::nz_a[r][c] != 0;
        }
    }
    for (int r = 0; r < i; ++r) {
        idx += T::nz_b[r] != 0;
    }
    return idx;
}
template <class T>
constexpr int n_coefs()
{
    return coef_b<T>(T::S);
}
static_assert(n_coefs<tableau::RK1>() == 1 && n_coefs<tableau::RK2>() == 2
                  && n_coefs<tableau::RK4>() == 7
                  && n_coefs<tableau::RK8>() == 44
                  && n_coefs<tableau::RK8>() <= kMaxCoefs,
              "the coefficient layout disagrees with rk_pallas.py's");

// The same layout as lists, for a loop over the stages: row r's
// coefficients are [start[r], start[r + 1]) (row 0 has none; row S is the
// weights b_i), j[t] the stage whose k coefficient t multiplies. Ints: a
// kernel reads a parameter's ints at a run-time index where it is (bytes
// it would copy to local memory first).
struct Terms {
    int j[kMaxCoefs];
    int start[kMaxStages + 2];
};

template <class T>
Terms terms()
{
    static_assert(T::S + 2 <= kMaxStages + 2, "too many stages");
    Terms tm{};
    int t = 0;
    for (int r = 0; r <= T::S; ++r) {
        tm.start[r] = t;
        for (int c = 0; c < (r < T::S ? r : T::S); ++c) {
            if (r < T::S ? T::nz_a[r][c] != 0 : T::nz_b[c] != 0) {
                tm.j[t++] = c;
            }
        }
    }
    tm.start[T::S + 1] = t;
    return tm;
}

template <int I>
__device__ __forceinline__ Ds coef(const Coefs& co)
{
    return {co.hi[I], co.lo[I]};
}

// Stage S's input: its running sum, or u where row S of a is all zero.
template <class T, int S, int D>
__device__ __forceinline__ void stage_input(Ds (&v)[D], const Ds (&u)[D],
                                            const Ds (&acc)[T::S][D])
{
#pragma unroll
    for (int c = 0; c < D; ++c) {
        if constexpr (first_a<T>(S) < 0) {
            v[c] = u[c];
        } else {
            v[c] = acc[S][c];
        }
    }
}

// k_J into the running sums of the later stages with a_iJ != 0 and into the
// step's weight sum, each started at u: rk_step_ds's vh = ds_axpy(vh, h a_ij,
// k_j) and outh = ds_axpy(outh, h b_i, k_i).
template <class T, int J, int D>
__device__ __forceinline__ void add_stage(Ds (&acc)[T::S][D], Ds (&o)[D],
                                          const Ds (&u)[D], const Ds (&k)[D],
                                          const Coefs& co)
{
    unroll<J + 1, T::S>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        if constexpr (nz_a<T>(i, J)) {
            const Ds c = coef<coef_a<T>(i, J)>(co);
#pragma unroll
            for (int q = 0; q < D; ++q) {
                acc[i][q] = ds::ds_axpy(first_a<T>(i) == J ? u[q] : acc[i][q],
                                        c, k[q]);
            }
        }
    });
    if constexpr (nz_b<T>(J)) {
        const Ds c = coef<coef_b<T>(J)>(co);
#pragma unroll
        for (int q = 0; q < D; ++q) {
            o[q] = ds::ds_axpy(first_b<T>() == J ? u[q] : o[q], c, k[q]);
        }
    }
}

// ---------------------------------------------------------------------------
// One thread per cell: the PDE fields
// ---------------------------------------------------------------------------

__device__ __forceinline__ Ds load(const float2* sb, int idx)
{
    const float2 x = sb[idx];
    return {x.x, x.y};
}

// ops/rk_ds.py:make_burgers_ds_field, c2 = inv_h2 and c1 = half_inv_2h:
//     f(v) = (vp - 2v + vm) * c2 - (v + 1) * ((vp - vm) * c1)
struct BurgersDs {
    static constexpr int V = 1;
    Ds c2, c1;

    struct Stencil {
        int p, m;
    };

    __device__ __forceinline__ Stencil stencil(int i, int n) const
    {
        return {(i + 1 == n) ? 0 : i + 1, (i == 0) ? n - 1 : i - 1};
    }

    __device__ __forceinline__ void prepare() {}

    // the value exchanged: the stage input itself
    __device__ __forceinline__ void prep(const Ds (&v)[V], Ds (&w)[V]) const
    {
        w[0] = v[0];
    }

    __device__ __forceinline__ void eval(const float2* sb, int n,
                                         const Stencil& st, const Ds (&w)[V],
                                         Ds (&out)[V]) const
    {
        using namespace ds;
        const Ds vp = load(sb, st.p);
        const Ds vm = load(sb, st.m);
        const Ds v = w[0];
        const Ds s = ds_add(ds_add(vp, vm), ds_pow2(v, -2.0f));
        const Ds xx = ds_scale(s, c2);
        const Ds x = ds_scale(ds_sub(vp, vm), c1);
        out[0] = ds_sub(xx, ds_mul(ds_add_f32(v, 1.0f), x));
    }
};

// systems/pdes.py:FHNPDE._f_norm11 lifted: w = (v + 1) - 1, then on the
// periodic (d_y, d_x) grid of w, with L(g) = ((g_e - 2g) + g_w) / hx2 +
// ((g_n - 2g) + g_s) / hy2,
//     U = ((L(u1) * a + u1) - u1^3 - u2) + k
//     V = ((L(u2) * b + u1) - u2) * inv_tau
// with u1^3 = u1 * (u1 * u1) (ds_lift.py:_pow_ds). The two spacings are
// divisors fixed for the launch (ds32.cuh:ds_div_by), 2g is ds_pow2.
struct FhnPdeDs {
    static constexpr int V = 2;
    int d_x, d_y;
    ds::Divisor hx2, hy2;
    Ds a, b, k, inv_tau;

    // the spacings' reciprocals, on the card, before the step loop
    __device__ __forceinline__ void prepare()
    {
        hx2 = ds::divisor(hx2.y);
        hy2 = ds::divisor(hy2.y);
    }

    struct Stencil {
        int e, w, nn, s;  // x+1, x-1, y+1, y-1, periodic
    };

    __device__ __forceinline__ Stencil stencil(int i, int n) const
    {
        const int x = i % d_x;
        const int y = i / d_x;
        const int row = y * d_x;
        return {row + ((x + 1 == d_x) ? 0 : x + 1),
                row + ((x == 0) ? d_x - 1 : x - 1),
                ((y + 1 == d_y) ? 0 : y + 1) * d_x + x,
                ((y == 0) ? d_y - 1 : y - 1) * d_x + x};
    }

    __device__ __forceinline__ void prep(const Ds (&v)[V], Ds (&w)[V]) const
    {
        constexpr Ds one = pair(1.0);
#pragma unroll
        for (int c = 0; c < V; ++c) {
            w[c] = ds::ds_sub(ds::ds_add(v[c], one), one);
        }
    }

    __device__ __forceinline__ Ds lap(const float2* g, Ds c,
                                      const Stencil& st) const
    {
        using namespace ds;
        const Ds c2 = ds_pow2(c, 2.0f);
        const Ds gxx = ds_div_by<2>(ds_add(ds_sub(load(g, st.e), c2),
                                           load(g, st.w)), hx2);
        const Ds gyy = ds_div_by<2>(ds_add(ds_sub(load(g, st.nn), c2),
                                           load(g, st.s)), hy2);
        return ds_add(gxx, gyy);
    }

    __device__ __forceinline__ void eval(const float2* sb, int n,
                                         const Stencil& st, const Ds (&w)[V],
                                         Ds (&out)[V]) const
    {
        using namespace ds;
        const Ds u1 = w[0];
        const Ds u2 = w[1];
        const Ds s1 = ds_add(ds_mul(lap(sb, u1, st), a), u1);
        const Ds s2 = ds_add(ds_mul(lap(sb + n, u2, st), b), u1);
        const Ds cube = ds_mul(u1, ds_mul(u1, u1));
        out[0] = ds_add(ds_sub(ds_sub(s1, cube), u2), k);
        out[1] = ds_mul(ds_sub(s2, u2), inv_tau);
    }
};

template <class T, class F>
__global__ void __launch_bounds__(kMaxThreads, 1)
ds_cells_kernel(const double* __restrict__ U, double* __restrict__ out,
                long long steps, Coefs co, F field)
{
    constexpr int V = F::V;
    constexpr int S = T::S;
    extern __shared__ float2 dsbuf[];  // 2*V*n stage inputs, double-buffered

    const int slice = blockIdx.x;
    const int i = threadIdx.x;
    const int n = blockDim.x;  // cells per slice
    F f = field;
    f.prepare();
    const typename F::Stencil st = f.stencil(i, n);
    const size_t base = (size_t)slice * V * n + i;

    Ds u[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
        u[c] = ds::from_f64(U[base + (size_t)c * n]);
    }
    float2* sb = dsbuf;
    float2* sb_next = dsbuf + V * n;

    for (long long step = 0; step < steps; ++step) {
        Ds acc[S][V];  // acc[s]: stage s's input, summed as k_j arrive
        Ds o[V];       // the step's weight sum, from u
        unroll<0, S>([&](auto s_) {
            constexpr int s = decltype(s_)::value;
            Ds v[V], w[V], k[V];
            stage_input<T, s>(v, u, acc);
            f.prep(v, w);
#pragma unroll
            for (int c = 0; c < V; ++c) {
                sb[c * n + i] = make_float2(w[c].hi, w[c].lo);
            }
            __syncthreads();
            f.eval(sb, n, st, w, k);
            float2* const done = sb;
            sb = sb_next;
            sb_next = done;
            add_stage<T, s>(acc, o, u, k, co);
        });
#pragma unroll
        for (int c = 0; c < V; ++c) {
            u[c] = o[c];
        }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
        out[base + (size_t)c * n] = ds::to_f64(u[c]);
    }
}

// The coefficients from the host arrays, checked against the tableau's
// count of nonzeros.
template <class T>
bool fill_coefs(Coefs& co, const float* hi, const float* lo, int n_coef)
{
    if (n_coef != n_coefs<T>() || hi == nullptr || lo == nullptr) {
        return false;
    }
    for (int c = 0; c < kMaxCoefs; ++c) {
        co.hi[c] = c < n_coef ? hi[c] : 0.0f;
        co.lo[c] = c < n_coef ? lo[c] : 0.0f;
    }
    return true;
}

// Launches the per-cell kernel, or with `query` set reports its attributes.
template <class F>
int launch_cells(const double* U, double* out, int tab, int B, int n,
                 long long steps, const float* coef_hi, const float* coef_lo,
                 int n_coef, const F& field, int* query, void* stream)
{
    if (B <= 0 || n <= 0 || n > kMaxThreads || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_tableau(tab, [&](auto t) {
        using T = decltype(t);
        const size_t shmem = (size_t)2 * F::V * n * sizeof(float2);
        auto kernel = ds_cells_kernel<T, F>;
        if (query != nullptr) {
            return attributes(kernel, n, shmem, query);
        }
        Coefs co;
        if (!fill_coefs<T>(co, coef_hi, coef_lo, n_coef)) {
            return (int)cudaErrorInvalidValue;
        }
        kernel<<<B, n, shmem, st>>>(U, out, steps, co, field);
        return (int)cudaGetLastError();
    });
}

// ---------------------------------------------------------------------------
// One thread per slice (or kLanes): the ODE fields, lifted from
// systems/odes.py
// ---------------------------------------------------------------------------

// Each raw field in its torch expression's order; a literal c is the pair
// of c (ds_mul, not ds_mul_f32; ds_pow2 for a power of two), a division
// ds_div, or ds_div_by for a divisor fixed for the launch. prepare() forms
// a field's divisors on the card before the step loop.

// The pair x of lane `src` of this thread's group of L lanes (the lanes of
// one slice): two exchanges.
template <int L>
__device__ __forceinline__ Ds lane_pair(Ds x, int src)
{
    return {__shfl_sync(0xffffffffu, x.hi, src, L),
            __shfl_sync(0xffffffffu, x.lo, src, L)};
}

struct FhnOdeDs {
    static constexpr int kLanes = 1;
    static constexpr int D = 2;
    ds::Divisor c3;
    __device__ __forceinline__ void prepare() { c3 = ds::divisor(pair(3.0)); }
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        constexpr Ds a = pair(0.2), b = pair(0.2), c = pair(3.0),
                     m = pair(-(1.0 / 3.0));
        const Ds cube = ds_mul(ds_mul(u[0], u[0]), u[0]);
        f[0] = ds_mul(c, ds_add(ds_sub(u[0], ds_div_by<1>(cube, c3)), u[1]));
        f[1] = ds_mul(m, ds_add(ds_sub(u[0], a), ds_mul(b, u[1])));
    }
};

struct RosslerDs {
    static constexpr int kLanes = 1;
    static constexpr int D = 3;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        constexpr Ds a = pair(0.2), b = pair(0.2), c = pair(5.7);
        f[0] = ds_sub(neg(u[1]), u[2]);
        f[1] = ds_add(u[0], ds_mul(a, u[1]));
        f[2] = ds_add(b, ds_mul(u[2], ds_sub(u[0], c)));
    }
};

// maxtime: the end of the system's tspan, a divisor fixed for the launch.
struct HopfDs {
    static constexpr int kLanes = 1;
    static constexpr int D = 3;
    ds::Divisor maxtime;
    __device__ __forceinline__ void prepare()
    {
        maxtime = ds::divisor(maxtime.y);
    }
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        const Ds mu = ds_sub(ds_sub(ds_div_by<2>(u[2], maxtime),
                                    ds_mul(u[0], u[0])),
                             ds_mul(u[1], u[1]));
        f[0] = ds_add(neg(u[1]), ds_mul(u[0], mu));
        f[1] = ds_add(u[0], ds_mul(u[1], mu));
        f[2] = pair(1.0);
    }
};

// Its three sines and cosines are independent Horner chains: lanes 0, 1 and
// 2 of the slice's four compute one reduction each, at once, in one
// instruction stream (each picks its argument without a branch, ds32.cuh:
// pick), and exchange the pairs (lane 3 repeats lane 2's);
// every lane then evaluates the rest alike. The division by 2 - cd^2, whose
// divisor changes, keeps __fdiv_rn; it comes last, so that d1 and d3 are
// formed before its branch.
struct DblPendDs {
    static constexpr int kLanes = 4;
    static constexpr int D = 4;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ void operator()(const Ds (&u)[D], Ds (&f)[D],
                                               int lane) const
    {
        using namespace ds;
        constexpr Ds two = pair(2.0), mone = pair(-1.0);
        const Ds dq = ds_sub(u[0], u[2]);
        // lane 0: sin and cos of dq; lanes 1 and 2: sin(u0) and sin(u2)
        Ds sn, cs;
        sin_cos(pick(lane == 0, dq, pick(lane == 1, u[0], u[2])), sn, cs);
        const Ds sd = lane_pair<kLanes>(sn, 0);
        const Ds cd = lane_pair<kLanes>(cs, 0);
        const Ds sin0 = lane_pair<kLanes>(sn, 1);
        const Ds sin2 = lane_pair<kLanes>(sn, 2);
        const Ds sq1 = ds_mul(u[1], u[1]);
        const Ds sq3 = ds_mul(u[3], u[3]);
        const Ds den_in = ds_sub(two, ds_mul(cd, cd));
        const Ds d1 = ds_sub(ds_add(ds_add(ds_mul(ds_mul(sq1, cd), sd),
                                           ds_mul(sq3, sd)),
                                    ds_pow2(sin0, 2.0f)),
                             ds_mul(cd, sin2));
        const Ds d3 = ds_add(ds_sub(ds_sub(ds_mul(ds_pow2(sq1, -2.0f), sd),
                                           ds_mul(ds_mul(sq3, sd), cd)),
                                    ds_mul(ds_pow2(cd, 2.0f), sin0)),
                             ds_pow2(sin2, 2.0f));
        const Ds den = ds_div(mone, den_in);
        f[0] = u[1];
        f[1] = ds_mul(den, d1);
        f[2] = u[3];
        f[3] = ds_mul(den, d3);
    }
};

struct BrusselatorDs {
    static constexpr int kLanes = 1;
    static constexpr int D = 2;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        const Ds sq0_u1 = ds_mul(ds_mul(u[0], u[0]), u[1]);
        f[0] = ds_sub(ds_add(pair(1.0), sq0_u1), ds_pow2(u[0], 4.0f));
        f[1] = ds_sub(ds_mul(pair(3.0), u[0]), sq0_u1);
    }
};

struct LorenzDs {
    static constexpr int kLanes = 1;
    static constexpr int D = 3;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        f[0] = ds_mul(pair(10.0), ds_sub(u[1], u[0]));
        f[1] = ds_sub(ds_sub(ds_mul(pair(28.0), u[0]), u[1]),
                      ds_mul(u[0], u[2]));
        f[2] = ds_sub(ds_mul(u[0], u[1]), ds_mul(pair(8.0 / 3.0), u[2]));
    }
};

// -a * u + roll(b * sin(u), -1): component c takes sin(u[c + 1]). Lane c
// of the slice's four computes b * sin(u[c]) (lane 3 repeats lane 2's) and
// the lanes exchange them, as DblPend's.
struct ThomasLabyrinthDs {
    static constexpr int kLanes = 4;
    static constexpr int D = 3;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ void operator()(const Ds (&u)[D], Ds (&f)[D],
                                               int lane) const
    {
        using namespace ds;
        constexpr Ds b = pair(10.0);
        Ds sn, unused;
        sin_cos(pick(lane == 0, u[0], pick(lane == 1, u[1], u[2])), sn,
                unused);
        const Ds mine = ds_mul(b, sn);
#pragma unroll
        for (int c = 0; c < D; ++c) {
            f[c] = ds_add(ds_pow2(u[c], -0.5f),
                          lane_pair<kLanes>(mine, (c + 1) % D));
        }
    }
};

// A raw field, and for Mapped the generic [-1,1] map of systems/base.py's
// f_normalized, lifted: raw((v + 1) / 2 * span + mn) * scale, the division
// by the pair of 2 an exact halving (ds_pow2).
template <class Raw, bool Mapped>
struct SliceFieldDs {
    static constexpr int D = Raw::D;
    static constexpr int kLanes = Raw::kLanes;
    Raw raw;
    Ds mn[D], span[D], scale[D];

    __device__ __forceinline__ void prepare() { raw.prepare(); }

    __device__ __forceinline__ void raw_eval(const Ds (&x)[D], Ds (&f)[D],
                                             int lane) const
    {
        if constexpr (kLanes > 1) {
            raw(x, f, lane);
        } else {
            raw(x, f);
        }
    }

    __device__ __forceinline__ void eval(const Ds (&v)[D], Ds (&f)[D],
                                         int lane) const
    {
        using namespace ds;
        if constexpr (!Mapped) {
            raw_eval(v, f, lane);
        } else {
            constexpr Ds one = pair(1.0);
            Ds x[D];
#pragma unroll
            for (int c = 0; c < D; ++c) {
                x[c] = ds_add(ds_mul(ds_pow2(ds_add(v[c], one), 0.5f),
                                     span[c]),
                              mn[c]);
            }
            raw_eval(x, f, lane);
#pragma unroll
            for (int c = 0; c < D; ++c) {
                f[c] = ds_mul(f[c], scale[c]);
            }
        }
    }
};

// kLanes threads per slice (one, or four for the fields with sines); the
// lanes of a slice carry the same state, and the lanes past the last slice
// integrate it too and store nothing, so that every lane of a warp takes
// part in the exchanges.
template <class T, class F>
__global__ void __launch_bounds__(kSliceThreads)
ds_slice_kernel(const double* __restrict__ U, double* __restrict__ out,
                int B, long long steps, Coefs co, F field)
{
    constexpr int D = F::D;
    constexpr int S = T::S;
    constexpr int L = F::kLanes;
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    const int slice = gid / L;
    const int lane = gid % L;
    if (L == 1 && slice >= B) {
        return;
    }
    const int row = slice < B ? slice : B - 1;
    F f = field;
    f.prepare();
    Ds u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        u[c] = ds::from_f64(U[(size_t)row * D + c]);
    }
    for (long long step = 0; step < steps; ++step) {
        Ds acc[S][D];
        Ds o[D];
        unroll<0, S>([&](auto s_) {
            constexpr int s = decltype(s_)::value;
            Ds v[D], k[D];
            stage_input<T, s>(v, u, acc);
            f.eval(v, k, lane);
            add_stage<T, s>(acc, o, u, k, co);
        });
#pragma unroll
        for (int c = 0; c < D; ++c) {
            u[c] = o[c];
        }
    }
    if (slice < B && lane == 0) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
            out[(size_t)slice * D + c] = ds::to_f64(u[c]);
        }
    }
}

// The same step with the stage loop rolled, for the fields whose unrolled
// step would not fit the instruction cache (the fields with sines): one
// copy of the field's code, not one a stage. Each stage's
// k goes to shared memory (a column of S * D pairs a thread); after stage s
// the next stage's input (after the last stage, the step's weight sum) is
// summed from u over its terms in increasing j, as rk_step_ds sums it, the
// last term, k_s, from registers.
template <class T, class F>
__global__ void __launch_bounds__(kSliceThreads)
ds_slice_rolled_kernel(const double* __restrict__ U,
                       double* __restrict__ out, int B, long long steps,
                       Coefs co, Terms tm, F field)
{
    constexpr int D = F::D;
    constexpr int S = T::S;
    constexpr int L = F::kLanes;
    extern __shared__ float2 kbuf[];  // k[s][c] at (s * D + c) * blockDim.x
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    const int slice = gid / L;
    const int lane = gid % L;
    if (L == 1 && slice >= B) {
        return;
    }
    const int row = slice < B ? slice : B - 1;
    const int nt = blockDim.x;
    float2* const ks = kbuf + threadIdx.x;
    F f = field;
    f.prepare();
    Ds u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        u[c] = ds::from_f64(U[(size_t)row * D + c]);
    }
    for (long long step = 0; step < steps; ++step) {
        Ds v[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
            v[c] = u[c];
        }
#pragma unroll 1
        for (int s = 0; s < S; ++s) {
            Ds k[D];
            f.eval(v, k, lane);
#pragma unroll
            for (int c = 0; c < D; ++c) {
                ks[(s * D + c) * nt] = make_float2(k[c].hi, k[c].lo);
                v[c] = u[c];
            }
            const int end = tm.start[s + 2];
            int t = tm.start[s + 1];
            for (; t < end && tm.j[t] < s; ++t) {
                const Ds cf{co.hi[t], co.lo[t]};
                const int j = tm.j[t];
#pragma unroll
                for (int c = 0; c < D; ++c) {
                    const float2 kj = ks[(j * D + c) * nt];
                    v[c] = ds::ds_axpy(v[c], cf, Ds{kj.x, kj.y});
                }
            }
            if (t < end) {
                const Ds cf{co.hi[t], co.lo[t]};
#pragma unroll
                for (int c = 0; c < D; ++c) {
                    v[c] = ds::ds_axpy(v[c], cf, k[c]);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
            u[c] = v[c];
        }
    }
    if (slice < B && lane == 0) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
            out[(size_t)slice * D + c] = ds::to_f64(u[c]);
        }
    }
}

// Whether an instance takes the rolled stage loop: the fields with sines,
// whose evaluation is most of a stage.
template <class T, class F>
constexpr bool rolled()
{
    return F::kLanes > 1;
}

template <bool Mapped, class Raw>
int launch_slice_field(const double* U, double* out, int tab, int B,
                       long long steps, const float* coef_hi,
                       const float* coef_lo, int n_coef, const double* map,
                       const Raw& raw, int* query, cudaStream_t st)
{
    constexpr int D = Raw::D;
    using F = SliceFieldDs<Raw, Mapped>;
    F field{raw, {}, {}, {}};
    if constexpr (Mapped) {
        for (int c = 0; c < D; ++c) {
            field.mn[c] = pair(map[c]);
            field.span[c] = pair(map[D + c]);
            field.scale[c] = pair(map[2 * D + c]);
        }
    }
    // a warp or two for the small batches, blocks of kSliceThreads beyond
    const int lanes = B * F::kLanes;
    const int threads = lanes < kSliceThreads ? (lanes + 31) / 32 * 32
                                              : kSliceThreads;
    const int blocks = (lanes + threads - 1) / threads;
    return with_tableau(tab, [&](auto t) {
        using T = decltype(t);
        if constexpr (rolled<T, F>()) {
            auto kernel = ds_slice_rolled_kernel<T, F>;
            const size_t shmem = (size_t)T::S * D * threads * sizeof(float2);
            if (query != nullptr) {
                return attributes(kernel, threads, shmem, query);
            }
            Coefs co;
            if (!fill_coefs<T>(co, coef_hi, coef_lo, n_coef)) {
                return (int)cudaErrorInvalidValue;
            }
            kernel<<<blocks, threads, shmem, st>>>(U, out, B, steps, co,
                                                   terms<T>(), field);
        } else {
            auto kernel = ds_slice_kernel<T, F>;
            if (query != nullptr) {
                return attributes(kernel, threads, 0, query);
            }
            Coefs co;
            if (!fill_coefs<T>(co, coef_hi, coef_lo, n_coef)) {
                return (int)cudaErrorInvalidValue;
            }
            kernel<<<blocks, threads, 0, st>>>(U, out, B, steps, co, field);
        }
        return (int)cudaGetLastError();
    });
}

template <class Raw>
int launch_slices(const double* U, double* out, int tab, int B,
                  long long steps, const float* coef_hi, const float* coef_lo,
                  int n_coef, const double* map, const Raw& raw, int* query,
                  void* stream)
{
    if (B <= 0 || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (map != nullptr) {
        return launch_slice_field<true>(U, out, tab, B, steps, coef_hi,
                                        coef_lo, n_coef, map, raw, query, st);
    }
    return launch_slice_field<false>(U, out, tab, B, steps, coef_hi, coef_lo,
                                     n_coef, map, raw, query, st);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes
// (nngparareal_torch/ops/rk_cuda_ds.py). U and out (B, d) are device
// pointers to contiguous f64 arrays; tableau is an id of tableaus.cuh;
// coef_hi and coef_lo are host arrays of the n_coef step coefficient pairs
// (h*a_ij, then h*b_i, over the nonzeros), n_coef the tableau's count; the
// other constants are f64 and split here. Each launches on `stream` and
// returns the cudaError_t of the launch (0 = ok); with `query` set (an
// int[4]) each launches nothing and reports the instance it would launch:
// registers a thread, local memory a thread in bytes, resident blocks per
// SM, threads a block.

// Each build compiles the entry points of one field, selected by DS_PART
// (ops/rk_cuda.py:LIBRARIES builds the nine parts as nine libraries, one
// nvcc each, all at once): 1 Burgers, 2 FHN-PDE, 3 FHN ODE, 4 Rossler,
// 5 Hopf, 6 DblPend, 7 Brusselator, 8 Lorenz, 9 ThomasLabyrinth.
#ifndef DS_PART
#error "build with -DDS_PART=<1..9> (ops/rk_cuda.py:LIBRARIES)"
#endif

#if DS_PART == 1
// Burgers: d grid points per slice, one thread each; c2 = inv_h2,
// c1 = half_inv_2h.
extern "C" int ds_fanout_burgers_launch(const double* U, double* out,
                                        int tableau, int B, int d,
                                        long long steps, const float* coef_hi,
                                        const float* coef_lo, int n_coef,
                                        double c2, double c1, int* query,
                                        void* stream)
{
    const BurgersDs field{pair(c2), pair(c1)};
    return launch_cells(U, out, tableau, B, d, steps, coef_hi, coef_lo,
                        n_coef, field, query, stream);
}

#endif

#if DS_PART == 2
// FHN-PDE: d = 2 * d_y * d_x values per slice, one thread per cell; hx2 and
// hy2 the squared spacings (the field divides by them).
extern "C" int ds_fanout_fhn_pde_launch(const double* U, double* out,
                                        int tableau, int B, int d_x, int d_y,
                                        long long steps, const float* coef_hi,
                                        const float* coef_lo, int n_coef,
                                        double hx2, double hy2, double a,
                                        double b, double k, double inv_tau,
                                        int* query, void* stream)
{
    if (d_x <= 0 || d_y <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const FhnPdeDs field{d_x,           d_y,     {pair(hx2), 0.0f},
                         {pair(hy2), 0.0f}, pair(a), pair(b),
                         pair(k),           pair(inv_tau)};
    return launch_cells(U, out, tableau, B, d_x * d_y, steps, coef_hi,
                        coef_lo, n_coef, field, query, stream);
}

#endif

// ODE fields: D = 2, 3 or 4 state values per slice, one thread per slice.
// map: a host array of 3*D values (mn, span, scale per coordinate) for a
// [-1,1]-normalised system, or NULL for the raw field.
#define DS_SLICE_ENTRY(kind, Raw)                                           \
    extern "C" int ds_slice_##kind##_launch(                                \
        const double* U, double* out, int tableau, int B, long long steps,  \
        const float* coef_hi, const float* coef_lo, int n_coef,             \
        const double* map, int* query, void* stream)                        \
    {                                                                       \
        return launch_slices(U, out, tableau, B, steps, coef_hi, coef_lo,   \
                             n_coef, map, Raw{}, query, stream);            \
    }

#if DS_PART == 3
DS_SLICE_ENTRY(fhn_ode, FhnOdeDs)
#elif DS_PART == 4
DS_SLICE_ENTRY(rossler, RosslerDs)
#elif DS_PART == 6
DS_SLICE_ENTRY(dblpend, DblPendDs)
#elif DS_PART == 7
DS_SLICE_ENTRY(brusselator, BrusselatorDs)
#elif DS_PART == 8
DS_SLICE_ENTRY(lorenz, LorenzDs)
#elif DS_PART == 9
DS_SLICE_ENTRY(tomlab, ThomasLabyrinthDs)
#endif

#if DS_PART == 5
// Hopf takes the end of its tspan as well: its divisor.
extern "C" int ds_slice_hopf_launch(const double* U, double* out, int tableau,
                                    int B, long long steps,
                                    const float* coef_hi,
                                    const float* coef_lo, int n_coef,
                                    const double* map, double maxtime,
                                    int* query, void* stream)
{
    if (!std::isfinite(maxtime) || maxtime == 0.0) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_slices(U, out, tableau, B, steps, coef_hi, coef_lo, n_coef,
                         map, HopfDs{{pair(maxtime), 0.0f}}, query, stream);
}
#endif
