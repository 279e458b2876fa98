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
//     [-1,1] map of systems/base.py, or raw.
//
// As the Pallas kernel does, the step coefficients h*a_ij and h*b_i are
// formed on the host in f64 from slice 0's width, split into pairs, and
// passed in, in the order of rk_pallas.py:_coef_layout (coef_a, coef_b);
// the fields are autonomous, so no stage time is formed. Each stage's sum
// starts at u and takes its terms (ds_axpy) in increasing j, and so does
// the step's weight sum: rk_step_ds's order. As in rk_fanout.cu, a stage's
// terms are added as soon as its k is ready (look-ahead), which reorders no
// sum.
//
// The per-cell kernel exchanges each stage's input through shared memory as
// float2 pairs, double-buffered, one barrier a stage; FHN-PDE stores the
// input after its (v + 1) - 1 fold, as the torch field rolls the folded
// state. Input and output are f64: each value is split into its pair on
// load and joined on store (ds32.cuh:from_f64, to_f64).
//
// What bounds it (chip_smoke.py, the ds phase): the dependent chain. A ds
// add is 9 dependent f32 operations, a ds multiply about 10 and a division
// about 40, so one RK step of a slice is a chain some ten times the f64
// kernel's; operations are the next bound for FHN-PDE. A simple kernel
// that is right: no work went into its speed.

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
        const Ds s = ds_add(ds_add(vp, vm), ds_mul_f32(v, -2.0f));
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
// with u1^3 = u1 * (u1 * u1) (ds_lift.py:_pow_ds).
struct FhnPdeDs {
    static constexpr int V = 2;
    int d_x, d_y;
    Ds hx2, hy2, a, b, k, inv_tau;

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
        const Ds c2 = ds_mul(pair(2.0), c);
        const Ds gxx = ds_div(ds_add(ds_sub(load(g, st.e), c2),
                                     load(g, st.w)), hx2);
        const Ds gyy = ds_div(ds_add(ds_sub(load(g, st.nn), c2),
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
    const typename F::Stencil st = field.stencil(i, n);
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
            field.prep(v, w);
#pragma unroll
            for (int c = 0; c < V; ++c) {
                sb[c * n + i] = make_float2(w[c].hi, w[c].lo);
            }
            __syncthreads();
            field.eval(sb, n, st, w, k);
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
// One thread per slice: the ODE fields, lifted from systems/odes.py
// ---------------------------------------------------------------------------

// Each raw field in its torch expression's order; a literal c is the pair
// of c (ds_mul, not ds_mul_f32), a division ds_div.

struct FhnOdeDs {
    static constexpr int D = 2;
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        constexpr Ds a = pair(0.2), b = pair(0.2), c = pair(3.0),
                     c3 = pair(3.0), m = pair(-(1.0 / 3.0));
        const Ds cube = ds_mul(ds_mul(u[0], u[0]), u[0]);
        f[0] = ds_mul(c, ds_add(ds_sub(u[0], ds_div(cube, c3)), u[1]));
        f[1] = ds_mul(m, ds_add(ds_sub(u[0], a), ds_mul(b, u[1])));
    }
};

struct RosslerDs {
    static constexpr int D = 3;
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

struct HopfDs {
    static constexpr int D = 3;
    Ds maxtime;
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        const Ds mu = ds_sub(ds_sub(ds_div(u[2], maxtime),
                                    ds_mul(u[0], u[0])),
                             ds_mul(u[1], u[1]));
        f[0] = ds_add(neg(u[1]), ds_mul(u[0], mu));
        f[1] = ds_add(u[0], ds_mul(u[1], mu));
        f[2] = pair(1.0);
    }
};

struct DblPendDs {
    static constexpr int D = 4;
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        constexpr Ds two = pair(2.0), mtwo = pair(-2.0), mone = pair(-1.0);
        Ds sd, cd, sin0, sin2, unused;
        sin_cos(ds_sub(u[0], u[2]), sd, cd);
        sin_cos(u[0], sin0, unused);
        sin_cos(u[2], sin2, unused);
        const Ds sq1 = ds_mul(u[1], u[1]);
        const Ds sq3 = ds_mul(u[3], u[3]);
        const Ds den = ds_div(mone, ds_sub(two, ds_mul(cd, cd)));
        const Ds d1 = ds_sub(ds_add(ds_add(ds_mul(ds_mul(sq1, cd), sd),
                                           ds_mul(sq3, sd)),
                                    ds_mul(two, sin0)),
                             ds_mul(cd, sin2));
        const Ds d3 = ds_add(ds_sub(ds_sub(ds_mul(ds_mul(mtwo, sq1), sd),
                                           ds_mul(ds_mul(sq3, sd), cd)),
                                    ds_mul(ds_mul(two, cd), sin0)),
                             ds_mul(two, sin2));
        f[0] = u[1];
        f[1] = ds_mul(den, d1);
        f[2] = u[3];
        f[3] = ds_mul(den, d3);
    }
};

struct BrusselatorDs {
    static constexpr int D = 2;
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        const Ds sq0_u1 = ds_mul(ds_mul(u[0], u[0]), u[1]);
        f[0] = ds_sub(ds_add(pair(1.0), sq0_u1), ds_mul(pair(4.0), u[0]));
        f[1] = ds_sub(ds_mul(pair(3.0), u[0]), sq0_u1);
    }
};

struct LorenzDs {
    static constexpr int D = 3;
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

// -a * u + roll(b * sin(u), -1): component c takes sin(u[c + 1]).
struct ThomasLabyrinthDs {
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ds (&u)[D],
                                               Ds (&f)[D]) const
    {
        using namespace ds;
        constexpr Ds ma = pair(-0.5), b = pair(10.0);
        Ds s[D], unused;
#pragma unroll
        for (int c = 0; c < D; ++c) {
            sin_cos(u[c], s[c], unused);
            s[c] = ds_mul(b, s[c]);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
            f[c] = ds_add(ds_mul(ma, u[c]), s[(c + 1) % D]);
        }
    }
};

// A raw field, and for Mapped the generic [-1,1] map of systems/base.py's
// f_normalized, lifted: raw((v + 1) / 2 * span + mn) * scale.
template <class Raw, bool Mapped>
struct SliceFieldDs {
    static constexpr int D = Raw::D;
    Raw raw;
    Ds mn[D], span[D], scale[D];

    __device__ __forceinline__ void eval(const Ds (&v)[D], Ds (&f)[D]) const
    {
        using namespace ds;
        if constexpr (!Mapped) {
            raw(v, f);
        } else {
            constexpr Ds one = pair(1.0), two = pair(2.0);
            Ds x[D];
#pragma unroll
            for (int c = 0; c < D; ++c) {
                x[c] = ds_add(ds_mul(ds_div(ds_add(v[c], one), two),
                                     span[c]),
                              mn[c]);
            }
            raw(x, f);
#pragma unroll
            for (int c = 0; c < D; ++c) {
                f[c] = ds_mul(f[c], scale[c]);
            }
        }
    }
};

template <class T, class F>
__global__ void __launch_bounds__(kSliceThreads)
ds_slice_kernel(const double* __restrict__ U, double* __restrict__ out,
                int B, long long steps, Coefs co, F field)
{
    constexpr int D = F::D;
    constexpr int S = T::S;
    const int slice = blockIdx.x * blockDim.x + threadIdx.x;
    if (slice >= B) {
        return;
    }
    Ds u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        u[c] = ds::from_f64(U[(size_t)slice * D + c]);
    }
    for (long long step = 0; step < steps; ++step) {
        Ds acc[S][D];
        Ds o[D];
        unroll<0, S>([&](auto s_) {
            constexpr int s = decltype(s_)::value;
            Ds v[D], k[D];
            stage_input<T, s>(v, u, acc);
            field.eval(v, k);
            add_stage<T, s>(acc, o, u, k, co);
        });
#pragma unroll
        for (int c = 0; c < D; ++c) {
            u[c] = o[c];
        }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
        out[(size_t)slice * D + c] = ds::to_f64(u[c]);
    }
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
    const int threads = B < kSliceThreads ? (B + 31) / 32 * 32
                                          : kSliceThreads;
    const int blocks = (B + threads - 1) / threads;
    return with_tableau(tab, [&](auto t) {
        using T = decltype(t);
        auto kernel = ds_slice_kernel<T, F>;
        if (query != nullptr) {
            return attributes(kernel, threads, 0, query);
        }
        Coefs co;
        if (!fill_coefs<T>(co, coef_hi, coef_lo, n_coef)) {
            return (int)cudaErrorInvalidValue;
        }
        kernel<<<blocks, threads, 0, st>>>(U, out, B, steps, co, field);
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
    const FhnPdeDs field{d_x,     d_y,     pair(hx2), pair(hy2),
                         pair(a), pair(b), pair(k),   pair(inv_tau)};
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
                         map, HopfDs{pair(maxtime)}, query, stream);
}
#endif
