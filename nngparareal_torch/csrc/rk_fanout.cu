// Fine fan-out of the parareal driver: fixed-step explicit Runge-Kutta for
// B time slices, all steps in one kernel, in native f64, as
// (t0s, t1s, U) -> U(t1). Two kernels share the RK stage loop's design:
//   * rk_fanout_kernel, one block per slice and one thread per grid cell,
//     for the discretised PDE fields (d >= 64), in their [-1,1]-normalised
//     form: viscous Burgers 1D (periodic 3-point stencil) and
//     FitzHugh-Nagumo 2D (two species on a (d_y, d_x) periodic grid, 5-point
//     Laplacian, cubic reaction);
//   * rk_slice_kernel, one thread per slice, for the d < 64 ODE fields
//     (FHN, Rossler, Hopf, DblPend, Brusselator, Lorenz, ThomasLabyrinth),
//     normalised or not. The parareal driver also launches it at B=1 for
//     each coarse solve of these systems.
//
// Replaces the Pallas TPU kernel nngparareal_tpu/ops/rk_pallas.py
// (make_pallas_fanout_ds, its kernel body _make_kernel), in its "row"
// layout (the PDE fields) and its lane-packed "P" layout (the ODE fields,
// slices in the 128 lanes). That kernel held the state in VMEM as
// double-single f32 pairs because Mosaic has no f64; Hopper has f64 units,
// so these kernels compute in double and need no pairs, no lane packing and
// no padding to a lane multiple. The Pallas kernel re-traced any JAX field;
// here each field is a functor and the RK stage loop, written once per
// kernel, is a template over it and over the stage count S in {1, 2, 4, 11}.
//
// Per-cell design (PDE fields): one thread block per slice and one thread
// per grid cell (blockDim.x == cells, at most 512). A thread keeps its
// cell's state (one value for Burgers, one per species for FHN-PDE) and the
// stage values k[0..S-1] of each in registers for the whole integration.
// Each stage writes its input to shared memory; after one __syncthreads()
// every thread reads its periodic neighbours there and evaluates the field.
// The exchange buffer is double-buffered, so one barrier per stage
// suffices: the next stage writes the other half, and the stage after it
// writes this half only once every thread has passed the next stage's
// barrier.
//
// Per-slice design (ODE fields): an ODE field reads only its own slice's
// state, so a thread integrates one slice alone: its d <= 4 state values
// and the S*d stage values (44 for RK8 at d=4) stay in registers, with no
// exchange and no barrier in the step loop. Blocks of 64 threads, so that
// B=512 spreads over 8 SMs; the Table-2 shapes (B <= 50) and the coarse
// solves (B=1) are one block. Its arithmetic is rounded op by op (the Ieee
// type below: no FMA contraction), in the order of the torch integrator
// (nngparareal_torch/ops/rk.py:rk_step) and of the systems' torch fields
// (nngparareal_torch/systems/odes.py), so that for the polynomial fields it
// gives the torch CPU integrator's values bit for bit; DblPend and
// ThomasLabyrinth differ by CUDA's sin and cos (within 2 ulp).
//
// Coefficients: the wrapper passes the dense tableau (a row-major, then b) as
// one small f64 array, which each block reads once into shared memory. Each
// slice steps with its own h = (t1s[b] - t0s[b]) / steps, so slices of
// unequal width are integrated correctly. Zero coefficients are skipped (a
// block-uniform branch), matching the stage sums of the torch f64
// integrator. In the per-cell kernel nvcc contracts a*b+c into FMAs, so it
// agrees with that integrator to rounding, not bitwise.
//
// The fields are autonomous (Hopf carries time as its third coordinate):
// stage times are never formed.
//
// What bounds them on an H100: neither bytes nor f64 operations. Burgers
// does ~189 f64 operations per grid point per RK8 step and FHN-PDE ~499 per
// cell (two species), each in a dependent chain broken by one barrier per
// stage (11 per RK8 step). Burgers' 128 blocks of 128 threads give each SM
// at most four warps; FHN-PDE's 512 blocks of 256 threads run in two waves
// of two blocks per SM (100 registers a thread at RK8). The time per step
// is the latency of the barrier chain; the operation bound (operations /
// f64 peak) is below it. At the FHN-PDE run's shapes (B=512, d=512,
// 195 325 RK8 steps) that bound is 512*256*195325*499 = 1.28e13 operations
// over 34 TFLOP/s, 376 ms; the kernel took 1305 ms on an H100 SXM at 700 W
// (chip_smoke.py). Bytes are no bound: 4 MB in and out. The per-slice
// kernel at B <= 50 occupies one or two warps of one SM: its time is the
// serial dependency chain of one slice's steps (each op waits for the one
// before it), while the operation bound divides the same work over the
// whole card. Rossler's Table-2 fan-out (B=40, 112 500 RK4 steps) took
// 34.7 ms on an H100 SXM at 700 W, against 0.018 ms of operation bound and
// ~62 ms if all 136 operations of a step ran in one 8-cycle chain
// (chip_smoke.py). Later work: pack several slices per block, or several
// cells per thread, or split a slice's coordinates over threads, to hide
// latency.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;

// [-1,1]-normalised viscous Burgers
// (nngparareal_tpu/systems/pdes.py:Burgers._f_norm11):
//     f(v) = (vp - 2v + vm) * inv_h2 - (v + 1) * (vp - vm) * half_inv_2h
struct BurgersField {
    static constexpr int V = 1;  // state values per cell
    double inv_h2, half_inv_2h;

    struct Stencil {
        int p, m;
    };

    __device__ __forceinline__ Stencil stencil(int i, int n) const
    {
        return {(i + 1 == n) ? 0 : i + 1, (i == 0) ? n - 1 : i - 1};
    }

    __device__ __forceinline__ void eval(const double* sb, int n,
                                         const Stencil& st,
                                         const double (&v)[V],
                                         double (&out)[V]) const
    {
        const double vp = sb[st.p];
        const double vm = sb[st.m];
        const double v_xx = (vp - 2.0 * v[0] + vm) * inv_h2;
        const double v_x = (vp - vm) * half_inv_2h;
        out[0] = v_xx - (v[0] + 1.0) * v_x;
    }
};

// FitzHugh-Nagumo 2D PDE (nngparareal_tpu/systems/pdes.py:FHNPDE._f), with
// L the periodic 5-point Laplacian on the (d_y, d_x) grid:
//     U = a L(u1) + u1 - u1^3 - u2 + k
//     V = (1/tau) (b L(u2) + u1 - u2)
// State of a slice: [u1 row-major, u2 row-major], cells = d_y * d_x each.
//
// The normalised form is the identity map here (bounds [-1, 1], scale 1):
// the torch field evaluates raw((u + 1) / 2 * 2 - 1) * 1, which rounds u
// to the grid of u + 1 (within half an ulp of 1, ~1.1e-16 absolute) before
// the raw field; this kernel evaluates raw(u). The two differ by about one
// ulp per evaluation, far inside the 1e-12 (of max|U|) the kernel is held
// to against the torch version.
struct FhnPdeField {
    static constexpr int V = 2;
    int d_x, d_y;
    double inv_hx2, inv_hy2, a, b, k, inv_tau;

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

    __device__ __forceinline__ double lap(const double* g, double c,
                                          const Stencil& st) const
    {
        const double c2 = 2.0 * c;
        return (g[st.e] - c2 + g[st.w]) * inv_hx2
               + (g[st.nn] - c2 + g[st.s]) * inv_hy2;
    }

    __device__ __forceinline__ void eval(const double* sb, int n,
                                         const Stencil& st,
                                         const double (&v)[V],
                                         double (&out)[V]) const
    {
        const double u1 = v[0];
        const double u2 = v[1];
        const double l1 = lap(sb, u1, st);
        const double l2 = lap(sb + n, u2, st);
        out[0] = a * l1 + u1 - u1 * u1 * u1 - u2 + k;
        out[1] = inv_tau * (b * l2 + u1 - u2);
    }
};

template <int S, class F>
__global__ void __launch_bounds__(kMaxThreads)
rk_fanout_kernel(const double* __restrict__ t0s,
                 const double* __restrict__ t1s,
                 const double* __restrict__ U,
                 double* __restrict__ out,
                 const double* __restrict__ tab,
                 long long steps, F field)
{
    constexpr int V = F::V;
    extern __shared__ double smem[];
    double* a_raw = smem;          // S*S tableau a, to test for zeros
    double* ha = a_raw + S * S;    // S*S h * a_ij
    double* bcoef = ha + S * S;    // S   b_i
    double* buf = bcoef + S;       // 2*V*n stage inputs, double-buffered

    const int slice = blockIdx.x;
    const int i = threadIdx.x;
    const int n = blockDim.x;      // cells per slice
    const double h = (t1s[slice] - t0s[slice]) / (double)steps;

    for (int q = i; q < S * S; q += n) {
        a_raw[q] = tab[q];
        ha[q] = h * tab[q];
    }
    for (int q = i; q < S; q += n) {
        bcoef[q] = tab[S * S + q];
    }
    __syncthreads();

    const typename F::Stencil st = field.stencil(i, n);
    const size_t base = (size_t)slice * V * n + i;

    double u[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
        u[c] = U[base + (size_t)c * n];
    }
    double k[S][V];
    int sel = 0;

    for (long long step = 0; step < steps; ++step) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            double v[V];
#pragma unroll
            for (int c = 0; c < V; ++c) {
                v[c] = u[c];
            }
#pragma unroll
            for (int j = 0; j < s; ++j) {
                if (a_raw[s * S + j] != 0.0) {
#pragma unroll
                    for (int c = 0; c < V; ++c) {
                        v[c] = v[c] + ha[s * S + j] * k[j][c];
                    }
                }
            }
            double* sb = buf + sel * V * n;
#pragma unroll
            for (int c = 0; c < V; ++c) {
                sb[c * n + i] = v[c];
            }
            __syncthreads();
            field.eval(sb, n, st, v, k[s]);
            sel ^= 1;
        }
#pragma unroll
        for (int c = 0; c < V; ++c) {
            double acc = 0.0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const double bs = bcoef[s];
                if (bs != 0.0) {
                    acc = acc + bs * k[s][c];
                }
            }
            u[c] = u[c] + h * acc;
        }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
        out[base + (size_t)c * n] = u[c];
    }
}

// Calls fn(std::integral_constant<int, S>{}) for the stage count of the
// tableau: the kernels are instantiated for the port's RK1, RK2, RK4 and
// RK8 (1, 2, 4 and 11 stages).
template <class Fn>
int with_stages(int stages, Fn&& fn)
{
    switch (stages) {
        case 1:
            return fn(std::integral_constant<int, 1>{});
        case 2:
            return fn(std::integral_constant<int, 2>{});
        case 4:
            return fn(std::integral_constant<int, 4>{});
        case 11:
            return fn(std::integral_constant<int, 11>{});
        default:
            return (int)cudaErrorInvalidValue;
    }
}

template <class F>
int launch_stages(const double* t0s, const double* t1s, const double* U,
                  double* out, const double* tab, int stages, int B, int n,
                  long long steps, const F& field, void* stream)
{
    if (B <= 0 || n <= 0 || n > kMaxThreads || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_stages(stages, [&](auto s) {
        constexpr int S = decltype(s)::value;
        const size_t shmem = (size_t)(2 * S * S + S + 2 * F::V * n)
                             * sizeof(double);
        rk_fanout_kernel<S, F><<<B, n, shmem, st>>>(t0s, t1s, U, out, tab,
                                                    steps, field);
        return (int)cudaGetLastError();
    });
}

// ---------------------------------------------------------------------------
// One thread per slice: the d < 64 ODE fields
// ---------------------------------------------------------------------------

constexpr int kSliceThreads = 64;

// An f64 value whose arithmetic is rounded op by op. __dadd_rn and its kin
// are never contracted into FMAs, so an expression written with Ieee
// operands gives the values of the same expression in torch on the CPU.
struct Ieee {
    double x;
    __device__ __forceinline__ Ieee(double v = 0.0) : x(v) {}
};

__device__ __forceinline__ Ieee operator+(Ieee a, Ieee b)
{
    return __dadd_rn(a.x, b.x);
}
__device__ __forceinline__ Ieee operator-(Ieee a, Ieee b)
{
    return __dsub_rn(a.x, b.x);
}
__device__ __forceinline__ Ieee operator*(Ieee a, Ieee b)
{
    return __dmul_rn(a.x, b.x);
}
__device__ __forceinline__ Ieee operator/(Ieee a, Ieee b)
{
    return __ddiv_rn(a.x, b.x);
}
__device__ __forceinline__ Ieee operator-(Ieee a) { return -a.x; }
__device__ __forceinline__ Ieee sin(Ieee a) { return ::sin(a.x); }
__device__ __forceinline__ Ieee cos(Ieee a) { return ::cos(a.x); }

// The raw fields of nngparareal_torch/systems/odes.py, each expression in
// the order of its torch twin.

// FitzHugh-Nagumo ODE (FHNODE._f)
struct FhnOde {
    static constexpr int D = 2;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const double a = 0.2, b = 0.2, c = 3.0;
        f[0] = c * (u[0] - (u[0] * u[0] * u[0]) / 3.0 + u[1]);
        f[1] = -(1.0 / c) * (u[0] - a + b * u[1]);
    }
};

// Rossler attractor (Rossler._f)
struct Rossler {
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const double a = 0.2, b = 0.2, c = 5.7;
        f[0] = -u[1] - u[2];
        f[1] = u[0] + a * u[1];
        f[2] = b + u[2] * (u[0] - c);
    }
};

// Hopf bifurcation with time as the third coordinate (Hopf._f); maxtime
// is the end of the system's tspan
struct Hopf {
    static constexpr int D = 3;
    double maxtime;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const Ieee mu = u[2] / maxtime - u[0] * u[0] - u[1] * u[1];
        f[0] = -u[1] + u[0] * mu;
        f[1] = u[0] + u[1] * mu;
        f[2] = 1.0;
    }
};

// Planar double pendulum (DblPend._f)
struct DblPend {
    static constexpr int D = 4;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const Ieee dq = u[0] - u[2];
        const Ieee cd = cos(dq);
        const Ieee sd = sin(dq);
        const Ieee sin0 = sin(u[0]);
        const Ieee sin2 = sin(u[2]);
        const Ieee sq1 = u[1] * u[1];
        const Ieee sq3 = u[3] * u[3];
        const Ieee den = -1.0 / (2.0 - cd * cd);
        f[0] = u[1];
        f[1] = den * (sq1 * cd * sd + sq3 * sd + 2.0 * sin0 - cd * sin2);
        f[2] = u[3];
        f[3] = den * (-2.0 * sq1 * sd - sq3 * sd * cd - 2.0 * cd * sin0
                      + 2.0 * sin2);
    }
};

// Brusselator reaction (Brusselator._f)
struct Brusselator {
    static constexpr int D = 2;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const Ieee sq0_u1 = u[0] * u[0] * u[1];
        f[0] = 1.0 + sq0_u1 - 4.0 * u[0];
        f[1] = 3.0 * u[0] - sq0_u1;
    }
};

// Lorenz '63 (Lorenz._f)
struct Lorenz {
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        f[0] = 10.0 * (u[1] - u[0]);
        f[1] = 28.0 * u[0] - u[1] - u[0] * u[2];
        f[2] = u[0] * u[1] - (8.0 / 3.0) * u[2];
    }
};

// Thomas' cyclically symmetric attractor (ThomasLabyrinth._f)
struct ThomasLabyrinth {
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const double a = 0.5, b = 10.0;
        f[0] = -a * u[0] + b * sin(u[1]);
        f[1] = -a * u[1] + b * sin(u[2]);
        f[2] = -a * u[2] + b * sin(u[0]);
    }
};

// The normalisation's affine map (nngparareal_torch/systems/base.py:
// ODE.get_vector_field): the field at a normalised state v is
// raw((v + 1) / 2 * span + mn) * scale, coordinate by coordinate; with
// identity set it is raw(v).
template <int D>
struct Affine {
    int identity;
    double mn[D], span[D], scale[D];
};

template <class Raw>
struct SliceField {
    static constexpr int D = Raw::D;
    Raw raw;
    Affine<D> map;

    __device__ __forceinline__ void eval(const Ieee (&v)[D],
                                         Ieee (&f)[D]) const
    {
        if (map.identity) {
            raw(v, f);
            return;
        }
        Ieee x[D];
        // (v + 1) * 0.5 rounds as (v + 1) / 2 does: both are the correctly
        // rounded half; the product spares a division
#pragma unroll
        for (int c = 0; c < D; ++c) {
            x[c] = (v[c] + 1.0) * 0.5 * map.span[c] + map.mn[c];
        }
        raw(x, f);
#pragma unroll
        for (int c = 0; c < D; ++c) {
            f[c] = f[c] * map.scale[c];
        }
    }
};

template <int S, class F>
__global__ void __launch_bounds__(kSliceThreads)
rk_slice_kernel(const double* __restrict__ t0s,
                const double* __restrict__ t1s,
                const double* __restrict__ U,
                double* __restrict__ out,
                const double* __restrict__ tab,
                int B, long long steps, F field)
{
    constexpr int D = F::D;
    __shared__ double a[S * S];  // the tableau, row-major
    __shared__ double bcoef[S];
    for (int q = threadIdx.x; q < S * S; q += blockDim.x) {
        a[q] = tab[q];
    }
    for (int q = threadIdx.x; q < S; q += blockDim.x) {
        bcoef[q] = tab[S * S + q];
    }
    __syncthreads();

    const int slice = blockIdx.x * blockDim.x + threadIdx.x;
    if (slice >= B) {
        return;
    }
    const Ieee h = (Ieee(t1s[slice]) - Ieee(t0s[slice])) / (double)steps;
    Ieee u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        u[c] = U[(size_t)slice * D + c];
    }
    Ieee k[S][D];

    for (long long step = 0; step < steps; ++step) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            Ieee v[D];
#pragma unroll
            for (int c = 0; c < D; ++c) {
                v[c] = u[c];
            }
#pragma unroll
            for (int j = 0; j < s; ++j) {
                const double aij = a[s * S + j];
                if (aij != 0.0) {
                    const Ieee ha = h * aij;
#pragma unroll
                    for (int c = 0; c < D; ++c) {
                        v[c] = v[c] + ha * k[j][c];
                    }
                }
            }
            field.eval(v, k[s]);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) {
            Ieee acc = 0.0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const double bs = bcoef[s];
                if (bs != 0.0) {
                    acc = acc + bs * k[s][c];
                }
            }
            u[c] = u[c] + h * acc;
        }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
        out[(size_t)slice * D + c] = u[c].x;
    }
}

// map: a host array of 3*D values (mn, then span, then scale, per
// coordinate), or NULL for the identity map.
template <class Raw>
int launch_slices(const double* t0s, const double* t1s, const double* U,
                  double* out, const double* tab, int stages, int B,
                  long long steps, const double* map, const Raw& raw,
                  void* stream)
{
    constexpr int D = Raw::D;
    if (B <= 0 || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    SliceField<Raw> field{raw, Affine<D>{}};
    field.map.identity = (map == nullptr);
    if (map != nullptr) {
        for (int c = 0; c < D; ++c) {
            field.map.mn[c] = map[c];
            field.map.span[c] = map[D + c];
            field.map.scale[c] = map[2 * D + c];
        }
    }
    // a warp or two for the small batches, blocks of kSliceThreads beyond
    const int threads = B < kSliceThreads ? (B + 31) / 32 * 32
                                          : kSliceThreads;
    const int blocks = (B + threads - 1) / threads;
    using F = SliceField<Raw>;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_stages(stages, [&](auto s) {
        constexpr int S = decltype(s)::value;
        rk_slice_kernel<S, F><<<blocks, threads, 0, st>>>(t0s, t1s, U, out,
                                                          tab, B, steps,
                                                          field);
        return (int)cudaGetLastError();
    });
}

}  // namespace

// Plain C entry points, bound from Python with ctypes
// (nngparareal_torch/ops/rk_cuda.py). t0s, t1s (B), U and out (B, d) and
// tab (S*S + S) are device pointers to contiguous f64 arrays; an ODE
// field's map is a host array. Each launches on `stream` and returns the
// cudaError_t of the launch (0 = ok).

// Burgers: d grid points per slice, one thread each.
extern "C" int rk_fanout_burgers_launch(const double* t0s, const double* t1s,
                                        const double* U, double* out,
                                        const double* tab, int stages, int B,
                                        int d, long long steps, double inv_h2,
                                        double half_inv_2h, void* stream)
{
    const BurgersField field{inv_h2, half_inv_2h};
    return launch_stages(t0s, t1s, U, out, tab, stages, B, d, steps, field,
                         stream);
}

// FHN-PDE: d = 2 * d_y * d_x values per slice, one thread per cell.
extern "C" int rk_fanout_fhn_pde_launch(const double* t0s, const double* t1s,
                                        const double* U, double* out,
                                        const double* tab, int stages, int B,
                                        int d_x, int d_y, long long steps,
                                        double inv_hx2, double inv_hy2,
                                        double a, double b, double k,
                                        double inv_tau, void* stream)
{
    if (d_x <= 0 || d_y <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const FhnPdeField field{d_x, d_y, inv_hx2, inv_hy2, a, b, k, inv_tau};
    return launch_stages(t0s, t1s, U, out, tab, stages, B, d_x * d_y, steps,
                         field, stream);
}

// ODE fields: D = 2, 3 or 4 state values per slice, one thread per slice.
// map: a host array of 3*D values (mn, span, scale per coordinate) for a
// [-1,1]-normalised system, or NULL for the raw field.
#define RK_SLICE_ENTRY(kind, Raw)                                           \
    extern "C" int rk_slice_##kind##_launch(                                \
        const double* t0s, const double* t1s, const double* U, double* out, \
        const double* tab, int stages, int B, long long steps,              \
        const double* map, void* stream)                                    \
    {                                                                       \
        return launch_slices(t0s, t1s, U, out, tab, stages, B, steps, map,  \
                             Raw{}, stream);                                \
    }

RK_SLICE_ENTRY(fhn_ode, FhnOde)
RK_SLICE_ENTRY(rossler, Rossler)
RK_SLICE_ENTRY(dblpend, DblPend)
RK_SLICE_ENTRY(brusselator, Brusselator)
RK_SLICE_ENTRY(lorenz, Lorenz)
RK_SLICE_ENTRY(tomlab, ThomasLabyrinth)

// Hopf takes the end of its tspan as well.
extern "C" int rk_slice_hopf_launch(const double* t0s, const double* t1s,
                                    const double* U, double* out,
                                    const double* tab, int stages, int B,
                                    long long steps, const double* map,
                                    double maxtime, void* stream)
{
    return launch_slices(t0s, t1s, U, out, tab, stages, B, steps, map,
                         Hopf{maxtime}, stream);
}
