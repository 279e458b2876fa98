// Fine fan-out of the parareal driver: fixed-step explicit Runge-Kutta for
// B time slices of a discretised PDE field, all steps in one kernel, in
// native f64. Two fields, both in their [-1,1]-normalised form:
//   * viscous Burgers 1D (d grid points, periodic 3-point stencil);
//   * FitzHugh-Nagumo 2D, two species on a (d_y, d_x) periodic grid with
//     a 5-point Laplacian and a cubic reaction.
//
// Replaces the Pallas TPU kernel nngparareal_tpu/ops/rk_pallas.py
// (make_pallas_fanout_ds, its kernel body _make_kernel). That kernel held the
// state in VMEM as double-single f32 pairs because Mosaic has no f64; Hopper
// has f64 units, so this kernel computes in double and needs no pairs. The
// Pallas kernel re-traced any JAX field; here each field is a functor
// (BurgersField, FhnPdeField) and the RK stage loop, written once, is a
// template over it.
//
// Design: one thread block per slice and one thread per grid cell
// (blockDim.x == cells, at most 512). A thread keeps its cell's state (one
// value for Burgers, one per species for FHN-PDE) and the stage values
// k[0..S-1] of each in registers for the whole integration. Each stage
// writes its input to shared memory; after one __syncthreads() every thread
// reads its periodic neighbours there and evaluates the field. The exchange
// buffer is double-buffered, so one barrier per stage suffices: the next
// stage writes the other half, and the stage after it writes this half only
// once every thread has passed the next stage's barrier.
//
// Coefficients: the wrapper passes the dense tableau (a row-major, then b) as
// one small f64 array. Each block reads it once into shared memory, scaled
// by its own step h = (t1s[b] - t0s[b]) / steps, so slices of unequal width
// are integrated correctly. Zero coefficients are skipped (a block-uniform
// branch), matching the stage sums of the torch f64 integrator
// (nngparareal_torch/ops/rk.py:rk_step). nvcc contracts a*b+c into FMAs, so
// the kernel agrees with that integrator to rounding, not bitwise.
//
// The fields are autonomous: stage times are never formed.
//
// What bounds it on an H100: neither bytes nor f64 operations. Burgers does
// ~189 f64 operations per grid point per RK8 step and FHN-PDE ~499 per cell
// (two species), each in a dependent chain broken by one barrier per stage
// (11 per RK8 step). Burgers' 128 blocks of 128 threads give each SM at
// most four warps; FHN-PDE's 512 blocks of 256 threads run in two waves of
// two blocks per SM (100 registers a thread at RK8). The time per step is
// the latency of the barrier chain; the operation bound (operations / f64
// peak) is below it. At the FHN-PDE run's shapes (B=512, d=512, 195 325
// RK8 steps) that bound is 512*256*195325*499 = 1.28e13 operations over
// 34 TFLOP/s, 376 ms; the kernel took 1305 ms on an H100 SXM at 700 W
// (chip_smoke.py). Bytes are no bound: 4 MB in and out. Later work: pack
// several slices per block, or several cells per thread, to hide latency.

#include <cuda_runtime.h>

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

template <int S, class F>
cudaError_t launch(const double* t0s, const double* t1s, const double* U,
                   double* out, const double* tab, int B, int n,
                   long long steps, const F& field, cudaStream_t stream)
{
    const size_t shmem = (size_t)(2 * S * S + S + 2 * F::V * n)
                         * sizeof(double);
    rk_fanout_kernel<S, F><<<B, n, shmem, stream>>>(t0s, t1s, U, out, tab,
                                                    steps, field);
    return cudaGetLastError();
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
    switch (stages) {
        case 1:
            return (int)launch<1>(t0s, t1s, U, out, tab, B, n, steps, field,
                                  st);
        case 2:
            return (int)launch<2>(t0s, t1s, U, out, tab, B, n, steps, field,
                                  st);
        case 4:
            return (int)launch<4>(t0s, t1s, U, out, tab, B, n, steps, field,
                                  st);
        case 11:
            return (int)launch<11>(t0s, t1s, U, out, tab, B, n, steps, field,
                                   st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry points, bound from Python with ctypes
// (nngparareal_torch/ops/rk_cuda.py). All pointers are device pointers to
// contiguous f64 arrays: t0s, t1s (B), U and out (B, d), tab (S*S + S).
// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = ok).

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
