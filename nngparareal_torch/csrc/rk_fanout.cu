// Fine fan-out of the parareal driver: fixed-step explicit Runge-Kutta for
// B time slices of the [-1,1]-normalised viscous Burgers field, all steps in
// one kernel, in native f64.
//
// Replaces the Pallas TPU kernel nngparareal_tpu/ops/rk_pallas.py
// (make_pallas_fanout_ds, its kernel body _make_kernel). That kernel held the
// state in VMEM as double-single f32 pairs because Mosaic has no f64; Hopper
// has f64 units, so this kernel computes in double and needs no pairs.
//
// Design: one thread block per slice and one thread per grid point
// (blockDim.x == d, d <= 512). A thread keeps its point's state and the
// stage values k[0..S-1] in registers for the whole integration. Each stage
// writes its input to shared memory; after one __syncthreads() every thread
// reads its two periodic neighbours and evaluates
//     f(v) = (vp - 2v + vm) * inv_h2 - (v + 1) * (vp - vm) * half_inv_2h
// (nngparareal_tpu/systems/pdes.py:Burgers._f_norm11). The exchange buffer is
// double-buffered, so one barrier per stage suffices: the next stage writes
// the other half, and the stage after it writes this half only once every
// thread has passed the next stage's barrier.
//
// Coefficients: the wrapper passes the dense tableau (a row-major, then b) as
// one small f64 array. Each block reads it once into shared memory, scaled
// by its own step h = (t1s[b] - t0s[b]) / steps, so slices of unequal width
// are integrated correctly. Zero coefficients are skipped (a block-uniform
// branch), matching the stage sums of the torch f64 integrator
// (nngparareal_torch/ops/rk.py:rk_step). nvcc contracts a*b+c into FMAs, so
// the kernel agrees with that integrator to rounding, not bitwise.
//
// The field is autonomous: stage times are never formed.
//
// What bounds it on an H100: neither bytes nor f64 operations. A block does
// ~190 f64 operations per grid point per step, in a dependent chain broken by
// one barrier per stage, and B <= 128 blocks of d = 128 threads fill each SM
// with four warps at most. The time per step is the latency of that chain;
// the operation bound (flops / f64 peak) is far below it. Later work: pack
// several slices per block, or several points per thread, to hide latency.

#include <cuda_runtime.h>

namespace {

template <int S>
__global__ void __launch_bounds__(512)
rk_fanout_burgers_kernel(const double* __restrict__ t0s,
                         const double* __restrict__ t1s,
                         const double* __restrict__ U,
                         double* __restrict__ out,
                         const double* __restrict__ tab,
                         int d, long long steps,
                         double inv_h2, double half_inv_2h)
{
    extern __shared__ double smem[];
    double* a_raw = smem;          // S*S tableau a, to test for zeros
    double* ha = a_raw + S * S;    // S*S h * a_ij
    double* bcoef = ha + S * S;    // S   b_i
    double* buf = bcoef + S;       // 2*d stage inputs, double-buffered

    const int slice = blockIdx.x;
    const int i = threadIdx.x;
    const double h = (t1s[slice] - t0s[slice]) / (double)steps;

    for (int q = i; q < S * S; q += blockDim.x) {
        a_raw[q] = tab[q];
        ha[q] = h * tab[q];
    }
    for (int q = i; q < S; q += blockDim.x) {
        bcoef[q] = tab[S * S + q];
    }
    __syncthreads();

    const int ip = (i + 1 == d) ? 0 : i + 1;
    const int im = (i == 0) ? d - 1 : i - 1;

    double u = U[(size_t)slice * d + i];
    double k[S];
    int sel = 0;

    for (long long n = 0; n < steps; ++n) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            double v = u;
#pragma unroll
            for (int j = 0; j < s; ++j) {
                if (a_raw[s * S + j] != 0.0) {
                    v = v + ha[s * S + j] * k[j];
                }
            }
            double* sb = buf + sel * d;
            sb[i] = v;
            __syncthreads();
            const double vp = sb[ip];
            const double vm = sb[im];
            sel ^= 1;
            const double v_xx = (vp - 2.0 * v + vm) * inv_h2;
            const double v_x = (vp - vm) * half_inv_2h;
            k[s] = v_xx - (v + 1.0) * v_x;
        }
        double acc = 0.0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const double bs = bcoef[s];
            if (bs != 0.0) {
                acc = acc + bs * k[s];
            }
        }
        u = u + h * acc;
    }
    out[(size_t)slice * d + i] = u;
}

template <int S>
cudaError_t launch(const double* t0s, const double* t1s, const double* U,
                   double* out, const double* tab, int B, int d,
                   long long steps, double inv_h2, double half_inv_2h,
                   cudaStream_t stream)
{
    const size_t shmem = (size_t)(2 * S * S + S + 2 * d) * sizeof(double);
    rk_fanout_burgers_kernel<S><<<B, d, shmem, stream>>>(
        t0s, t1s, U, out, tab, d, steps, inv_h2, half_inv_2h);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (nngparareal_torch/ops/rk_cuda.py). All pointers are device pointers to
// contiguous f64 arrays: t0s, t1s (B), U and out (B, d), tab (S*S + S).
// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
extern "C" int rk_fanout_burgers_launch(const double* t0s, const double* t1s,
                                        const double* U, double* out,
                                        const double* tab, int stages, int B,
                                        int d, long long steps, double inv_h2,
                                        double half_inv_2h, void* stream)
{
    if (B <= 0 || d <= 0 || d > 512 || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (stages) {
        case 1:
            return (int)launch<1>(t0s, t1s, U, out, tab, B, d, steps, inv_h2,
                                  half_inv_2h, st);
        case 2:
            return (int)launch<2>(t0s, t1s, U, out, tab, B, d, steps, inv_h2,
                                  half_inv_2h, st);
        case 4:
            return (int)launch<4>(t0s, t1s, U, out, tab, B, d, steps, inv_h2,
                                  half_inv_2h, st);
        case 11:
            return (int)launch<11>(t0s, t1s, U, out, tab, B, d, steps, inv_h2,
                                   half_inv_2h, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
