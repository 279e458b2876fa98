// Fine fan-out of the parareal driver: fixed-step explicit Runge-Kutta for
// B time slices, all steps in one kernel, in native f64, as
// (t0s, t1s, U) -> U(t1). Two kernels:
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
// here each field is a functor.
//
// Both kernels are templates over a tableau of tableaus.cuh (RK1, RK2, RK4,
// RK8, generated from nngparareal_torch/ops/butcher.py, bitwise its
// doubles) and a field. Each step is straight-line code: the stage loop is
// unrolled at compile time, the zero coefficients vanish there, and no
// tableau is read from memory. Stage sums look ahead: as soon as k_j is
// ready, (h a_ij) k_j goes into a running sum for every later stage i with
// a_ij != 0, and b_j k_j into the weight sum. Every sum starts at u (the
// weight sum at its first term) and takes its terms in increasing j:
// exactly the order of nngparareal_torch/ops/rk.py:rk_step, so nothing is
// rounded otherwise. Only the last term of a stage's sum waits for the
// stage before it; the others overlap the next evaluation.
//
// Per-cell design (PDE fields): one thread block per slice and one thread
// per grid cell (blockDim.x == cells, at most 512). A thread keeps its
// cell's state (one value for Burgers, one per species for FHN-PDE) and its
// running sums in registers for the whole integration. Each stage's input
// goes to shared memory; after one __syncthreads() every thread reads its
// periodic neighbours there and evaluates the field. The exchange is
// double-buffered, so one barrier per stage suffices. Before the barrier a
// thread adds only the term the next stage waits for (one FMA a value);
// the previous stage's other terms are added after it, beside the loads.
// nvcc contracts a*b+c into FMAs here, so this kernel agrees with the
// torch integrator to rounding, not bitwise.
//
// Per-slice design (ODE fields): an ODE field reads only its own slice's
// state, so a thread integrates one slice alone, its d <= 4 state values
// and its running sums in registers, with no exchange and no barrier.
// DblPend and ThomasLabyrinth give a slice four lanes instead: each sine or
// cosine ends in a branch of the math library, so in one thread they ran
// one after another; the lanes compute them at once and exchange them
// (__shfl_sync), and all four carry the same state. Blocks of 64 threads,
// so that B=512 spreads over 8 SMs; the Table-2 shapes (B <= 50) and the
// coarse solves (B=1) are one block. Its
// arithmetic is rounded op by op (the Ieee type below: no FMA
// contraction), in the order of the torch fields
// (nngparareal_torch/systems/odes.py), so that for the polynomial fields
// it gives the torch CPU integrator's values bit for bit; DblPend and
// ThomasLabyrinth differ by CUDA's sin and cos (within 2 ulp). The map of
// a [-1,1]-normalised field is a template argument, resolved outside the
// step loop. FHN's x / 3 and Hopf's u2 / maxtime divide by a constant
// through its correctly rounded reciprocal and FMA corrections (div_by):
// the correctly rounded quotient, as __ddiv_rn gives it, in straight-line
// code, without __ddiv_rn's branch to its slow path.
//
// Each slice steps with its own h = (t1s[b] - t0s[b]) / steps, so slices
// of unequal width are integrated correctly. The fields are autonomous
// (Hopf carries time as its third coordinate): stage times are never
// formed.
//
// What bounds them (chip_smoke.py:bound, the largest of f64 operations
// over the 34 TFLOP/s peak, bytes over the memory rate, and the chain: the
// steps times the dependent operations through one step at the card's
// latencies, which this file's latency probe measures). Bytes never: the
// state is read once and written once. Measured on an NVIDIA H100 80GB
// HBM3 at 700.00 W (time_kernels.py and chip_smoke.py; PERF.md section 6):
//   * FHN-PDE (B=512, d=512, 195 325 RK8 steps) is bound by operations:
//     867 ms against 376 ms (1312 ms before this design);
//   * Burgers (B=128, d=128, 40 000 RK8 steps) by its chain, with 11
//     exchange rounds a step: 23.3 ms against 19.9 ms (44.4 ms before);
//   * the per-slice kernel by one slice's chain at every path shape, which
//     no number of threads shortens: Hopf (B=32, 5440 RK8 steps) 3.3 ms
//     against 3.0 ms, Hopf at B=512 with 3.4e6 steps 2.06 s against
//     1.87 s, Rossler (B=40, 112 500 RK4 steps) 20.2 ms against 17.6 ms,
//     DblPend (B=32, 6790 RK8 steps) 17.9 ms against 9.6 ms, its sines'
//     latency (238.8 cycles against 8.1 for an add) the rest
//     (12.2, 7600, 35.0 and 53.9 ms before).

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "rk_common.cuh"
#include "tableaus.cuh"

namespace {

constexpr int kMaxThreads = 512;

// Stage I's input: its running sum, or u where row I of a is all zero.
template <class T, int I, class Num, int D>
__device__ __forceinline__ void stage_input(Num (&v)[D], const Num (&u)[D],
                                            const Num (&acc)[T::S][D])
{
#pragma unroll
    for (int c = 0; c < D; ++c) {
        if constexpr (first_a<T>(I) < 0) {
            v[c] = u[c];
        } else {
            v[c] = acc[I][c];
        }
    }
}

// (h a_iJ) k_J into the running sums of stages i = Lo .. Hi-1 with
// a_iJ != 0, each started at u: rk_step's ui = ui + hc * ks[j] with
// hc = h * a_ij, one term of its left-to-right sum.
template <class T, int J, int Lo, int Hi, class Num, int D>
__device__ __forceinline__ void add_terms(Num (&acc)[T::S][D],
                                          const Num (&u)[D],
                                          const Num (&k)[D], Num h)
{
    unroll<Lo, Hi>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        if constexpr (nz_a<T>(i, J)) {
            const Num ha = h * Num(tab_a<T>(i, J));
#pragma unroll
            for (int c = 0; c < D; ++c) {
                if constexpr (first_a<T>(i) == J) {
                    acc[i][c] = u[c] + ha * k[c];
                } else {
                    acc[i][c] = acc[i][c] + ha * k[c];
                }
            }
        }
    });
}

// b_J k_J into the weight sum: rk_step's acc, which starts at its first
// nonzero term (not at 0.0 + term).
template <class T, int J, class Num, int D>
__device__ __forceinline__ void add_weight(Num (&bsum)[D], const Num (&k)[D])
{
    if constexpr (nz_b<T>(J)) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
            const Num term = Num(tab_b<T>(J)) * k[c];
            if constexpr (first_b<T>() == J) {
                bsum[c] = term;
            } else {
                bsum[c] = bsum[c] + term;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// One thread per cell: the PDE fields
// ---------------------------------------------------------------------------

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

template <class F>
__device__ __forceinline__ void exchange_store(double* sb, int n, int i,
                                               const double (&v)[F::V])
{
#pragma unroll
    for (int c = 0; c < F::V; ++c) {
        sb[c * n + i] = v[c];
    }
}

// One block per SM is enough to ask for: ptxas then gives FHN-PDE at RK8
// its 90 registers (2 blocks per SM). Left to aim higher, it cuts them to
// 78 for 3 blocks and the kernel runs 10 % slower, and FHN-PDE at RK1
// spills (H100: 867 against 954 ms per 195 325-step fan-out).
template <class T, class F>
__global__ void __launch_bounds__(kMaxThreads, 1)
rk_fanout_kernel(const double* __restrict__ t0s,
                 const double* __restrict__ t1s,
                 const double* __restrict__ U,
                 double* __restrict__ out,
                 long long steps, F field)
{
    constexpr int V = F::V;
    constexpr int S = T::S;
    extern __shared__ double buf[];  // 2*V*n stage inputs, double-buffered

    const int slice = blockIdx.x;
    const int i = threadIdx.x;
    const int n = blockDim.x;      // cells per slice
    const double h = (t1s[slice] - t0s[slice]) / (double)steps;
    const typename F::Stencil st = field.stencil(i, n);
    const size_t base = (size_t)slice * V * n + i;

    double u[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
        u[c] = U[base + (size_t)c * n];
    }
    double* sb = buf;              // this stage's half of the exchange
    double* sb_next = buf + V * n;

    for (long long step = 0; step < steps; ++step) {
        double acc[S][V];  // acc[i]: stage i's input, summed as k_j arrive
        double bsum[V];
        double k[V];
        // h made opaque once a step: each h * a_ij is formed where it is
        // used, not held in registers across the loop (39 of them at RK8)
        double hs = h;
        asm volatile("" : "+d"(hs));
        exchange_store<F>(sb, n, i, u);
        unroll<0, S>([&](auto s_) {
            constexpr int s = decltype(s_)::value;
            __syncthreads();
            double v[V];
            stage_input<T, s>(v, u, acc);
            if constexpr (s > 0) {
                // k_(s-1)'s terms that no stage waits for yet, beside the
                // neighbours' loads
                add_terms<T, s - 1, s + 1, S>(acc, u, k, hs);
                add_weight<T, s - 1>(bsum, k);
            }
            field.eval(sb, n, st, v, k);
            double* const done = sb;
            sb = sb_next;
            sb_next = done;
            if constexpr (s + 1 < S) {
                // the term stage s+1 waits for, then its input to the
                // exchange
                add_terms<T, s, s + 1, s + 2>(acc, u, k, hs);
                double w[V];
                stage_input<T, s + 1>(w, u, acc);
                exchange_store<F>(sb, n, i, w);
            }
        });
        add_weight<T, S - 1>(bsum, k);
#pragma unroll
        for (int c = 0; c < V; ++c) {
            u[c] = u[c] + h * bsum[c];
        }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
        out[base + (size_t)c * n] = u[c];
    }
}

// Launches the per-cell kernel, or with `query` set reports its
// attributes instead.
template <class F>
int launch_cells(const double* t0s, const double* t1s, const double* U,
                 double* out, int tab, int B, int n, long long steps,
                 const F& field, int* query, void* stream)
{
    if (B <= 0 || n <= 0 || n > kMaxThreads || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_tableau(tab, [&](auto t) {
        using T = decltype(t);
        const size_t shmem = (size_t)2 * F::V * n * sizeof(double);
        auto kernel = rk_fanout_kernel<T, F>;
        if (query != nullptr) {
            return attributes(kernel, n, shmem, query);
        }
        kernel<<<B, n, shmem, st>>>(t0s, t1s, U, out, steps, field);
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

// x / y rounded to nearest, for a divisor y fixed for the launch, from
// y_inv = 1/y rounded to nearest (a host or compile-time IEEE division):
// q = x * y_inv, then `Corrections` times r = x - q*y (exact in one FMA
// once q is within an ulp of x/y) and q = q + r*y_inv rounded. By
// Markstein's theorem the last correction of a q within an ulp gives the
// correctly rounded quotient (no overflow or underflow at these fields'
// magnitudes). For y = 3 the first q is already within an ulp
// (3 * RN(1/3) = 1 - 2^-54), so one correction suffices; any other y takes
// two. __ddiv_rn computes the same quotient, but branches to its slow path
// on a check of its result.
template <int Corrections>
__device__ __forceinline__ Ieee div_by(Ieee x, double y, double y_inv)
{
    double q = __dmul_rn(x.x, y_inv);
#pragma unroll
    for (int c = 0; c < Corrections; ++c) {
        const double r = __fma_rn(-q, y, x.x);
        q = __fma_rn(r, y_inv, q);
    }
    return q;
}

constexpr double kThird = 1.0 / 3.0;  // RN(1/3), folded by the compiler

// The value x of lane `src` of this thread's group of L lanes (the lanes
// of one slice).
template <int L>
__device__ __forceinline__ Ieee lane_value(Ieee x, int src)
{
    return __shfl_sync(0xffffffffu, x.x, src, L);
}

// The raw fields of nngparareal_torch/systems/odes.py, each expression in
// the order of its torch twin.

// FitzHugh-Nagumo ODE (FHNODE._f)
struct FhnOde {
    static constexpr int kLanes = 1;
    static constexpr int D = 2;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const double a = 0.2, b = 0.2, c = 3.0;
        f[0] = c * (u[0] - div_by<1>(u[0] * u[0] * u[0], 3.0, kThird)
                    + u[1]);
        f[1] = -(1.0 / c) * (u[0] - a + b * u[1]);
    }
};

// Rossler attractor (Rossler._f)
struct Rossler {
    static constexpr int kLanes = 1;
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
// is the end of the system's tspan, inv_maxtime its reciprocal rounded to
// nearest. The time coordinate's chain is short (its field is 1), so in
// straight-line code its quotients run ahead of the u0/u1 chain.
struct Hopf {
    static constexpr int kLanes = 1;
    static constexpr int D = 3;
    double maxtime, inv_maxtime;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        const Ieee mu = div_by<2>(u[2], maxtime, inv_maxtime) - u[0] * u[0]
                        - u[1] * u[1];
        f[0] = -u[1] + u[0] * mu;
        f[1] = u[0] + u[1] * mu;
        f[2] = 1.0;
    }
};

// Planar double pendulum (DblPend._f). Its sines and cosines, each behind a
// branch of the math library, would run one after another in one thread;
// three lanes of the slice's four compute them at once and exchange them
// (lane_value); every lane then evaluates the rest alike.
struct DblPend {
    static constexpr int kLanes = 4;
    static constexpr int D = 4;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D], int lane) const
    {
        const Ieee dq = u[0] - u[2];
        // lane 0: sin and cos of dq (sincos gives sin's and cos's values);
        // lanes 1 and 2: sin(u0) and sin(u2)
        double sn, cs;
        sincos(lane == 0 ? dq.x : lane == 1 ? u[0].x : u[2].x, &sn, &cs);
        const Ieee cd = lane_value<kLanes>(cs, 0);
        const Ieee sd = lane_value<kLanes>(sn, 0);
        const Ieee sin0 = lane_value<kLanes>(sn, 1);
        const Ieee sin2 = lane_value<kLanes>(sn, 2);
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
    static constexpr int kLanes = 1;
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
    static constexpr int kLanes = 1;
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D]) const
    {
        f[0] = 10.0 * (u[1] - u[0]);
        f[1] = 28.0 * u[0] - u[1] - u[0] * u[2];
        f[2] = u[0] * u[1] - (8.0 / 3.0) * u[2];
    }
};

// Thomas' cyclically symmetric attractor (ThomasLabyrinth._f): its three
// sines on three lanes at once, as DblPend's.
struct ThomasLabyrinth {
    static constexpr int kLanes = 4;
    static constexpr int D = 3;
    __device__ __forceinline__ void operator()(const Ieee (&u)[D],
                                               Ieee (&f)[D], int lane) const
    {
        const double a = 0.5, b = 10.0;
        const Ieee mine = sin(lane == 0 ? u[1] : lane == 1 ? u[2] : u[0]);
        f[0] = -a * u[0] + b * lane_value<kLanes>(mine, 0);
        f[1] = -a * u[1] + b * lane_value<kLanes>(mine, 1);
        f[2] = -a * u[2] + b * lane_value<kLanes>(mine, 2);
    }
};

// A raw field, and for Mapped its normalisation's affine map
// (nngparareal_torch/systems/base.py:ODE.get_vector_field): the field at a
// normalised state v is raw((v + 1) / 2 * span + mn) * scale, coordinate
// by coordinate; without the map it is raw(v).
template <class Raw, bool Mapped>
struct SliceField {
    static constexpr int D = Raw::D;
    static constexpr int kLanes = Raw::kLanes;
    Raw raw;
    double mn[D], span[D], scale[D];

    __device__ __forceinline__ void raw_eval(const Ieee (&x)[D], Ieee (&f)[D],
                                             int lane) const
    {
        if constexpr (kLanes > 1) {
            raw(x, f, lane);
        } else {
            raw(x, f);
        }
    }

    __device__ __forceinline__ void eval(const Ieee (&v)[D], Ieee (&f)[D],
                                         int lane) const
    {
        if constexpr (!Mapped) {
            raw_eval(v, f, lane);
        } else {
            Ieee x[D];
            // (v + 1) * 0.5 rounds as (v + 1) / 2 does: both are the
            // correctly rounded half; the product spares a division
#pragma unroll
            for (int c = 0; c < D; ++c) {
                x[c] = (v[c] + 1.0) * 0.5 * span[c] + mn[c];
            }
            raw_eval(x, f, lane);
#pragma unroll
            for (int c = 0; c < D; ++c) {
                f[c] = f[c] * scale[c];
            }
        }
    }
};

template <class T, class F>
__global__ void __launch_bounds__(kSliceThreads)
rk_slice_kernel(const double* __restrict__ t0s,
                const double* __restrict__ t1s,
                const double* __restrict__ U,
                double* __restrict__ out,
                int B, long long steps, F field)
{
    constexpr int D = F::D;
    constexpr int S = T::S;
    constexpr int L = F::kLanes;
    const int thread = blockIdx.x * blockDim.x + threadIdx.x;
    const int slice = thread / L;
    const int lane = thread % L;
    if (L == 1 && slice >= B) {
        return;
    }
    // lanes past the last slice integrate it too and store nothing, so
    // that every lane of a warp takes part in the exchanges
    const int row = slice < B ? slice : B - 1;
    const Ieee h = (Ieee(t1s[row]) - Ieee(t0s[row])) / (double)steps;
    Ieee u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        u[c] = U[(size_t)row * D + c];
    }

    for (long long step = 0; step < steps; ++step) {
        Ieee acc[S][D];  // acc[i]: stage i's input, summed as k_j arrive
        Ieee bsum[D];
        unroll<0, S>([&](auto s_) {
            constexpr int s = decltype(s_)::value;
            Ieee v[D];
            Ieee k[D];
            stage_input<T, s>(v, u, acc);
            field.eval(v, k, lane);
            add_terms<T, s, s + 1, S>(acc, u, k, h);
            add_weight<T, s>(bsum, k);
        });
#pragma unroll
        for (int c = 0; c < D; ++c) {
            u[c] = u[c] + h * bsum[c];
        }
    }
    if (slice < B && lane == 0) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
            out[(size_t)slice * D + c] = u[c].x;
        }
    }
}

// map: a host array of 3*D values (mn, then span, then scale, per
// coordinate), or NULL for the identity map. With `query` set, reports the
// instance's attributes instead of launching.
template <bool Mapped, class Raw>
int launch_slice_field(const double* t0s, const double* t1s, const double* U,
                       double* out, int tab, int B, long long steps,
                       const double* map, const Raw& raw, int* query,
                       cudaStream_t st)
{
    constexpr int D = Raw::D;
    using F = SliceField<Raw, Mapped>;
    F field{raw, {}, {}, {}};
    if constexpr (Mapped) {
        for (int c = 0; c < D; ++c) {
            field.mn[c] = map[c];
            field.span[c] = map[D + c];
            field.scale[c] = map[2 * D + c];
        }
    }
    // a warp or two for the small batches, blocks of kSliceThreads beyond
    const int lanes = B * F::kLanes;
    const int threads = lanes < kSliceThreads ? (lanes + 31) / 32 * 32
                                              : kSliceThreads;
    const int blocks = (lanes + threads - 1) / threads;
    return with_tableau(tab, [&](auto t) {
        using T = decltype(t);
        auto kernel = rk_slice_kernel<T, F>;
        if (query != nullptr) {
            return attributes(kernel, threads, 0, query);
        }
        kernel<<<blocks, threads, 0, st>>>(t0s, t1s, U, out, B, steps, field);
        return (int)cudaGetLastError();
    });
}

template <class Raw>
int launch_slices(const double* t0s, const double* t1s, const double* U,
                  double* out, int tab, int B, long long steps,
                  const double* map, const Raw& raw, int* query,
                  void* stream)
{
    if (B <= 0 || steps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (map != nullptr) {
        return launch_slice_field<true>(t0s, t1s, U, out, tab, B, steps, map,
                                        raw, query, st);
    }
    return launch_slice_field<false>(t0s, t1s, U, out, tab, B, steps, map,
                                     raw, query, st);
}

// ---------------------------------------------------------------------------
// Latency probe: the card's cycles per dependent operation, the yardstick of
// the chain bound (chip_smoke.py:chain_bound)
// ---------------------------------------------------------------------------

enum ProbeKind {
    kProbeAdd = 0,   // x = __dadd_rn(x, c)
    kProbeMul = 1,   // x = __dmul_rn(x, c)
    kProbeFma = 2,   // x = __fma_rn(x, c, c - 1)
    kProbeDiv = 3,   // x = __ddiv_rn(x, c)
    kProbeSin = 4,   // x = __dadd_rn(sin(x), c)
    kProbeSync = 5,  // store, __syncthreads(), a neighbour's load
    kProbeAddF32 = 6,  // f32 x = __fadd_rn(x, c): ds_fanout.cu's operations
    kProbeMulF32 = 7,  // f32 x = __fmul_rn(x, c)
    kProbeDivF32 = 8,  // f32 x = __fdiv_rn(x, c)
    kProbeFmaF32 = 9,  // f32 x = __fmaf_rn(x, c, c - 1)
};

template <int K>
__device__ __forceinline__ double probe_op(double x, double c, double e)
{
    if constexpr (K == kProbeAdd) {
        return __dadd_rn(x, c);
    } else if constexpr (K == kProbeMul) {
        return __dmul_rn(x, c);
    } else if constexpr (K == kProbeFma) {
        return __fma_rn(x, c, e);
    } else if constexpr (K == kProbeDiv) {
        return __ddiv_rn(x, c);
    } else {
        return __dadd_rn(::sin(x), c);
    }
}

constexpr int kProbeUnroll = 16;

// One thread runs n dependent operations of one kind (n a multiple of
// kProbeUnroll) between two clock64() reads; kProbeSync runs n exchange
// rounds in a block of blockDim.x threads, double-buffered as the per-cell
// kernel's stage exchange is, and thread 0 reads the clock. cycles[0] gets
// the cycles, sink[0] the chain's value (so that it is not optimised away).
template <int K>
__global__ void latency_probe_kernel(long long n, double c,
                                     long long* __restrict__ cycles,
                                     double* __restrict__ sink)
{
    __shared__ double buf[2][kMaxThreads];
    double x = c + (double)threadIdx.x;
    long long t0, t1;
    if constexpr (K == kProbeSync) {
        const int i = threadIdx.x;
        const int nb = (i + 1 == (int)blockDim.x) ? 0 : i + 1;
        __syncthreads();
        t0 = clock64();
        for (long long q = 0; q < n; q += 2) {
            buf[0][i] = x;
            __syncthreads();
            x = buf[0][nb];
            buf[1][i] = x;
            __syncthreads();
            x = buf[1][nb];
        }
        t1 = clock64();
    } else if constexpr (K == kProbeAddF32 || K == kProbeMulF32
                         || K == kProbeDivF32 || K == kProbeFmaF32) {
        float xf = (float)x;
        const float cf = (float)c;
        const float ef = cf - 1.0f;
        t0 = clock64();
        for (long long q = 0; q < n; q += kProbeUnroll) {
#pragma unroll
            for (int r = 0; r < kProbeUnroll; ++r) {
                xf = K == kProbeAddF32   ? __fadd_rn(xf, cf)
                     : K == kProbeMulF32 ? __fmul_rn(xf, cf)
                     : K == kProbeFmaF32 ? __fmaf_rn(xf, cf, ef)
                                         : __fdiv_rn(xf, cf);
            }
        }
        t1 = clock64();
        x = xf;
    } else {
        const double e = c - 1.0;
        t0 = clock64();
        for (long long q = 0; q < n; q += kProbeUnroll) {
#pragma unroll
            for (int r = 0; r < kProbeUnroll; ++r) {
                x = probe_op<K>(x, c, e);
            }
        }
        t1 = clock64();
    }
    if (threadIdx.x == 0) {
        cycles[0] = t1 - t0;
        sink[0] = x;
    }
}

}  // namespace

// The latency probe (kind: a ProbeKind; threads: 1, or the block size of a
// kProbeSync round). cycles (1 long long) and sink (1 double) are device
// pointers.
extern "C" int rk_latency_probe_launch(int kind, long long n, int threads,
                                       double c, long long* cycles,
                                       double* sink, void* stream)
{
    if (n <= 0 || n % kProbeUnroll != 0 || threads <= 0
        || threads > kMaxThreads || (kind != kProbeSync && threads != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kProbeAdd:
            latency_probe_kernel<kProbeAdd><<<1, 1, 0, st>>>(n, c, cycles,
                                                             sink);
            break;
        case kProbeMul:
            latency_probe_kernel<kProbeMul><<<1, 1, 0, st>>>(n, c, cycles,
                                                             sink);
            break;
        case kProbeFma:
            latency_probe_kernel<kProbeFma><<<1, 1, 0, st>>>(n, c, cycles,
                                                             sink);
            break;
        case kProbeDiv:
            latency_probe_kernel<kProbeDiv><<<1, 1, 0, st>>>(n, c, cycles,
                                                             sink);
            break;
        case kProbeSin:
            latency_probe_kernel<kProbeSin><<<1, 1, 0, st>>>(n, c, cycles,
                                                             sink);
            break;
        case kProbeAddF32:
            latency_probe_kernel<kProbeAddF32><<<1, 1, 0, st>>>(n, c, cycles,
                                                                sink);
            break;
        case kProbeMulF32:
            latency_probe_kernel<kProbeMulF32><<<1, 1, 0, st>>>(n, c, cycles,
                                                                sink);
            break;
        case kProbeDivF32:
            latency_probe_kernel<kProbeDivF32><<<1, 1, 0, st>>>(n, c, cycles,
                                                                sink);
            break;
        case kProbeFmaF32:
            latency_probe_kernel<kProbeFmaF32><<<1, 1, 0, st>>>(n, c, cycles,
                                                                sink);
            break;
        case kProbeSync:
            latency_probe_kernel<kProbeSync><<<1, threads, 0, st>>>(
                n, c, cycles, sink);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Plain C entry points, bound from Python with ctypes
// (nngparareal_torch/ops/rk_cuda.py). t0s, t1s (B), U and out (B, d) are
// device pointers to contiguous f64 arrays; tableau is an id of
// tableaus.cuh; an ODE field's map is a host array. Each launches on
// `stream` and returns the cudaError_t of the launch (0 = ok); with
// `query` set (an int[4]) each launches nothing and reports the instance
// it would launch: registers a thread, local memory a thread in bytes,
// resident blocks per SM, threads a block.

// Burgers: d grid points per slice, one thread each.
extern "C" int rk_fanout_burgers_launch(const double* t0s, const double* t1s,
                                        const double* U, double* out,
                                        int tableau, int B, int d,
                                        long long steps, double inv_h2,
                                        double half_inv_2h, int* query,
                                        void* stream)
{
    const BurgersField field{inv_h2, half_inv_2h};
    return launch_cells(t0s, t1s, U, out, tableau, B, d, steps, field, query,
                        stream);
}

// FHN-PDE: d = 2 * d_y * d_x values per slice, one thread per cell.
extern "C" int rk_fanout_fhn_pde_launch(const double* t0s, const double* t1s,
                                        const double* U, double* out,
                                        int tableau, int B, int d_x, int d_y,
                                        long long steps, double inv_hx2,
                                        double inv_hy2, double a, double b,
                                        double k, double inv_tau, int* query,
                                        void* stream)
{
    if (d_x <= 0 || d_y <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const FhnPdeField field{d_x, d_y, inv_hx2, inv_hy2, a, b, k, inv_tau};
    return launch_cells(t0s, t1s, U, out, tableau, B, d_x * d_y, steps,
                        field, query, stream);
}

// ODE fields: D = 2, 3 or 4 state values per slice, one thread per slice.
// map: a host array of 3*D values (mn, span, scale per coordinate) for a
// [-1,1]-normalised system, or NULL for the raw field.
#define RK_SLICE_ENTRY(kind, Raw)                                           \
    extern "C" int rk_slice_##kind##_launch(                                \
        const double* t0s, const double* t1s, const double* U, double* out, \
        int tableau, int B, long long steps, const double* map, int* query, \
        void* stream)                                                       \
    {                                                                       \
        return launch_slices(t0s, t1s, U, out, tableau, B, steps, map,      \
                             Raw{}, query, stream);                         \
    }

RK_SLICE_ENTRY(fhn_ode, FhnOde)
RK_SLICE_ENTRY(rossler, Rossler)
RK_SLICE_ENTRY(dblpend, DblPend)
RK_SLICE_ENTRY(brusselator, Brusselator)
RK_SLICE_ENTRY(lorenz, Lorenz)
RK_SLICE_ENTRY(tomlab, ThomasLabyrinth)

// Hopf takes the end of its tspan as well: its divisor, whose reciprocal
// is rounded here (the host's IEEE division).
extern "C" int rk_slice_hopf_launch(const double* t0s, const double* t1s,
                                    const double* U, double* out,
                                    int tableau, int B, long long steps,
                                    const double* map, double maxtime,
                                    int* query, void* stream)
{
    const double inv = 1.0 / maxtime;
    if (!std::isfinite(maxtime) || !std::isfinite(inv) || inv == 0.0) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_slices(t0s, t1s, U, out, tableau, B, steps, map,
                         Hopf{maxtime, inv}, query, stream);
}
