// Compile-time helpers shared by the fan-out kernels (rk_fanout.cu, in
// f64, and ds_fanout.cu, in double-single): a tableau's coefficients and
// nonzero pattern read in constant expressions, the dispatch on a
// tableau's id, a compile-time unrolled loop, and the card's report of a
// kernel instance's registers and occupancy.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "tableaus.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tableau at compile time
// ---------------------------------------------------------------------------

// A tableau's coefficients and pattern, read in constant expressions (the
// only way device code may read a constexpr array's elements).
template <class T>
__host__ __device__ constexpr double tab_a(int i, int j)
{
    return T::a[i][j];
}
template <class T>
__host__ __device__ constexpr double tab_b(int i)
{
    return T::b[i];
}
template <class T>
__host__ __device__ constexpr bool nz_a(int i, int j)
{
    return T::nz_a[i][j] != 0;
}
template <class T>
__host__ __device__ constexpr bool nz_b(int i)
{
    return T::nz_b[i] != 0;
}
// The first nonzero a_ij of row i (-1: stage i's input is u), and the first
// nonzero b_i: where a running sum takes its first term.
template <class T>
__host__ __device__ constexpr int first_a(int i)
{
    for (int j = 0; j < i; ++j) {
        if (T::nz_a[i][j]) {
            return j;
        }
    }
    return -1;
}
template <class T>
__host__ __device__ constexpr int first_b()
{
    for (int i = 0; i < T::S; ++i) {
        if (T::nz_b[i]) {
            return i;
        }
    }
    return -1;
}

// The pattern is the coefficients' nonzeros, a is strictly lower
// triangular, and some b_i is nonzero.
template <class T>
constexpr bool consistent()
{
    for (int i = 0; i < T::S; ++i) {
        for (int j = 0; j < T::S; ++j) {
            if ((T::a[i][j] != 0.0) != (T::nz_a[i][j] != 0)
                || (j >= i && T::a[i][j] != 0.0)) {
                return false;
            }
        }
        if ((T::b[i] != 0.0) != (T::nz_b[i] != 0)) {
            return false;
        }
    }
    return first_b<T>() >= 0;
}
static_assert(consistent<tableau::RK1>() && consistent<tableau::RK2>()
                  && consistent<tableau::RK4>() && consistent<tableau::RK8>(),
              "tableaus.cuh: a pattern disagrees with its coefficients");

// Calls fn(T{}) for the tableau whose id is `id`.
template <class Fn>
int with_tableau(int id, Fn&& fn)
{
    switch (id) {
        case tableau::RK1::id:
            return fn(tableau::RK1{});
        case tableau::RK2::id:
            return fn(tableau::RK2{});
        case tableau::RK4::id:
            return fn(tableau::RK4{});
        case tableau::RK8::id:
            return fn(tableau::RK8{});
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// fn(integral_constant<int, I>) for I = Lo .. Hi-1, unrolled at compile time
template <int Lo, int Hi, class Fn>
__device__ __forceinline__ void unroll(Fn&& fn)
{
    if constexpr (Lo < Hi) {
        fn(std::integral_constant<int, Lo>{});
        unroll<Lo + 1, Hi>(fn);
    }
}

// The card's registers and occupancy for one kernel instance at a block
// size: query[0] registers a thread, [1] local memory a thread (bytes:
// spills), [2] resident blocks per SM, [3] the block size.
template <class K>
int attributes(K kernel, int threads, size_t shmem, int* query)
{
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) {
        return (int)err;
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, shmem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    query[0] = fa.numRegs;
    query[1] = (int)fa.localSizeBytes;
    query[2] = blocks;
    query[3] = threads;
    return 0;
}

}  // namespace
