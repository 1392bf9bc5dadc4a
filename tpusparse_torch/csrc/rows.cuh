// The launch shape of the row kernels (ell.cu, dia.cu): one thread per row, blocks of
// kRowThreads consecutive rows, as many blocks as the rows need (1,638,400 at 20480^2).
// Neighbouring threads hold neighbouring rows, so each slot's or diagonal's loads are
// coalesced.  Against a fixed grid-stride grid of 132 x 8 blocks (the BLAS1 kernels'
// shape), on one NVIDIA H100 80GB HBM3 at 700 W at 20480^2 (the 5-point stencil): 6.77
// against 8.59-10.1 ms for the f32 ELL kernel, 3.99 against 5.23 ms for the f32 DIA
// kernel.  A dot has one partial per block, row_blocks(n) of them.
//
// Internal linkage (anonymous namespace), as in reduce.cuh.  The one exported size query
// of both kernels, extern "C" tps_row_partials(n) = row_blocks(n), is defined once, in
// ell.cu (the library links every .cu into one); the Python wrappers of both kernels
// size their partials with it (kernels/_launch.py, row_partials).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;

int64_t row_blocks(int64_t n) { return n > 0 ? (n + kRowThreads - 1) / kRowThreads : 1; }

__device__ __forceinline__ int64_t row_index() {
  return (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
}

}  // namespace
