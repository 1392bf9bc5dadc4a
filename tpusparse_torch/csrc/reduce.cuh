// The pieces every kernel of tpusparse_torch shares: explicitly rounded arithmetic, and one
// deterministic two-level dot product.
//
// Rounding: every field operation goes through an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, ...), which nvcc never contracts into an FMA.  Plain PyTorch ops
// round each operation the same way, so a kernel's fields equal its plain twin's bit for
// bit, and two kernels that compute the same expression agree bit for bit.
//
// Dots: each block reduces its threads' running sums in a fixed order (shuffle tree, then
// the warps' sums in order) and writes one partial; final_sum_kernel, one block, adds the
// partials in a fixed order.  No float atomics, so equal inputs give equal dots, and equal
// CG iteration counts, from run to run.  Partials accumulate in the state's precision (f32
// for f32, f64 for f64).
//
// Everything here has internal linkage (anonymous namespace): each .cu file that includes
// it gets its own copy, and the one library links them side by side.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFinalThreads = 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  T total = T(0);
  if (tid == 0) {
    for (int w = 0; w < nwarps; ++w) total += warp_sums[w];
  }
  return total;
}

// The block's partial of a dot, at the block's index in a 1-D or 2-D grid.  Every thread
// of the block must call it (block_sum synchronises the block).
template <typename T>
__device__ __forceinline__ void store_partial(T acc, T* partials) {
  const T s = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// out[0] = sum of partials[0..n), in a fixed order.  Each thread keeps kLanes running
// sums and issues kLanes loads before adding any, so that kLanes loads are in flight at
// once: with one load in flight the kernel waited out one L2 latency per partial (152 us
// for the 409,600 partials of a 20480^2 dot on the H100, 5% of a CG solve).
// One block runs alone, so it may take the whole register file (minBlocks = 1): capped
// at 32 registers for two resident blocks, ptxas serialised the f64 loads again.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads, 1)
final_sum_kernel(const T* __restrict__ partials, int64_t n, T* __restrict__ out) {
  constexpr int kLanes = 8;
  T acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = T(0);
  const int64_t step = blockDim.x;
  int64_t k = threadIdx.x;
  for (; k + (kLanes - 1) * step < n; k += kLanes * step) {
    T v[kLanes];  // all loads issued before the first add needs one
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = partials[k + l * step];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] += v[l];
  }
  for (; k < n; k += step) acc[0] += partials[k];
  T s = T(0);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s += acc[l];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

// After a kernel that wrote nparts partials: check its launch, then (when dot is not null)
// launch the final sum into dot.  Returns the first CUDA error, or 0.
template <typename T>
int finish_dot(const T* partials, int64_t nparts, T* dot, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return (int)err;
  final_sum_kernel<T><<<1, kFinalThreads, 0, stream>>>(partials, nparts, dot);
  return (int)cudaGetLastError();
}

}  // namespace
