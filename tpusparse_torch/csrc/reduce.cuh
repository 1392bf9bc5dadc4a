// The pieces every kernel of tpusparse_torch shares: the storage/compute split, explicitly
// rounded arithmetic, and one deterministic two-level dot product.
//
// Storage and compute: a field is stored as S and computed in compute_t<S>: f32 and f64 in
// themselves, bf16 in f32.  widen() reads a stored value into the compute type (exact),
// narrow<S>() is the one rounding store (round to nearest even), and rnd<S>() rounds a
// compute-type value to S's precision without leaving the compute type.  For f32 and f64
// narrow and rnd are the identity, so their kernels compile as before.
//
// Rounding: every field operation goes through an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, ...), which nvcc never contracts into an FMA, and a bf16 state
// rounds each result to bf16 (rnd<S>) before the next operation uses it, in the order the
// JAX kernel writes them.  Plain PyTorch ops round each operation the same way (eager bf16
// ops compute in f32 and round each result), so a kernel's fields equal its plain twin's
// bit for bit, and two kernels that compute the same expression agree bit for bit.
//
// Dots: each block reduces its threads' running sums in a fixed order (shuffle tree, then
// the warps' sums in order) and writes one partial; the partials are then added in a fixed
// order, either by final_sum_kernel, one block launched after the kernel (finish_dot), or
// in the same launch by the block that finishes last (store_partial_and_finish).  No
// float atomics, so equal inputs give equal dots, and equal CG iteration counts, from run
// to run.  Partials accumulate in the compute type (f32 for f32 and bf16, f64 for f64),
// so final_sum_kernel<float> and store_partial_and_finish<float> serve a bf16 state too.
//
// Everything here has internal linkage (anonymous namespace): each .cu file that includes
// it gets its own copy, and the one library links them side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFinalThreads = 1024;

template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
// the type a field stored as S is computed in
template <typename S>
using compute_t = typename Compute<S>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The one rounding store: v in S, rounded to nearest even.
template <typename S>
__device__ __forceinline__ S narrow(compute_t<S> v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to S's precision, kept in the compute type.
template <typename S>
__device__ __forceinline__ compute_t<S> rnd(compute_t<S> v) { return widen(narrow<S>(v)); }

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

// The field operations of a state stored as S: computed in compute_t<S>, then rounded to S.
template <typename S>
__device__ __forceinline__ compute_t<S> add_s(compute_t<S> a, compute_t<S> b) {
  return rnd<S>(add_rn(a, b));
}
template <typename S>
__device__ __forceinline__ compute_t<S> sub_s(compute_t<S> a, compute_t<S> b) {
  return rnd<S>(sub_rn(a, b));
}
template <typename S>
__device__ __forceinline__ compute_t<S> mul_s(compute_t<S> a, compute_t<S> b) {
  return rnd<S>(mul_rn(a, b));
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

// The sum of partials[0..n) over the block, in a fixed order; valid in thread 0, and every
// thread of the block must call it.  Each thread keeps kLanes running sums and issues
// kLanes loads before adding any, so that kLanes loads are in flight at once: with one
// load in flight the final sum waited out one L2 latency per partial (152 us for the
// 409,600 partials of a 20480^2 dot on the H100, 5% of a CG solve).  Loads go through L2
// (__ldcg): partials written by other blocks of the same launch are never in this SM's L1.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* __restrict__ partials, int64_t n) {
  constexpr int kLanes = 8;
  T acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = T(0);
  const int64_t step = blockDim.x * blockDim.y;
  int64_t k = threadIdx.y * blockDim.x + threadIdx.x;
  for (; k + (kLanes - 1) * step < n; k += kLanes * step) {
    T v[kLanes];  // all loads issued before the first add needs one
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = __ldcg(partials + k + l * step);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] += v[l];
  }
  for (; k < n; k += step) acc[0] += __ldcg(partials + k);
  T s = T(0);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s += acc[l];
  return block_sum(s);
}

// out[0] = sum of partials[0..n), in a fixed order, in a launch of its own.
// One block runs alone, so it may take the whole register file (minBlocks = 1): capped
// at 32 registers for two resident blocks, ptxas serialised the f64 loads again.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads, 1)
final_sum_kernel(const T* __restrict__ partials, int64_t n, T* __restrict__ out) {
  const T s = sum_partials(partials, n);
  if (threadIdx.x == 0) out[0] = s;
}

// The one-launch finish of a dot: store this block's partial, then the block that
// finishes last adds every partial and writes out[0].  Every thread of every block must
// call it, as the kernel's last statement.
//
// Thread 0 stores the partial, fences it to device scope, then draws a ticket with an
// integer atomicAdd on *tickets.  The block that draws ticket nblocks - 1 knows every other
// partial is visible; it sums them with sum_partials, in index order, so the dot does not
// depend on which block finished last and is bitwise repeatable.  It then resets *tickets
// to 0, so the next launch on the stream (or a replay of a CUDA graph) finds it zeroed
// without a host-side reset.  Launches that may run at once (other streams) need counters
// of their own.  It saves finish_dot's second launch.
template <typename T>
__device__ __forceinline__ void store_partial_and_finish(T acc, T* partials,
                                                         unsigned int* tickets, T* out) {
  __shared__ bool last;
  const T s = block_sum(acc);
  const unsigned int nblocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(tickets, 1u) == nblocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const T total = sum_partials((const T*)partials, nblocks);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    out[0] = total;
    *tickets = 0u;
  }
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
