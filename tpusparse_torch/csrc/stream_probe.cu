// Streaming probes for Hopper (sm_90a): two kernels that do nothing but move memory, so
// that the measured ceiling of bench/probes.py is the card's and not that of PyTorch's own
// reduction and elementwise kernels.  They replace no TPU kernel.
//
//   tps_probe_read_f32  partials[b] = the sum of block b's share of x   (n read, one word
//                       per block written)
//   tps_probe_copy_f32  dst = src                                       (n read, n written)
//
// Both take 16-byte vectors only: n must be a multiple of 4 and both pointers 16-byte
// aligned (fresh allocations are; the wrapper, tpusparse_torch/kernels/stream_probe.py,
// checks).  The read keeps K6's layout with one stream in place of two: a fixed grid of
// kReadBlocks blocks, a grid-stride loop that issues kReadInFlight vector loads per thread
// before the first add, so as many bytes are in flight as in K6.  The copy keeps K5's: one
// vector per thread, blocks of kCopyThreads, as many as the field needs.  The sums are not
// an oracle: the wrapper's plain twin is torch.sum, and the partials only keep the loads
// from being dead code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kReadThreads = 256;
constexpr int kReadInFlight = 8;
constexpr int kReadBlocksPerSM = 4;
constexpr int64_t kReadBlocks = 132 * kReadBlocksPerSM;
constexpr int kCopyThreads = 128;

int read_blocks(int64_t n) {
  const int64_t b = (n / 4 + kReadThreads - 1) / kReadThreads;
  return (int)(b < kReadBlocks ? (b > 0 ? b : 1) : kReadBlocks);
}

__global__ void __launch_bounds__(kReadThreads, kReadBlocksPerSM)
read_probe_kernel(const float4* __restrict__ x, int64_t nv, float* partials) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; k + (kReadInFlight - 1) * stride < nv; k += kReadInFlight * stride) {
    float4 v[kReadInFlight];  // every load issued before the first add
#pragma unroll
    for (int u = 0; u < kReadInFlight; ++u) v[u] = x[k + u * stride];
#pragma unroll
    for (int u = 0; u < kReadInFlight; ++u) {
      acc[0] += v[u].x;
      acc[1] += v[u].y;
      acc[2] += v[u].z;
      acc[3] += v[u].w;
    }
  }
  for (; k < nv; k += stride) {
    const float4 v = x[k];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  store_partial((acc[0] + acc[1]) + (acc[2] + acc[3]), partials);
}

__global__ void __launch_bounds__(kCopyThreads)
copy_probe_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int64_t nv) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < nv) dst[k] = src[k];
}

}  // namespace

extern "C" {

// Number of partials tps_probe_read_f32 writes for n elements.
int64_t tps_probe_read_partials(int64_t n) { return read_blocks(n); }

int tps_probe_read_f32(const void* x, int64_t n, void* partials, void* stream) {
  read_probe_kernel<<<read_blocks(n), kReadThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, n / 4, (float*)partials);
  return (int)cudaGetLastError();
}

int tps_probe_copy_f32(const void* src, void* dst, int64_t n, void* stream) {
  const int64_t nv = n / 4;
  const int64_t blocks = (nv + kCopyThreads - 1) / kCopyThreads;
  copy_probe_kernel<<<(unsigned int)(blocks > 0 ? blocks : 1), kCopyThreads, 0,
                      (cudaStream_t)stream>>>((const float4*)src, (float4*)dst, nv);
  return (int)cudaGetLastError();
}

}  // extern "C"
