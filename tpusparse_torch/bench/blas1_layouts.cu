// Launch layouts for K5 (p = r + beta*p) and K6 (<a, b>) with 16-byte loads, timed against
// each other by tpusparse_torch/bench/blas1_layouts.py.  Not part of the kernel library:
// the script builds this file on its own.  Fields are 16-byte aligned, n a multiple of
// the vector length.
//
//   tps_layout_pu_gs<U>_*   grid-stride loop over vectors, U vectors of r and of p in
//                           flight, a fixed grid of 132 * BPSM blocks of 256 (BPSM 8, or 4
//                           for U = 4, whose registers do not fit 8)
//   tps_layout_pu_os_*      one vector per thread, blocks of 128, as many as the field
//   tps_layout_dot_gs<U>_*  K6's loop with U vectors of a and of b in flight, finished in
//                           the same launch
// The p_update layouts write to ``out``: pass p itself for the in-place update.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/reduce.cuh"

namespace {

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ float4 lanes(float b, float4 r, float4 p) {
  return make_float4(add_rn(r.x, mul_rn(b, p.x)), add_rn(r.y, mul_rn(b, p.y)),
                     add_rn(r.z, mul_rn(b, p.z)), add_rn(r.w, mul_rn(b, p.w)));
}
__device__ __forceinline__ double2 lanes(double b, double2 r, double2 p) {
  return make_double2(add_rn(r.x, mul_rn(b, p.x)), add_rn(r.y, mul_rn(b, p.y)));
}
__device__ __forceinline__ void fma_lanes(float* acc, float4 a, float4 b) {
  acc[0] = fma_rn(a.x, b.x, acc[0]);
  acc[1] = fma_rn(a.y, b.y, acc[1]);
  acc[2] = fma_rn(a.z, b.z, acc[2]);
  acc[3] = fma_rn(a.w, b.w, acc[3]);
}
__device__ __forceinline__ void fma_lanes(double* acc, double2 a, double2 b) {
  acc[0] = fma_rn(a.x, b.x, acc[0]);
  acc[1] = fma_rn(a.y, b.y, acc[1]);
}

template <typename T, int U, int BPSM>
__global__ void __launch_bounds__(256, BPSM)
pu_gs(const T* __restrict__ bp, const T* r, const T* p, T* out, int64_t nv) {
  using V = typename Vec16<T>::type;
  const T beta = *bp;
  const V* rv = reinterpret_cast<const V*>(r);
  const V* pv = reinterpret_cast<const V*>(p);
  V* ov = reinterpret_cast<V*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; k + (U - 1) * stride < nv; k += U * stride) {
    V rr[U], pp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rr[u] = rv[k + u * stride];
      pp[u] = pv[k + u * stride];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) ov[k + u * stride] = lanes(beta, rr[u], pp[u]);
  }
  for (; k < nv; k += stride) ov[k] = lanes(beta, rv[k], pv[k]);
}

template <typename T>
__global__ void __launch_bounds__(128)
pu_os(const T* __restrict__ bp, const T* r, const T* p, T* out, int64_t nv) {
  using V = typename Vec16<T>::type;
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < nv) {
    const V rk = reinterpret_cast<const V*>(r)[k], pk = reinterpret_cast<const V*>(p)[k];
    reinterpret_cast<V*>(out)[k] = lanes(*bp, rk, pk);
  }
}

template <typename T, int U, int BPSM>
__global__ void __launch_bounds__(256, BPSM)
dot_gs(const T* __restrict__ a, const T* __restrict__ b, int64_t nv, T* partials,
       unsigned int* tickets, T* out) {
  using V = typename Vec16<T>::type;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  const V* av = reinterpret_cast<const V*>(a);
  const V* bv = reinterpret_cast<const V*>(b);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; k + (U - 1) * stride < nv; k += U * stride) {
    V va[U], vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      va[u] = av[k + u * stride];
      vb[u] = bv[k + u * stride];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) fma_lanes(acc, va[u], vb[u]);
  }
  for (; k < nv; k += stride) fma_lanes(acc, av[k], bv[k]);
  store_partial_and_finish(add_rn(add_rn(acc[0], acc[1]), add_rn(acc[2], acc[3])), partials,
                           tickets, out);
}

template <typename T>
int64_t vectors(int64_t n) { return n / (int64_t)(16 / sizeof(T)); }

}  // namespace

#define PU_GS(U, BPSM, T, SUF)                                                          \
  extern "C" int tps_layout_pu_gs##U##_##SUF(const void* b, const void* r, const void* p, \
                                             void* out, int64_t n, void* s) {           \
    pu_gs<T, U, BPSM><<<132 * BPSM, 256, 0, (cudaStream_t)s>>>(                         \
        (const T*)b, (const T*)r, (const T*)p, (T*)out, vectors<T>(n));                 \
    return (int)cudaGetLastError();                                                     \
  }
#define PU_OS(T, SUF)                                                                    \
  extern "C" int tps_layout_pu_os_##SUF(const void* b, const void* r, const void* p,     \
                                        void* out, int64_t n, void* s) {                \
    const int64_t nv = vectors<T>(n);                                                   \
    pu_os<T><<<(unsigned int)((nv + 127) / 128), 128, 0, (cudaStream_t)s>>>(            \
        (const T*)b, (const T*)r, (const T*)p, (T*)out, nv);                            \
    return (int)cudaGetLastError();                                                     \
  }
#define DOT_GS(U, BPSM, T, SUF)                                                         \
  extern "C" int tps_layout_dot_gs##U##_##SUF(const void* a, const void* b, int64_t n,  \
                                              void* part, void* out, void* tickets,     \
                                              void* s) {                                \
    dot_gs<T, U, BPSM><<<132 * BPSM, 256, 0, (cudaStream_t)s>>>(                        \
        (const T*)a, (const T*)b, vectors<T>(n), (T*)part, (unsigned int*)tickets,      \
        (T*)out);                                                                       \
    return (int)cudaGetLastError();                                                     \
  }

PU_GS(1, 8, float, f32)
PU_GS(1, 8, double, f64)
PU_GS(2, 8, float, f32)
PU_GS(2, 8, double, f64)
PU_GS(4, 4, float, f32)
PU_GS(4, 4, double, f64)
PU_OS(float, f32)
PU_OS(double, f64)
DOT_GS(2, 8, float, f32)
DOT_GS(2, 8, double, f64)
DOT_GS(4, 4, float, f32)
DOT_GS(4, 4, double, f64)
