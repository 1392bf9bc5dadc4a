// Values-carrying 5-point stencil kernels for Hopper (sm_90a): K8 and K9.
//
// Replaces (tpusparse/kernels/stencil5.py):
//   tps_spmv_stencil5_*          <- spmv_stencil5_pipelined (:432) and
//                                   spmv_stencil5_pallas (:160)                    K8
//   tps_spmv_stencil5_pupdate_*  <- spmv_stencil5_pupdate_pipelined (:564), the fused
//                                   p-update CG pass                               K9
// One kernel backs both K8 entry points: they differ only in how the TPU moved data.
//
// Operator: y = C*x + W*xw + E*xe + N*xn + S*xs, summed left to right as the Pallas kernel
// sums it (:400-406), where planes = (5, rows, g) in the order N, W, C, E, S
// (tpusparse/formats.py) and xn/xs/xw/xe are x's neighbours.  Off-grid neighbours are
// never loaded: their value is 0, which is then multiplied by the plane's coefficient,
// exactly as spmv_stencil5_xla does.  (The Pallas kernel duplicated the edge column
// instead and relied on the zero coefficient; the two agree for finite x.)  N/S beyond the
// band come from the halo rows, or zero when there are none.  Optionally the partials of
// <x, y>.
//
// K9 is the same body with its input formed as p' = r + beta*p (PUpdated of
// stencil5_tile.cuh) and p' stored: it returns p', y = A p' and the partials of <p', y>,
// with the halo rows holding the neighbours' p' rows.  As in K1, p' goes to its own
// buffer: a block forms its neighbours' p' from r and p, which another block must not
// have overwritten.  Off-grid W/E are 0 times the coefficient as in K8; the Pallas K9
// duplicates the edge column (:533-534), which agrees wherever W is 0 in column 0 and E is
// 0 in the last column, as in every matrix a .mtx or make_stencil5 gives.
//
// Four instantiations, planes/state: f32/f32, f64/f64, bf16/f32 and bf16/f64 (the
// stencil5-bf16c operator).  bf16 -> f32/f64 is exact, so bf16 planes that hold the same
// values as f32 planes (5, -1 and 0 do) give the same bits.  Every product and sum is an
// explicitly rounded intrinsic, so y equals the plain twin spmv_stencil5_plain
// (tpusparse_torch/kernels/stencil5.py) bit for bit.
//
// What bounds them on this card: HBM bandwidth.  Per point K8 reads five coefficients and
// x and writes y: 7 words (f32 28 B, bf16c 18 B, f64 56 B) against 9 flops; K9 reads
// five coefficients, r and p and writes p' and y: 9 words (f32 36 B, bf16c 26 B, f64 72
// B).  The design is the tiling of stencil5_tile.cuh (the constant-stencil kernels'
// tiling, so a dot has the same tps_stencil5_partials): coefficient reads are coalesced
// along a row, the input's neighbours re-read through L1/L2.  Index arithmetic is 64-bit:
// the plane extent 5*g^2 at 20480^2 is 2.10e9, 2.3% below INT32_MAX.  No output may alias
// an input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "stencil5_tile.cuh"

namespace {

// plane order of tpusparse/formats.py
constexpr int kN = 0, kW = 1, kC = 2, kE = 3, kS = 4;

// A coefficient in the state's precision; every conversion here is exact.
template <typename T>
__device__ __forceinline__ T widen(float v) { return (T)v; }
template <typename T>
__device__ __forceinline__ T widen(double v) { return (T)v; }
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 v) { return (T)__bfloat162float(v); }

// y = A f for the field f (K8: x as it is; K9: p' = r + beta*p, stored to pout when
// kStoreField), and the partials of <f, y> when partials != nullptr.
template <typename P, typename T, typename F, bool kStoreField>
__device__ __forceinline__ void planes_spmv(const P* __restrict__ planes, const F& f,
                                            const T* __restrict__ hp, const T* __restrict__ hn,
                                            T* __restrict__ y, T* __restrict__ fout,
                                            int64_t rows, int64_t g, T* partials) {
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const int64_t plane = rows * g;
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t i = i0 + t;
      const int64_t k = i * g + j;
      const Neighbours<T> v = gather5<T>(f, hp, hn, i, j, rows, g);
      T out = mul_rn(widen<T>(planes[kC * plane + k]), v.c);
      out = add_rn(out, mul_rn(widen<T>(planes[kW * plane + k]), v.w));
      out = add_rn(out, mul_rn(widen<T>(planes[kE * plane + k]), v.e));
      out = add_rn(out, mul_rn(widen<T>(planes[kN * plane + k]), v.n));
      out = add_rn(out, mul_rn(widen<T>(planes[kS * plane + k]), v.s));
      y[k] = out;
      if (kStoreField) fout[k] = v.c;
      acc = fma_rn(v.c, out, acc);
    }
  }
  if (partials != nullptr) store_partial(acc, partials);
}

// K8: y = A x with coefficient planes, and the partials of <x, y> when partials != nullptr.
template <typename P, typename T>
__global__ void __launch_bounds__(kTX * kTY)
spmv_planes_kernel(const P* __restrict__ planes, const T* __restrict__ x,
                   const T* __restrict__ hp, const T* __restrict__ hn, T* __restrict__ y,
                   int64_t rows, int64_t g, T* partials) {
  planes_spmv<P, T, Field<T>, false>(planes, Field<T>{x}, hp, hn, y, nullptr, rows, g,
                                     partials);
}

// K9: p' = r + beta*p into pout, y = A p' with coefficient planes, and the partials of
// <p', y>.
template <typename P, typename T>
__global__ void __launch_bounds__(kTX * kTY)
pupdate_planes_kernel(const T* __restrict__ beta_ptr, const P* __restrict__ planes,
                      const T* __restrict__ r, const T* __restrict__ p,
                      const T* __restrict__ hp, const T* __restrict__ hn,
                      T* __restrict__ pout, T* __restrict__ y, int64_t rows, int64_t g,
                      T* partials) {
  planes_spmv<P, T, PUpdated<T>, true>(planes, PUpdated<T>{r, p, *beta_ptr}, hp, hn, y, pout,
                                       rows, g, partials);
}

template <typename P, typename T>
int spmv_planes(const void* planes, const void* x, const void* hp, const void* hn, void* y,
                int64_t rows, int64_t g, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  spmv_planes_kernel<P, T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const P*)planes, (const T*)x, (const T*)hp, (const T*)hn, (T*)y, rows, g, part);
  return finish_dot<T>(part, (int64_t)grid.x * grid.y, (T*)dot, s);
}

template <typename P, typename T>
int pupdate_planes(const void* beta, const void* planes, const void* r, const void* p,
                   const void* hp, const void* hn, void* pout, void* y, int64_t rows,
                   int64_t g, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  pupdate_planes_kernel<P, T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)beta, (const P*)planes, (const T*)r, (const T*)p, (const T*)hp, (const T*)hn,
      (T*)pout, (T*)y, rows, g, (T*)partials);
  return finish_dot<T>((const T*)partials, (int64_t)grid.x * grid.y, (T*)dot, s);
}

}  // namespace

extern "C" {

// planes (5, rows, g), x/y (rows, g), halo rows (g) or null; partials sized by
// tps_stencil5_partials, dot (one element) or null for no dot.
int tps_spmv_stencil5_f32(const void* planes, const void* x, const void* hp, const void* hn,
                          void* y, int64_t rows, int64_t g, void* partials, void* dot,
                          void* stream) {
  return spmv_planes<float, float>(planes, x, hp, hn, y, rows, g, partials, dot, stream);
}

int tps_spmv_stencil5_f64(const void* planes, const void* x, const void* hp, const void* hn,
                          void* y, int64_t rows, int64_t g, void* partials, void* dot,
                          void* stream) {
  return spmv_planes<double, double>(planes, x, hp, hn, y, rows, g, partials, dot, stream);
}

int tps_spmv_stencil5_bf16_f32(const void* planes, const void* x, const void* hp,
                               const void* hn, void* y, int64_t rows, int64_t g,
                               void* partials, void* dot, void* stream) {
  return spmv_planes<__nv_bfloat16, float>(planes, x, hp, hn, y, rows, g, partials, dot,
                                           stream);
}

int tps_spmv_stencil5_bf16_f64(const void* planes, const void* x, const void* hp,
                               const void* hn, void* y, int64_t rows, int64_t g,
                               void* partials, void* dot, void* stream) {
  return spmv_planes<__nv_bfloat16, double>(planes, x, hp, hn, y, rows, g, partials, dot,
                                            stream);
}

// beta (one element), planes (5, rows, g), r/p/pout/y (rows, g), halo rows (g) of the
// neighbours' p' or null; partials sized by tps_stencil5_partials, dot (one element).
int tps_spmv_stencil5_pupdate_f32(const void* beta, const void* planes, const void* r,
                                  const void* p, const void* hp, const void* hn, void* pout,
                                  void* y, int64_t rows, int64_t g, void* partials, void* dot,
                                  void* stream) {
  return pupdate_planes<float, float>(beta, planes, r, p, hp, hn, pout, y, rows, g, partials,
                                      dot, stream);
}

int tps_spmv_stencil5_pupdate_f64(const void* beta, const void* planes, const void* r,
                                  const void* p, const void* hp, const void* hn, void* pout,
                                  void* y, int64_t rows, int64_t g, void* partials, void* dot,
                                  void* stream) {
  return pupdate_planes<double, double>(beta, planes, r, p, hp, hn, pout, y, rows, g,
                                        partials, dot, stream);
}

int tps_spmv_stencil5_pupdate_bf16_f32(const void* beta, const void* planes,
                                       const void* r, const void* p, const void* hp,
                                       const void* hn, void* pout, void* y, int64_t rows,
                                       int64_t g, void* partials, void* dot, void* stream) {
  return pupdate_planes<__nv_bfloat16, float>(beta, planes, r, p, hp, hn, pout, y, rows, g,
                                              partials, dot, stream);
}

int tps_spmv_stencil5_pupdate_bf16_f64(const void* beta, const void* planes,
                                       const void* r, const void* p, const void* hp,
                                       const void* hn, void* pout, void* y, int64_t rows,
                                       int64_t g, void* partials, void* dot, void* stream) {
  return pupdate_planes<__nv_bfloat16, double>(beta, planes, r, p, hp, hn, pout, y, rows, g,
                                               partials, dot, stream);
}

}  // extern "C"
