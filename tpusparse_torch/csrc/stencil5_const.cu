// Constant-coefficient 5-point stencil kernels for Hopper (sm_90a): the passes of the
// values-free CG solve.
//
// Replaces (tpusparse/kernels/stencil5.py):
//   tps_spmv_stencil5_const_*          <- spmv_stencil5_const_pipelined (:718) and
//                                         spmv_stencil5_const_pallas (:273)        K3
//   tps_stencil5_const_pupdate_dot_*   <- spmv_stencil5_const_pupdate_dot_pipelined
//                                         (:861), recompute-CG pass A               K1
//   tps_cg_const_update_recompute_*    <- cg_const_update_recompute_pipelined
//                                         (:1014), recompute-CG pass B              K2
//   tps_stencil5_const_pupdate_spmv_*  <- spmv_stencil5_const_pupdate_pipelined
//                                         (:1154), the fused p-update CG pass      K10
//
// Operator: y = diag*x + offdiag*(((N + S) + W) + E) on a (rows, g) row band of a g-wide
// grid.  N/S of the band's first/last row come from the halo rows (nullptr = zero, the
// Dirichlet edge); W/E at the grid's side columns are zero.
//
// What bounds them on this card: HBM bandwidth.  Per grid point K3 moves 2 words (x read,
// y write), K1 3 (r, p read; p' write), K10 4 (r, p read; p', y write) and K2 5 (x, r, p
// read; x', r' write), against 9-13 flops: far below the H100's ridge point.  The design
// keeps each word to one trip through HBM and leaves the rest simple: the tile and
// neighbour gather of stencil5_tile.cuh (one thread per point, neighbours re-read
// through L1/L2, off-band neighbours selected away, 64-bit indices) and the
// deterministic two-level dot of reduce.cuh (per-block partials, then a one-block sum in
// fixed order).
//
// What differs from the TPU kernels: their grid ran in order on one core, so they carried
// a slab and its boundary rows from step to step and summed the dot into one scalar
// across steps; here blocks run in any order, in parallel.  So pass A (K1) and K10 write
// p' into a second buffer: the Pallas K1 aliased p' onto p, but a block here rebuilds its
// neighbours' p' from r and p (as the Pallas K10 does for its south row, `bot_next`,
// :1118), and another block may already have overwritten that p.  K10 is K1 with y = A p'
// stored too; they share one templated body, so their p' and A p' agree bit for bit.
// Pass B (K2) updates x and r in place: each element is read and written by one thread,
// and neighbours come only from p, which K2 does not write.
//
// A*p must be bit-identical in K1 and K2 (K1's <p', A p'> and K2's r - alpha*A p use the
// same A p).  Both call stencil_at(), and every operation in it and in the p' update is an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, ...), which nvcc never contracts into
// an FMA; plain PyTorch ops round each operation the same way, so the fields also match
// the plain twins in tpusparse_torch/kernels/stencil5.py bit for bit.
//
// Every entry point launches on the stream it is given, allocates nothing (the caller
// passes the partials buffer, sized by tps_stencil5_partials) and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "stencil5_tile.cuh"

namespace {

// (A f)(i, j) for the field f; *center receives f(i, j).
template <typename T, typename F>
__device__ __forceinline__ T stencil_at(const F& f, const T* hp, const T* hn, int64_t i,
                                        int64_t j, int64_t rows, int64_t g, T diag, T offdiag,
                                        T* center) {
  const Neighbours<T> v = gather5<T>(f, hp, hn, i, j, rows, g);
  *center = v.c;
  const T nb = add_rn(add_rn(add_rn(v.n, v.s), v.w), v.e);
  return add_rn(mul_rn(diag, v.c), mul_rn(offdiag, nb));
}

// K3: y = A x, and the partials of <x, y> when partials != nullptr.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
spmv_kernel(const T* __restrict__ x, const T* __restrict__ hp, const T* __restrict__ hn,
            T* __restrict__ y, int64_t rows, int64_t g, T diag, T offdiag, T* partials) {
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const Field<T> f{x};
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t i = i0 + t;
      T c;
      const T v = stencil_at(f, hp, hn, i, j, rows, g, diag, offdiag, &c);
      y[i * g + j] = v;
      acc = fma_rn(c, v, acc);
    }
  }
  if (partials != nullptr) store_partial(acc, partials);
}

// K1 and K10: p' = r + beta*p into pout, y = A p' into y when kStoreY (K10), and the
// partials of <p', A p'>.
template <typename T, bool kStoreY>
__device__ __forceinline__ void pupdate_spmv(const T* __restrict__ beta_ptr,
                                             const T* __restrict__ r, const T* __restrict__ p,
                                             const T* __restrict__ hp, const T* __restrict__ hn,
                                             T* __restrict__ pout, T* __restrict__ y,
                                             int64_t rows, int64_t g, T diag, T offdiag,
                                             T* partials) {
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const PUpdated<T> f{r, p, *beta_ptr};
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t k = (i0 + t) * g + j;
      T c;
      const T v = stencil_at(f, hp, hn, i0 + t, j, rows, g, diag, offdiag, &c);
      pout[k] = c;
      if (kStoreY) y[k] = v;
      acc = fma_rn(c, v, acc);
    }
  }
  store_partial(acc, partials);
}

// K1: p' = r + beta*p into pout, and the partials of <p', A p'>; A p' is never stored.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
pupdate_dot_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r,
                   const T* __restrict__ p, const T* __restrict__ hp, const T* __restrict__ hn,
                   T* __restrict__ pout, int64_t rows, int64_t g, T diag, T offdiag,
                   T* partials) {
  pupdate_spmv<T, false>(beta_ptr, r, p, hp, hn, pout, nullptr, rows, g, diag, offdiag,
                         partials);
}

// K10: p' = r + beta*p into pout, y = A p' into y, and the partials of <p', A p'>.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
pupdate_spmv_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r,
                    const T* __restrict__ p, const T* __restrict__ hp, const T* __restrict__ hn,
                    T* __restrict__ pout, T* __restrict__ y, int64_t rows, int64_t g, T diag,
                    T offdiag, T* partials) {
  pupdate_spmv<T, true>(beta_ptr, r, p, hp, hn, pout, y, rows, g, diag, offdiag, partials);
}

// K2: x += alpha*p, r -= alpha*(A p) in place, and the partials of <r', r'>.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
update_recompute_kernel(const T* __restrict__ alpha_ptr, T* __restrict__ x, T* __restrict__ r,
                        const T* __restrict__ p, const T* __restrict__ hp,
                        const T* __restrict__ hn, int64_t rows, int64_t g, T diag, T offdiag,
                        T* partials) {
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const Field<T> f{p};
  const T alpha = *alpha_ptr;
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t i = i0 + t;
      const int64_t k = i * g + j;
      T c;
      const T ap = stencil_at(f, hp, hn, i, j, rows, g, diag, offdiag, &c);
      x[k] = add_rn(x[k], mul_rn(alpha, c));
      const T rn = sub_rn(r[k], mul_rn(alpha, ap));
      r[k] = rn;
      acc = fma_rn(rn, rn, acc);
    }
  }
  store_partial(acc, partials);
}

template <typename T>
int spmv(const void* x, const void* hp, const void* hn, void* y, int64_t rows, int64_t g,
         double diag, double offdiag, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  spmv_kernel<T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)x, (const T*)hp, (const T*)hn, (T*)y, rows, g, (T)diag, (T)offdiag, part);
  return finish_dot<T>(part, (int64_t)grid.x * grid.y, (T*)dot, s);
}

template <typename T>
int pupdate_dot(const void* beta, const void* r, const void* p, const void* hp,
                const void* hn, void* pout, int64_t rows, int64_t g, double diag,
                double offdiag, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  pupdate_dot_kernel<T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)beta, (const T*)r, (const T*)p, (const T*)hp, (const T*)hn, (T*)pout, rows, g,
      (T)diag, (T)offdiag, (T*)partials);
  return finish_dot<T>((const T*)partials, (int64_t)grid.x * grid.y, (T*)dot, s);
}

template <typename T>
int pupdate_spmv_launch(const void* beta, const void* r, const void* p, const void* hp,
                        const void* hn, void* pout, void* y, int64_t rows, int64_t g,
                        double diag, double offdiag, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  pupdate_spmv_kernel<T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)beta, (const T*)r, (const T*)p, (const T*)hp, (const T*)hn, (T*)pout, (T*)y,
      rows, g, (T)diag, (T)offdiag, (T*)partials);
  return finish_dot<T>((const T*)partials, (int64_t)grid.x * grid.y, (T*)dot, s);
}

template <typename T>
int update_recompute(const void* alpha, void* x, void* r, const void* p, const void* hp,
                     const void* hn, int64_t rows, int64_t g, double diag, double offdiag,
                     void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  update_recompute_kernel<T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)alpha, (T*)x, (T*)r, (const T*)p, (const T*)hp, (const T*)hn, rows, g,
      (T)diag, (T)offdiag, (T*)partials);
  return finish_dot<T>((const T*)partials, (int64_t)grid.x * grid.y, (T*)dot, s);
}

}  // namespace

extern "C" {

const char* tps_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Number of per-block partials a dot over a (rows, g) band needs.
int64_t tps_stencil5_partials(int64_t rows, int64_t g) {
  const dim3 grid = grid_for(rows, g);
  return (int64_t)grid.x * grid.y;
}

// Largest band height one launch covers (gridDim.y is at most 65535).
int64_t tps_stencil5_max_rows(void) { return (int64_t)65535 * kTileRows; }

int tps_spmv_stencil5_const_f32(const void* x, const void* hp, const void* hn, void* y,
                                int64_t rows, int64_t g, double diag, double offdiag,
                                void* partials, void* dot, void* stream) {
  return spmv<float>(x, hp, hn, y, rows, g, diag, offdiag, partials, dot, stream);
}

int tps_spmv_stencil5_const_f64(const void* x, const void* hp, const void* hn, void* y,
                                int64_t rows, int64_t g, double diag, double offdiag,
                                void* partials, void* dot, void* stream) {
  return spmv<double>(x, hp, hn, y, rows, g, diag, offdiag, partials, dot, stream);
}

int tps_stencil5_const_pupdate_dot_f32(const void* beta, const void* r, const void* p,
                                       const void* hp, const void* hn, void* pout,
                                       int64_t rows, int64_t g, double diag, double offdiag,
                                       void* partials, void* dot, void* stream) {
  return pupdate_dot<float>(beta, r, p, hp, hn, pout, rows, g, diag, offdiag, partials, dot,
                            stream);
}

int tps_stencil5_const_pupdate_dot_f64(const void* beta, const void* r, const void* p,
                                       const void* hp, const void* hn, void* pout,
                                       int64_t rows, int64_t g, double diag, double offdiag,
                                       void* partials, void* dot, void* stream) {
  return pupdate_dot<double>(beta, r, p, hp, hn, pout, rows, g, diag, offdiag, partials, dot,
                             stream);
}

int tps_stencil5_const_pupdate_spmv_f32(const void* beta, const void* r, const void* p,
                                        const void* hp, const void* hn, void* pout, void* y,
                                        int64_t rows, int64_t g, double diag, double offdiag,
                                        void* partials, void* dot, void* stream) {
  return pupdate_spmv_launch<float>(beta, r, p, hp, hn, pout, y, rows, g, diag, offdiag,
                                    partials, dot, stream);
}

int tps_stencil5_const_pupdate_spmv_f64(const void* beta, const void* r, const void* p,
                                        const void* hp, const void* hn, void* pout, void* y,
                                        int64_t rows, int64_t g, double diag, double offdiag,
                                        void* partials, void* dot, void* stream) {
  return pupdate_spmv_launch<double>(beta, r, p, hp, hn, pout, y, rows, g, diag, offdiag,
                                     partials, dot, stream);
}

int tps_cg_const_update_recompute_f32(const void* alpha, void* x, void* r, const void* p,
                                      const void* hp, const void* hn, int64_t rows, int64_t g,
                                      double diag, double offdiag, void* partials, void* dot,
                                      void* stream) {
  return update_recompute<float>(alpha, x, r, p, hp, hn, rows, g, diag, offdiag, partials,
                                 dot, stream);
}

int tps_cg_const_update_recompute_f64(const void* alpha, void* x, void* r, const void* p,
                                      const void* hp, const void* hn, int64_t rows, int64_t g,
                                      double diag, double offdiag, void* partials, void* dot,
                                      void* stream) {
  return update_recompute<double>(alpha, x, r, p, hp, hn, rows, g, diag, offdiag, partials,
                                  dot, stream);
}

}  // extern "C"
