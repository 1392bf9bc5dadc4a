// Constant-coefficient 5-point stencil kernels for Hopper (sm_90a): the three passes of
// the values-free CG solve.
//
// Replaces (tpusparse/kernels/stencil5.py):
//   tps_spmv_stencil5_const_*          <- spmv_stencil5_const_pipelined (:718) and
//                                         spmv_stencil5_const_pallas (:273)        K3
//   tps_stencil5_const_pupdate_dot_*   <- spmv_stencil5_const_pupdate_dot_pipelined
//                                         (:861), recompute-CG pass A               K1
//   tps_cg_const_update_recompute_*    <- cg_const_update_recompute_pipelined
//                                         (:1014), recompute-CG pass B              K2
//
// Operator: y = diag*x + offdiag*(((N + S) + W) + E) on a (rows, g) row band of a g-wide
// grid.  N/S of the band's first/last row come from the halo rows (nullptr = zero, the
// Dirichlet edge); W/E at the grid's side columns are zero.
//
// What bounds them on this card: HBM bandwidth.  Per grid point K3 moves 2 words (x read,
// y write), K1 3 (r, p read; p' write) and K2 5 (x, r, p read; x', r' write), against
// 9-13 flops: far below the H100's ridge point.  The design keeps each word to one trip
// through HBM and leaves the rest simple:
//   - one thread per point of a 32-column by 32-row tile (block 32x8, each thread walks
//     4 rows 8 apart); a warp reads 32 consecutive columns of one row;
//   - neighbour values are read straight from global memory: the W/E and N/S re-reads hit
//     L1/L2, so HBM sees each field once;
//   - out-of-range neighbours are selected away, never multiplied by a 0 mask, so they are
//     never loaded and a NaN outside the band cannot leak in;
//   - all index arithmetic is 64-bit (an f64 field at 20480^2 is 3.36 GB);
//   - dots are deterministic: each block writes one partial (block-wide shuffle tree), and
//     a one-block final-sum kernel adds the partials in a fixed order.  No float atomics,
//     so equal inputs give equal iteration counts from run to run.  Partials accumulate in
//     the state's precision (f32 for f32, f64 for f64), as the TPU kernels did.
//
// What differs from the TPU kernels: their grid ran in order on one core, so they carried
// a slab and its boundary rows from step to step and summed the dot into one scalar
// across steps; here blocks run in any order, in parallel.  So pass A (K1) writes p' into
// a second buffer: the Pallas kernel aliased p' onto p, but a block here rebuilds its
// neighbours' p' from r and p, and another block may already have overwritten that p.
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

namespace {

constexpr int kTX = 32;        // block width: columns
constexpr int kTY = 8;         // block height: thread rows
constexpr int kTileRows = 32;  // grid rows per block; each thread walks kTileRows / kTY
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

// p' = r + beta*p, rounded as PyTorch's `r + beta * p` rounds it.
template <typename T>
__device__ __forceinline__ T pupdate(T r, T p, T beta) {
  return add_rn(r, mul_rn(beta, p));
}

// The stencil input field read as it is (K3: x, K2: p).
template <typename T>
struct Field {
  const T* v;
  __device__ __forceinline__ T operator()(int64_t k) const { return v[k]; }
};

// The stencil input formed on the fly as p' = r + beta*p (K1).
template <typename T>
struct PUpdated {
  const T* r;
  const T* p;
  T beta;
  __device__ __forceinline__ T operator()(int64_t k) const { return pupdate(r[k], p[k], beta); }
};

// (A f)(i, j) for the field f; *center receives f(i, j).
template <typename T, typename F>
__device__ __forceinline__ T stencil_at(const F& f, const T* hp, const T* hn, int64_t i,
                                        int64_t j, int64_t rows, int64_t g, T diag, T offdiag,
                                        T* center) {
  const int64_t k = i * g + j;
  const T zero = T(0);
  const T c = f(k);
  const T n = (i > 0) ? f(k - g) : (hp != nullptr ? hp[j] : zero);
  const T s = (i + 1 < rows) ? f(k + g) : (hn != nullptr ? hn[j] : zero);
  const T w = (j > 0) ? f(k - 1) : zero;
  const T e = (j + 1 < g) ? f(k + 1) : zero;
  *center = c;
  const T nb = add_rn(add_rn(add_rn(n, s), w), e);
  return add_rn(mul_rn(diag, c), mul_rn(offdiag, nb));
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

template <typename T>
__device__ __forceinline__ void store_partial(T acc, T* partials) {
  const T s = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
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

// K1: p' = r + beta*p into pout, and the partials of <p', A p'>.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
pupdate_dot_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r,
                   const T* __restrict__ p, const T* __restrict__ hp, const T* __restrict__ hn,
                   T* __restrict__ pout, int64_t rows, int64_t g, T diag, T offdiag,
                   T* partials) {
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const PUpdated<T> f{r, p, *beta_ptr};
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t i = i0 + t;
      T c;
      const T v = stencil_at(f, hp, hn, i, j, rows, g, diag, offdiag, &c);
      pout[i * g + j] = c;
      acc = fma_rn(c, v, acc);
    }
  }
  store_partial(acc, partials);
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

dim3 grid_for(int64_t rows, int64_t g) {
  return dim3((unsigned)((g + kTX - 1) / kTX), (unsigned)((rows + kTileRows - 1) / kTileRows));
}

template <typename T>
int finish_dot(const T* partials, dim3 grid, T* dot, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dot == nullptr) return (int)err;
  final_sum_kernel<T><<<1, kFinalThreads, 0, stream>>>(
      partials, (int64_t)grid.x * grid.y, dot);
  return (int)cudaGetLastError();
}

template <typename T>
int spmv(const void* x, const void* hp, const void* hn, void* y, int64_t rows, int64_t g,
         double diag, double offdiag, void* partials, void* dot, void* stream) {
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  spmv_kernel<T><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const T*)x, (const T*)hp, (const T*)hn, (T*)y, rows, g, (T)diag, (T)offdiag, part);
  return finish_dot<T>(part, grid, (T*)dot, s);
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
  return finish_dot<T>((const T*)partials, grid, (T*)dot, s);
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
  return finish_dot<T>((const T*)partials, grid, (T*)dot, s);
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
