// The classic CG loop's BLAS1 kernels for Hopper (sm_90a): K4-K7.
//
// Replaces (tpusparse/kernels/blas1.py):
//   tps_cg_update_*  <- cg_update_pallas (:162)  K4: x += alpha*p, r -= alpha*Ap, <r, r>
//   tps_p_update_*   <- p_update_pallas (:199)   K5: p = r + beta*p
//   tps_dot_*        <- dot_pallas (:80)         K6: <a, b>
//   tps_axpby_dot_*  <- axpby_dot_pallas (:117)  K7: z = alpha*x + beta*y, <z, z>
//
// What bounds them on this card: HBM bandwidth.  Per element K4 moves 6 words (x, r, p,
// Ap read; x, r written), K5 3, K6 2 and K7 3, against 2-6 flops.  The design is one
// streaming pass over the rows*g elements of a field, a 1-D grid-stride loop: a fixed
// grid of kBlocks blocks (one full wave on the H100's 132 SMs at 8 blocks each), each
// thread walking the field kBlocks*kThreads elements apart, so neighbouring threads touch
// neighbouring addresses.  The grid does not depend on the card, so a dot sums in the same
// order on any card.
//
// alpha and beta are read through a device pointer, as in K1/K2: the host never reads
// them.  Dots go through reduce.cuh's per-block partials and fixed-order final sum, in the
// state's precision.  Every field operation is an explicitly rounded intrinsic, so x, r,
// p and z equal the plain twins (tpusparse_torch/kernels/blas1.py) bit for bit.
//
// In place: K4 updates x and r, K5 updates p.  Each element is read and written by one
// thread, so in place is safe on a GPU; but p and Ap must overlap neither x nor r (the
// wrapper checks).  K7 writes z into its own buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 2048 threads: ptxas keeps each kernel within 32 registers
constexpr int64_t kBlocks = 132 * kBlocksPerSM;

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kBlocks ? (b > 0 ? b : 1) : kBlocks);
}

__device__ __forceinline__ int64_t first_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() { return (int64_t)gridDim.x * blockDim.x; }

// K4: x += alpha*p, r -= alpha*Ap in place, and the partials of <r', r'>.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cg_update_kernel(const T* __restrict__ alpha_ptr, T* __restrict__ x, T* __restrict__ r,
                 const T* __restrict__ p, const T* __restrict__ ap, int64_t n, T* partials) {
  const T alpha = *alpha_ptr;
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    x[k] = add_rn(x[k], mul_rn(alpha, p[k]));
    const T rn = sub_rn(r[k], mul_rn(alpha, ap[k]));
    r[k] = rn;
    acc = fma_rn(rn, rn, acc);
  }
  store_partial(acc, partials);
}

// K5: p = r + beta*p in place.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p_update_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r, T* __restrict__ p,
                int64_t n) {
  const T beta = *beta_ptr;
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    p[k] = add_rn(r[k], mul_rn(beta, p[k]));
  }
}

// K6: the partials of <a, b>.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dot_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t n, T* partials) {
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) acc = fma_rn(a[k], b[k], acc);
  store_partial(acc, partials);
}

// K7: z = alpha*x + beta*y, and the partials of <z, z>.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
axpby_dot_kernel(const T* __restrict__ alpha_ptr, const T* __restrict__ x,
                 const T* __restrict__ beta_ptr, const T* __restrict__ y, T* __restrict__ z,
                 int64_t n, T* partials) {
  const T alpha = *alpha_ptr;
  const T beta = *beta_ptr;
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    const T zk = add_rn(mul_rn(alpha, x[k]), mul_rn(beta, y[k]));
    z[k] = zk;
    acc = fma_rn(zk, zk, acc);
  }
  store_partial(acc, partials);
}

template <typename T>
int cg_update(const void* alpha, void* x, void* r, const void* p, const void* ap, int64_t n,
              void* partials, void* dot, void* stream) {
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  cg_update_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)alpha, (T*)x, (T*)r, (const T*)p,
                                                  (const T*)ap, n, (T*)partials);
  return finish_dot<T>((const T*)partials, blocks, (T*)dot, s);
}

template <typename T>
int p_update(const void* beta, const void* r, void* p, int64_t n, void* stream) {
  p_update_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)r, (T*)p, n);
  return (int)cudaGetLastError();
}

template <typename T>
int run_dot(const void* a, const void* b, int64_t n, void* partials, void* out, void* stream) {
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  dot_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)a, (const T*)b, n, (T*)partials);
  return finish_dot<T>((const T*)partials, blocks, (T*)out, s);
}

template <typename T>
int axpby_dot(const void* alpha, const void* x, const void* beta, const void* y, void* z,
              int64_t n, void* partials, void* dot, void* stream) {
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  axpby_dot_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)alpha, (const T*)x,
                                                  (const T*)beta, (const T*)y, (T*)z, n,
                                                  (T*)partials);
  return finish_dot<T>((const T*)partials, blocks, (T*)dot, s);
}

}  // namespace

extern "C" {

// Number of per-block partials a dot over n elements needs.
int64_t tps_blas1_partials(int64_t n) { return blocks_for(n); }

int tps_cg_update_f32(const void* alpha, void* x, void* r, const void* p, const void* ap,
                      int64_t n, void* partials, void* dot, void* stream) {
  return cg_update<float>(alpha, x, r, p, ap, n, partials, dot, stream);
}

int tps_cg_update_f64(const void* alpha, void* x, void* r, const void* p, const void* ap,
                      int64_t n, void* partials, void* dot, void* stream) {
  return cg_update<double>(alpha, x, r, p, ap, n, partials, dot, stream);
}

int tps_p_update_f32(const void* beta, const void* r, void* p, int64_t n, void* stream) {
  return p_update<float>(beta, r, p, n, stream);
}

int tps_p_update_f64(const void* beta, const void* r, void* p, int64_t n, void* stream) {
  return p_update<double>(beta, r, p, n, stream);
}

int tps_dot_f32(const void* a, const void* b, int64_t n, void* partials, void* out,
                void* stream) {
  return run_dot<float>(a, b, n, partials, out, stream);
}

int tps_dot_f64(const void* a, const void* b, int64_t n, void* partials, void* out,
                void* stream) {
  return run_dot<double>(a, b, n, partials, out, stream);
}

int tps_axpby_dot_f32(const void* alpha, const void* x, const void* beta, const void* y,
                      void* z, int64_t n, void* partials, void* dot, void* stream) {
  return axpby_dot<float>(alpha, x, beta, y, z, n, partials, dot, stream);
}

int tps_axpby_dot_f64(const void* alpha, const void* x, const void* beta, const void* y,
                      void* z, int64_t n, void* partials, void* dot, void* stream) {
  return axpby_dot<double>(alpha, x, beta, y, z, n, partials, dot, stream);
}

}  // extern "C"
