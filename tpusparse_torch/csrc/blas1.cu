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
// thread walking the field kBlocks*kThreads elements (or vectors) apart, so neighbouring
// threads touch neighbouring addresses.  The grid does not depend on the card, so a dot
// sums in the same order on any card.
//
// K5 and K6 load 16 bytes a thread (float4 / double2), both operands' loads issued before
// the first store or add: one 4-byte load of each operand in flight per thread held too
// few bytes in flight to cover HBM's latency (K5 reached 84% of its bound).  K5's vector
// body gives up the grid-stride loop: one thread per vector, blocks of kVecThreads, as
// many as the field needs (torch.add's layout).  Measured at 20480^2 on the H100
// (tpusparse_torch/bench/blas1_layouts.py), the grid-stride loop with 16-byte loads stayed
// ~5% slower whether it kept 1, 2 or 4 vectors in flight, and whether it wrote in place or
// not; one vector per thread matched torch.add.  K6 keeps the fixed grid, whose few
// partials one block adds at the end: kDotInFlight vectors of a and of b in flight,
// kDotBlocks blocks.  The vector bodies need both operands at the same offset mod 16
// bytes: a scalar head runs up to the first 16-byte boundary, the vectors, then a scalar
// tail.  Operands at different offsets (a view one element in, say) take the scalar body
// (p_update_kernel, dot_kernel); the launcher picks the body from the two pointers.  K4
// and K7 keep the scalar body.
//
// alpha and beta are read through a device pointer, as in K1/K2: the host never reads
// them.  Dots go through reduce.cuh's per-block partials and fixed-order sum, in the
// state's precision: K6 adds its partials inside its one launch (store_partial_and_finish,
// a ticket counter per stream), K4 and K7 launch final_sum_kernel after them.  Every field
// operation is an explicitly rounded intrinsic, so x, r, p and z equal the plain twins
// (tpusparse_torch/kernels/blas1.py) bit for bit, in either body.
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
// K5's vector body: blocks of 128 threads, one 16-byte vector each, as many as the field
constexpr int kVecThreads = 128;
// K6's vector body: 4 vectors of a and of b in flight take 56 registers, so 4 blocks of
// 256 per SM (at 8 blocks, ptxas spilled)
constexpr int kDotInFlight = 4;
constexpr int kDotBlocksPerSM = 4;
constexpr int64_t kDotBlocks = 132 * kDotBlocksPerSM;

// Blocks of kThreads for n elements, at most ``cap``; never fewer than 1.
int blocks_for(int64_t n, int64_t cap = kBlocks) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

__device__ __forceinline__ int64_t first_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() { return (int64_t)gridDim.x * blockDim.x; }

// 16-byte vectors: four floats or two doubles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// The vector body's scalar head: the elements before a's first 16-byte boundary (at most
// n), or -1 when a and b lie at different offsets mod 16 and no body of vectors fits both.
// Tensors' elements are aligned to their size, so the head is a whole number of them.
template <typename T>
int64_t vector_head(const void* a, const void* b, int64_t n) {
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
  if ((pa ^ pb) & 15u) return -1;
  const int64_t head = (int64_t)((16u - (pa & 15u)) & 15u) / (int64_t)sizeof(T);
  return head < n ? head : n;
}

// K5's arithmetic on each lane: r + beta*p, rounded as the twin rounds it.
__device__ __forceinline__ float4 p_update_lanes(float beta, float4 r, float4 p) {
  return make_float4(add_rn(r.x, mul_rn(beta, p.x)), add_rn(r.y, mul_rn(beta, p.y)),
                     add_rn(r.z, mul_rn(beta, p.z)), add_rn(r.w, mul_rn(beta, p.w)));
}
__device__ __forceinline__ double2 p_update_lanes(double beta, double2 r, double2 p) {
  return make_double2(add_rn(r.x, mul_rn(beta, p.x)), add_rn(r.y, mul_rn(beta, p.y)));
}

// K6's running sums: lane j of every vector into acc[j], four sums in f32 and two in f64
// (acc[2] and acc[3] stay 0 there).
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

// K5, scalar body: p = r + beta*p in place, for r and p at different offsets mod 16.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p_update_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r, T* __restrict__ p,
                int64_t n) {
  const T beta = *beta_ptr;
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    p[k] = add_rn(r[k], mul_rn(beta, p[k]));
  }
}

// K5, vector body: thread k of the grid updates vector k, both loads issued before its
// store; the threads k < head update the head elements [0, head), and as many threads the
// tail after the last whole vector.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
p_update_vec_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r,
                    T* __restrict__ p, int64_t n, int64_t head) {
  using V = typename Vec16<T>::type;
  constexpr int64_t kLanes = sizeof(V) / sizeof(T);
  const T beta = *beta_ptr;
  const int64_t k = first_index();
  const int64_t nv = (n - head) / kLanes;
  if (k < nv) {
    const V rk = reinterpret_cast<const V*>(r + head)[k];
    const V pk = reinterpret_cast<const V*>(p + head)[k];
    reinterpret_cast<V*>(p + head)[k] = p_update_lanes(beta, rk, pk);
  }
  const int64_t tail = head + nv * kLanes + k;
  if (k < head) p[k] = add_rn(r[k], mul_rn(beta, p[k]));
  if (tail < n) p[tail] = add_rn(r[tail], mul_rn(beta, p[tail]));
}

// K6, scalar body: <a, b> for a and b at different offsets mod 16, finished in this launch.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dot_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t n, T* partials,
           unsigned int* tickets, T* out) {
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) acc = fma_rn(a[k], b[k], acc);
  store_partial_and_finish(acc, partials, tickets, out);
}

// K6, vector body: a grid-stride loop over vectors, kDotInFlight vectors of a and of b
// loaded before the first add, four running sums per thread (two in f64) added in a fixed
// order; head and tail as in K5 (threads t < head, and as many after the last vector);
// finished in this launch.
template <typename T>
__global__ void __launch_bounds__(kThreads, kDotBlocksPerSM)
dot_vec_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t n, int64_t head,
               T* partials, unsigned int* tickets, T* out) {
  using V = typename Vec16<T>::type;
  constexpr int64_t kLanes = sizeof(V) / sizeof(T);
  T acc[4] = {T(0), T(0), T(0), T(0)};
  const int64_t t = first_index(), stride = grid_stride();
  const int64_t nv = (n - head) / kLanes;
  const int64_t tail = head + nv * kLanes + t;
  if (t < head) acc[0] = fma_rn(a[t], b[t], acc[0]);
  if (tail < n) acc[1] = fma_rn(a[tail], b[tail], acc[1]);
  const V* __restrict__ av = reinterpret_cast<const V*>(a + head);
  const V* __restrict__ bv = reinterpret_cast<const V*>(b + head);
  int64_t k = t;
  for (; k + (kDotInFlight - 1) * stride < nv; k += kDotInFlight * stride) {
    V va[kDotInFlight], vb[kDotInFlight];
#pragma unroll
    for (int u = 0; u < kDotInFlight; ++u) {
      va[u] = av[k + u * stride];
      vb[u] = bv[k + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kDotInFlight; ++u) fma_lanes(acc, va[u], vb[u]);
  }
  for (; k < nv; k += stride) fma_lanes(acc, av[k], bv[k]);
  store_partial_and_finish(add_rn(add_rn(acc[0], acc[1]), add_rn(acc[2], acc[3])), partials,
                           tickets, out);
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
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t head = vector_head<T>(r, p, n);
  if (head >= 0) {
    // one thread per vector; at least one block, whose first threads take head and tail
    const int64_t nv = (n - head) / (int64_t)(16 / sizeof(T));
    const int64_t blocks = (nv + kVecThreads - 1) / kVecThreads;
    p_update_vec_kernel<T><<<(unsigned int)(blocks > 0 ? blocks : 1), kVecThreads, 0, s>>>(
        (const T*)beta, (const T*)r, (T*)p, n, head);
  } else {
    p_update_kernel<T><<<blocks_for(n), kThreads, 0, s>>>((const T*)beta, (const T*)r,
                                                          (T*)p, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_dot(const void* a, const void* b, int64_t n, void* partials, void* out,
            void* tickets, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t head = vector_head<T>(a, b, n);
  if (head >= 0) {
    dot_vec_kernel<T><<<blocks_for(n, kDotBlocks), kThreads, 0, s>>>(
        (const T*)a, (const T*)b, n, head, (T*)partials, (unsigned int*)tickets, (T*)out);
  } else {
    dot_kernel<T><<<blocks_for(n), kThreads, 0, s>>>((const T*)a, (const T*)b, n,
                                                     (T*)partials, (unsigned int*)tickets,
                                                     (T*)out);
  }
  return (int)cudaGetLastError();
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

// Number of per-block partials a dot over n elements needs (K6's vector body uses no more).
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

// tickets: a zeroed unsigned int that no launch running at the same time shares (one per
// stream); the kernel leaves it at 0.
int tps_dot_f32(const void* a, const void* b, int64_t n, void* partials, void* out,
                void* tickets, void* stream) {
  return run_dot<float>(a, b, n, partials, out, tickets, stream);
}

int tps_dot_f64(const void* a, const void* b, int64_t n, void* partials, void* out,
                void* tickets, void* stream) {
  return run_dot<double>(a, b, n, partials, out, tickets, stream);
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
