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
// compute type: K6 adds its partials inside its one launch (store_partial_and_finish,
// a ticket counter per stream), K4 and K7 launch final_sum_kernel after them.  Every field
// operation is an explicitly rounded intrinsic, so x, r, p and z equal the plain twins
// (tpusparse_torch/kernels/blas1.py) bit for bit, in either body.
//
// A bf16 state (tps_*_bf16) is stored in bf16 and computed in f32, rounded to bf16 after
// every operation in the Pallas kernels' order (reduce.cuh): K4 x + (alpha*p) and
// r - (alpha*Ap), K5 r + (beta*p), K7 (alpha*x) + (beta*y), alpha and beta themselves bf16.
// Its dots accumulate in f32 (the products of two bf16 values are exact in f32), so its
// partials, the final sum and the result are f32.  K5's and K6's 16-byte vectors hold 8
// bf16 under the same alignment test.  Per element a bf16 state halves the bytes: K4 12 B,
// K5 6 B, K6 4 B, K7 6 B.
//
// In place: K4 updates x and r, K5 updates p.  Each element is read and written by one
// thread, so in place is safe on a GPU; but p and Ap must overlap neither x nor r (the
// wrapper checks).  K7 writes z into its own buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// 16-byte vectors: four floats, two doubles or eight bf16 (a uint4 of four bf16 pairs).
template <typename S>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
};

// The vector body's scalar head: the elements before a's first 16-byte boundary (at most
// n), or -1 when a and b lie at different offsets mod 16 and no body of vectors fits both.
// Tensors' elements are aligned to their size, so the head is a whole number of them.
template <typename S>
int64_t vector_head(const void* a, const void* b, int64_t n) {
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
  if ((pa ^ pb) & 15u) return -1;
  const int64_t head = (int64_t)((16u - (pa & 15u)) & 15u) / (int64_t)sizeof(S);
  return head < n ? head : n;
}

// K5's arithmetic on one element: r + (beta*p), rounded as the twin rounds it.
template <typename S>
__device__ __forceinline__ S p_update_one(compute_t<S> beta, S r, S p) {
  return narrow<S>(add_rn(widen(r), mul_s<S>(beta, widen(p))));
}

// A pair of bf16 (one 32-bit lane of a uint4) as two floats, and back, rounded.
__device__ __forceinline__ float2 unpack_bf16x2(unsigned int u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(h));
  return __bfloat1622float2(h);
}
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned int u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// K5's arithmetic on each lane of a vector.
__device__ __forceinline__ float4 p_update_lanes(float beta, float4 r, float4 p) {
  return make_float4(add_rn(r.x, mul_rn(beta, p.x)), add_rn(r.y, mul_rn(beta, p.y)),
                     add_rn(r.z, mul_rn(beta, p.z)), add_rn(r.w, mul_rn(beta, p.w)));
}
__device__ __forceinline__ double2 p_update_lanes(double beta, double2 r, double2 p) {
  return make_double2(add_rn(r.x, mul_rn(beta, p.x)), add_rn(r.y, mul_rn(beta, p.y)));
}
__device__ __forceinline__ unsigned int p_update_pair(float beta, unsigned int r,
                                                      unsigned int p) {
  const float2 rv = unpack_bf16x2(r), pv = unpack_bf16x2(p);
  using B = __nv_bfloat16;
  return pack_bf16x2(add_rn(rv.x, mul_s<B>(beta, pv.x)), add_rn(rv.y, mul_s<B>(beta, pv.y)));
}
__device__ __forceinline__ uint4 p_update_lanes(float beta, uint4 r, uint4 p) {
  return make_uint4(p_update_pair(beta, r.x, p.x), p_update_pair(beta, r.y, p.y),
                    p_update_pair(beta, r.z, p.z), p_update_pair(beta, r.w, p.w));
}

// K6's running sums: lane j of every vector into acc[j % 4], four sums in f32 and bf16
// (two lanes of a bf16 vector each, in lane order) and two in f64 (acc[2] and acc[3] stay
// 0 there).
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
__device__ __forceinline__ void fma_lanes(float* acc, uint4 a, uint4 b) {
  const unsigned int av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 x = unpack_bf16x2(av[2 * h + q]), y = unpack_bf16x2(bv[2 * h + q]);
      acc[2 * q] = fma_rn(x.x, y.x, acc[2 * q]);
      acc[2 * q + 1] = fma_rn(x.y, y.y, acc[2 * q + 1]);
    }
  }
}

// K4: x += alpha*p, r -= alpha*Ap in place, and the partials of <r', r'>.
template <typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cg_update_kernel(const S* __restrict__ alpha_ptr, S* __restrict__ x, S* __restrict__ r,
                 const S* __restrict__ p, const S* __restrict__ ap, int64_t n,
                 compute_t<S>* partials) {
  using T = compute_t<S>;
  const T alpha = widen(*alpha_ptr);
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    x[k] = narrow<S>(add_rn(widen(x[k]), mul_s<S>(alpha, widen(p[k]))));
    const T rn = sub_s<S>(widen(r[k]), mul_s<S>(alpha, widen(ap[k])));
    r[k] = narrow<S>(rn);
    acc = fma_rn(rn, rn, acc);
  }
  store_partial(acc, partials);
}

// K5, scalar body: p = r + beta*p in place, for r and p at different offsets mod 16.
template <typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p_update_kernel(const S* __restrict__ beta_ptr, const S* __restrict__ r, S* __restrict__ p,
                int64_t n) {
  const compute_t<S> beta = widen(*beta_ptr);
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    p[k] = p_update_one<S>(beta, r[k], p[k]);
  }
}

// K5, vector body: thread k of the grid updates vector k, both loads issued before its
// store; the threads k < head update the head elements [0, head), and as many threads the
// tail after the last whole vector.
template <typename S>
__global__ void __launch_bounds__(kVecThreads)
p_update_vec_kernel(const S* __restrict__ beta_ptr, const S* __restrict__ r,
                    S* __restrict__ p, int64_t n, int64_t head) {
  using V = typename Vec16<S>::type;
  constexpr int64_t kLanes = sizeof(V) / sizeof(S);
  const compute_t<S> beta = widen(*beta_ptr);
  const int64_t k = first_index();
  const int64_t nv = (n - head) / kLanes;
  if (k < nv) {
    const V rk = reinterpret_cast<const V*>(r + head)[k];
    const V pk = reinterpret_cast<const V*>(p + head)[k];
    reinterpret_cast<V*>(p + head)[k] = p_update_lanes(beta, rk, pk);
  }
  const int64_t tail = head + nv * kLanes + k;
  if (k < head) p[k] = p_update_one<S>(beta, r[k], p[k]);
  if (tail < n) p[tail] = p_update_one<S>(beta, r[tail], p[tail]);
}

// K6, scalar body: <a, b> for a and b at different offsets mod 16, finished in this launch.
template <typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dot_kernel(const S* __restrict__ a, const S* __restrict__ b, int64_t n,
           compute_t<S>* partials, unsigned int* tickets, compute_t<S>* out) {
  compute_t<S> acc = 0;
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    acc = fma_rn(widen(a[k]), widen(b[k]), acc);
  }
  store_partial_and_finish(acc, partials, tickets, out);
}

// K6, vector body: a grid-stride loop over vectors, kDotInFlight vectors of a and of b
// loaded before the first add, four running sums per thread (two in f64) added in a fixed
// order; head and tail as in K5 (threads t < head, and as many after the last vector);
// finished in this launch.
template <typename S>
__global__ void __launch_bounds__(kThreads, kDotBlocksPerSM)
dot_vec_kernel(const S* __restrict__ a, const S* __restrict__ b, int64_t n, int64_t head,
               compute_t<S>* partials, unsigned int* tickets, compute_t<S>* out) {
  using T = compute_t<S>;
  using V = typename Vec16<S>::type;
  constexpr int64_t kLanes = sizeof(V) / sizeof(S);
  T acc[4] = {T(0), T(0), T(0), T(0)};
  const int64_t t = first_index(), stride = grid_stride();
  const int64_t nv = (n - head) / kLanes;
  const int64_t tail = head + nv * kLanes + t;
  if (t < head) acc[0] = fma_rn(widen(a[t]), widen(b[t]), acc[0]);
  if (tail < n) acc[1] = fma_rn(widen(a[tail]), widen(b[tail]), acc[1]);
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
template <typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
axpby_dot_kernel(const S* __restrict__ alpha_ptr, const S* __restrict__ x,
                 const S* __restrict__ beta_ptr, const S* __restrict__ y, S* __restrict__ z,
                 int64_t n, compute_t<S>* partials) {
  using T = compute_t<S>;
  const T alpha = widen(*alpha_ptr);
  const T beta = widen(*beta_ptr);
  T acc = T(0);
  for (int64_t k = first_index(); k < n; k += grid_stride()) {
    const T zk = add_s<S>(mul_s<S>(alpha, widen(x[k])), mul_s<S>(beta, widen(y[k])));
    z[k] = narrow<S>(zk);
    acc = fma_rn(zk, zk, acc);
  }
  store_partial(acc, partials);
}

template <typename S>
int cg_update(const void* alpha, void* x, void* r, const void* p, const void* ap, int64_t n,
              void* partials, void* dot, void* stream) {
  using T = compute_t<S>;
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  cg_update_kernel<S><<<blocks, kThreads, 0, s>>>((const S*)alpha, (S*)x, (S*)r, (const S*)p,
                                                  (const S*)ap, n, (T*)partials);
  return finish_dot<T>((const T*)partials, blocks, (T*)dot, s);
}

template <typename S>
int p_update(const void* beta, const void* r, void* p, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t head = vector_head<S>(r, p, n);
  if (head >= 0) {
    // one thread per vector; at least one block, whose first threads take head and tail
    const int64_t nv = (n - head) / (int64_t)(16 / sizeof(S));
    const int64_t blocks = (nv + kVecThreads - 1) / kVecThreads;
    p_update_vec_kernel<S><<<(unsigned int)(blocks > 0 ? blocks : 1), kVecThreads, 0, s>>>(
        (const S*)beta, (const S*)r, (S*)p, n, head);
  } else {
    p_update_kernel<S><<<blocks_for(n), kThreads, 0, s>>>((const S*)beta, (const S*)r,
                                                          (S*)p, n);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int run_dot(const void* a, const void* b, int64_t n, void* partials, void* out,
            void* tickets, void* stream) {
  using T = compute_t<S>;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t head = vector_head<S>(a, b, n);
  if (head >= 0) {
    dot_vec_kernel<S><<<blocks_for(n, kDotBlocks), kThreads, 0, s>>>(
        (const S*)a, (const S*)b, n, head, (T*)partials, (unsigned int*)tickets, (T*)out);
  } else {
    dot_kernel<S><<<blocks_for(n), kThreads, 0, s>>>((const S*)a, (const S*)b, n,
                                                     (T*)partials, (unsigned int*)tickets,
                                                     (T*)out);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int axpby_dot(const void* alpha, const void* x, const void* beta, const void* y, void* z,
              int64_t n, void* partials, void* dot, void* stream) {
  using T = compute_t<S>;
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  axpby_dot_kernel<S><<<blocks, kThreads, 0, s>>>((const S*)alpha, (const S*)x,
                                                  (const S*)beta, (const S*)y, (S*)z, n,
                                                  (T*)partials);
  return finish_dot<T>((const T*)partials, blocks, (T*)dot, s);
}

}  // namespace

extern "C" {

// Number of per-block partials a dot over n elements needs (K6's vector body uses no more).
int64_t tps_blas1_partials(int64_t n) { return blocks_for(n); }

// Every entry point: alpha/beta in the state's dtype; partials and the dot in the
// compute type (f32 for f32 and bf16, f64 for f64).
#define TPS_BLAS1(SUF, S)                                                                  \
  int tps_cg_update_##SUF(const void* alpha, void* x, void* r, const void* p,             \
                          const void* ap, int64_t n, void* partials, void* dot,            \
                          void* stream) {                                                  \
    return cg_update<S>(alpha, x, r, p, ap, n, partials, dot, stream);                     \
  }                                                                                        \
  int tps_p_update_##SUF(const void* beta, const void* r, void* p, int64_t n,             \
                         void* stream) {                                                   \
    return p_update<S>(beta, r, p, n, stream);                                             \
  }                                                                                        \
  /* tickets: a zeroed unsigned int that no launch running at the same time shares (one   \
     per stream); the kernel leaves it at 0. */                                            \
  int tps_dot_##SUF(const void* a, const void* b, int64_t n, void* partials, void* out,   \
                    void* tickets, void* stream) {                                         \
    return run_dot<S>(a, b, n, partials, out, tickets, stream);                            \
  }                                                                                        \
  int tps_axpby_dot_##SUF(const void* alpha, const void* x, const void* beta,             \
                          const void* y, void* z, int64_t n, void* partials, void* dot,    \
                          void* stream) {                                                  \
    return axpby_dot<S>(alpha, x, beta, y, z, n, partials, dot, stream);                   \
  }

TPS_BLAS1(f32, float)
TPS_BLAS1(f64, double)
TPS_BLAS1(bf16, __nv_bfloat16)

#undef TPS_BLAS1

}  // extern "C"
