// Two designs of K3 (y = diag*x + offdiag*(((N + S) + W) + E) on a (rows, g) band, halo
// rows above and below, nullptr = zero) that the package does not ship, timed against its
// two bodies by tpusparse_torch/bench/k3_layouts.py.  Not part of the kernel library: the
// script builds this file on its own.  Both need x, y and the halo rows 16-byte aligned
// and g * sizeof(S) a multiple of 16; neither computes the dot.
//
// A block of 256 threads owns a strip of 256 16-byte vectors of columns (2048 bf16, 1024
// f32, 512 f64) and walks down a run of `run_rows` rows; x's rows of the strip, with one
// vector either side for W/E, arrive in a ring of kStages shared-memory stages, each
// thread keeping its vectors of rows i - 1 and i in registers.  One barrier a row.
//
//   tps_layout_k3_ring_*  every thread copies its own vector of each row with cp.async
//                         (16 bytes, .cg, the L2::128B prefetch hint), one commit group a
//                         row, kStages - 3 rows in flight;
//   tps_layout_k3_bulk_*  thread 0 copies each row's strip and side vectors in one
//                         cp.async.bulk (TMA) that completes on an mbarrier a stage.
//
// y leaves in 16-byte streaming stores, computed with stencil_at's operations in its order
// (each rounded to S), so y equals the package's K3 bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 8;

template <typename S>
struct Strip {
  static constexpr int kVec = 16 / (int)sizeof(S);
  static constexpr int kCols = kThreads * kVec;
  static constexpr int kWords = (kCols + 2 * kVec) * (int)sizeof(S) / 16;  // a stage
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// thread 0: the row src[lo, hi) into dst, completing on bar (a nullptr row: arrive only)
__device__ __forceinline__ void bulk_row(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  if (src == nullptr) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// y's vector of row i from the thread's vectors of rows i - 1, i, i + 1 (zero where a row
// is missing) and x just left and right of it
template <typename S>
__device__ __forceinline__ uint4 stencil_vec(const uint4& north, const uint4& mid,
                                             const uint4& south, compute_t<S> left,
                                             compute_t<S> right, compute_t<S> d,
                                             compute_t<S> o) {
  using T = compute_t<S>;
  constexpr int V = Strip<S>::kVec;
  const S* nv = reinterpret_cast<const S*>(&north);
  const S* cv = reinterpret_cast<const S*>(&mid);
  const S* sv = reinterpret_cast<const S*>(&south);
  uint4 out;
  S* yv = reinterpret_cast<S*>(&out);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const T vw = e > 0 ? widen(cv[e - 1]) : left;
    const T ve = e + 1 < V ? widen(cv[e + 1]) : right;
    const T nb = add_s<S>(add_s<S>(add_s<S>(widen(nv[e]), widen(sv[e])), vw), ve);
    yv[e] = narrow<S>(add_s<S>(mul_s<S>(d, widen(cv[e])), mul_s<S>(o, nb)));
  }
  return out;
}

template <typename S, bool kBulk>
__global__ void __launch_bounds__(kThreads)
k3_ring_kernel(const S* __restrict__ x, const S* __restrict__ hp, const S* __restrict__ hn,
               S* __restrict__ y, int64_t rows, int64_t g, int64_t run_rows,
               compute_t<S> diag, compute_t<S> offdiag) {
  using T = compute_t<S>;
  constexpr int V = Strip<S>::kVec, kCols = Strip<S>::kCols;
  __shared__ uint4 words[kStages][Strip<S>::kWords];
  __shared__ uint64_t full[kStages];  // the bulk copies' barriers
  auto stage = [&](int l) { return reinterpret_cast<S*>(words[l % kStages]); };
  const int t = threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.x * kCols, c = j0 + (int64_t)t * V;
  const int64_t i0 = (int64_t)blockIdx.y * run_rows;
  const int n = (int)(rows - i0 < run_rows ? rows - i0 : run_rows);
  const bool mine = c < g;
  const int64_t lo = j0 > 0 ? j0 - V : 0, hi = j0 + kCols + V < g ? j0 + kCols + V : g;
  // load l: x's row i0 - 1 + l (the halo rows beyond the band) into stage l % kStages
  auto src = [&](int l) -> const S* {
    const int64_t i = i0 - 1 + l;
    return i < 0 ? hp : (i >= rows ? hn : x + i * g);
  };
  auto issue = [&](int l) {
    if (kBulk) {
      if (t == 0 && l < n + 2) {
        const S* row = src(l);
        bulk_row(stage(l) + (lo - (j0 - V)), row == nullptr ? nullptr : row + lo,
                 (unsigned)((hi - lo) * (int64_t)sizeof(S)), &full[l % kStages]);
      }
      return;
    }
    const S* row = l < n + 2 ? src(l) : nullptr;
    if (row != nullptr) {
      if (mine) cp_async16(stage(l) + (t + 1) * V, row + c);
      if (t == 0 && j0 > 0) cp_async16(stage(l), row + j0 - V);
      if (t == kThreads - 1 && j0 + kCols < g) {
        cp_async16(stage(l) + (kThreads + 1) * V, row + j0 + kCols);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (kBulk) {
    if (t == 0) {
      for (int k = 0; k < kStages; ++k) mbar_init(&full[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int l = 0; l < kStages - 1; ++l) issue(l);
  const T d = rnd<S>(diag), o = rnd<S>(offdiag);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 north = zero, mid = zero;
  for (int r = 0; r < n; ++r) {
    if (kBulk) {
      if (r == 0) {
        mbar_wait(&full[0], 0);
        mbar_wait(&full[1], 0);
      }
      mbar_wait(&full[(r + 2) % kStages], (unsigned)(((r + 2) / kStages) & 1));
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 4) : "memory");
    }
    __syncthreads();  // every copy of loads <= r + 2 seen; every read of row r - 1 done
    issue(r + kStages - 1);
    const int64_t i = i0 + r;
    const S* centre = stage(r + 1);
    if (r == 0) {
      north = i > 0 || hp != nullptr ? *reinterpret_cast<const uint4*>(stage(0) + (t + 1) * V)
                                     : zero;
      mid = *reinterpret_cast<const uint4*>(centre + (t + 1) * V);
    }
    const uint4 south = i + 1 < rows || hn != nullptr
                            ? *reinterpret_cast<const uint4*>(stage(r + 2) + (t + 1) * V)
                            : zero;
    if (mine) {
      const T left = c > 0 ? widen(centre[(t + 1) * V - 1]) : T(0);
      const T right = c + V < g ? widen(centre[(t + 2) * V]) : T(0);
      __stcs(reinterpret_cast<uint4*>(y + i * g + c),
             stencil_vec<S>(north, mid, south, left, right, d, o));
    }
    north = mid;
    mid = south;
  }
}

template <typename S, bool kBulk>
int launch(const void* x, const void* hp, const void* hn, void* y, int64_t rows, int64_t g,
           int64_t run_rows, double diag, double offdiag, void* stream) {
  using T = compute_t<S>;
  if (run_rows < 1 || (g * (int64_t)sizeof(S)) % 16 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g + Strip<S>::kCols - 1) / Strip<S>::kCols),
                  (unsigned)((rows + run_rows - 1) / run_rows));
  k3_ring_kernel<S, kBulk><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const S*)x, (const S*)hp, (const S*)hn, (S*)y, rows, g, run_rows, (T)diag, (T)offdiag);
  return (int)cudaGetLastError();
}

}  // namespace

#define K3_LAYOUTS(SUF, S)                                                                    \
  extern "C" int tps_layout_k3_ring_##SUF(const void* x, const void* hp, const void* hn,     \
                                          void* y, int64_t rows, int64_t g, int64_t run_rows, \
                                          double diag, double offdiag, void* stream) {        \
    return launch<S, false>(x, hp, hn, y, rows, g, run_rows, diag, offdiag, stream);          \
  }                                                                                           \
  extern "C" int tps_layout_k3_bulk_##SUF(const void* x, const void* hp, const void* hn,     \
                                          void* y, int64_t rows, int64_t g, int64_t run_rows, \
                                          double diag, double offdiag, void* stream) {        \
    return launch<S, true>(x, hp, hn, y, rows, g, run_rows, diag, offdiag, stream);           \
  }

K3_LAYOUTS(f32, float)
K3_LAYOUTS(f64, double)
K3_LAYOUTS(bf16, __nv_bfloat16)
