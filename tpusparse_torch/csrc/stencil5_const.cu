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
// :1118), and another block may already have overwritten that p.  K10 is K1's scalar body
// with y = A p' stored too; they share one templated body, so their p' and A p' agree bit
// for bit.  Pass B (K2) updates x and r in place: each element is read and written by one
// thread, and neighbours come only from p, which K2 does not write.
//
// A*p must be bit-identical in K1 and K2 (K1's <p', A p'> and K2's r - alpha*A p use the
// same A p).  The scalar bodies call stencil_at(), the vector bodies stencil_vec(), which
// performs stencil_at's operations in its order; every operation in them and in the p'
// update is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn, ...), which nvcc never
// contracts into an FMA; plain PyTorch ops round each operation the same way, so the
// fields also match the plain twins in tpusparse_torch/kernels/stencil5.py bit for bit.
//
// K3 also has a bf16-state instance: x and y stored in bf16, every sum and product
// computed in f32 and rounded to bf16 in the Pallas kernel's order, diag and offdiag
// rounded to bf16 first, and the dot accumulated in f32 (reduce.cuh); 4 B a point.
//
// K3, K1 and K2 have two bodies each.  The scalar bodies (spmv_kernel, pupdate_dot_kernel,
// update_recompute_kernel) are the shared tile above, one element a thread a load: K3's
// reached 70% of its bound in f32 and 37% at a bf16 state on the H100, K1's 61% in f32
// and K2's 78%.  The vector bodies (spmv_vec_kernel, pupdate_dot_vec_kernel,
// update_recompute_vec_kernel; entry points *_vec_*) keep the tile and its order and give
// each thread one 16-byte vector of columns (8 bf16, 4 f32, 2 f64) of consecutive rows
// instead of one element: every thread issues all its loads first (its rows' vectors and
// the rows just above and below, which the warps beside it load too and L1 serves), takes
// W/E across lanes by shuffles, and stores its fields with 16-byte stores.  K1's
// forms p' = r + beta*p in registers from the r and p vectors it loaded, then runs K3's
// stencil on p'; K2's forms A p as K3's does, then x' and r' in the scalar body's order.
// Every element's operations are the scalar bodies' in their order, so p', A p, x' and r'
// agree bit for bit between the bodies (and K1's A p' with K2's A p and K10's).  At a
// bf16 state K3 computes two elements an instruction (add.rn/mul.rn.bf16x2, the same bits
// as f32 then bf16; see add_bf16x2).  What bounds them is HBM, and how close a read+write
// stream comes to it depends on how many places in memory are read at once: the hardware
// starts blocks in index order, so the tiles in flight lie in a band of a few rows, as a
// plain copy's addresses do.  A ring of x's rows in shared memory, fed by cp.async or by
// TMA bulk copies, keeps more bytes in flight but reads as many places as there are row
// runs in flight, and streamed slower on the H100 (bench/k3_layouts.cu).  Their dots
// finish in the same launch (store_partial_and_finish on the caller's ticket counter),
// summed in their own fixed order.  The vector bodies need every field and the halo rows
// 16-byte aligned and g * sizeof(S) a multiple of 16 (vec_takes); the Python wrappers
// launch the scalar bodies otherwise.
//
// Every entry point launches on the stream it is given, allocates nothing (the caller
// passes the partials buffer, sized by tps_stencil5_partials, or for the vector bodies by
// tps_spmv_stencil5_const_vec_partials) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "stencil5_tile.cuh"

namespace {

// (A f)(i, j) for the field f stored as S; *center receives f(i, j).  Each sum and
// product is rounded to S (the identity for f32 and f64) in the Pallas kernel's order:
// diag*x + offdiag*(((N + S) + W) + E).
template <typename S, typename F>
__device__ __forceinline__ compute_t<S> stencil_at(const F& f, const S* hp, const S* hn,
                                                   int64_t i, int64_t j, int64_t rows,
                                                   int64_t g, compute_t<S> diag,
                                                   compute_t<S> offdiag,
                                                   compute_t<S>* center) {
  using T = compute_t<S>;
  const Neighbours<T> v = gather5<S>(f, hp, hn, i, j, rows, g);
  *center = v.c;
  const T nb = add_s<S>(add_s<S>(add_s<S>(v.n, v.s), v.w), v.e);
  return add_s<S>(mul_s<S>(diag, v.c), mul_s<S>(offdiag, nb));
}

// K3: y = A x, and the partials of <x, y> when partials != nullptr.  diag and offdiag are
// rounded to S first, as the Pallas kernel's Python floats are to a bf16 state.
template <typename S>
__global__ void __launch_bounds__(kTX * kTY)
spmv_kernel(const S* __restrict__ x, const S* __restrict__ hp, const S* __restrict__ hn,
            S* __restrict__ y, int64_t rows, int64_t g, compute_t<S> diag,
            compute_t<S> offdiag, compute_t<S>* partials) {
  using T = compute_t<S>;
  const int64_t j = (int64_t)blockIdx.x * kTX + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kTileRows;
  const Field<S> f{x};
  const T d = rnd<S>(diag), o = rnd<S>(offdiag);
  T acc = T(0);
  if (j < g) {
    for (int t = threadIdx.y; t < kTileRows && i0 + t < rows; t += kTY) {
      const int64_t i = i0 + t;
      T c;
      const T v = stencil_at<S>(f, hp, hn, i, j, rows, g, d, o, &c);
      y[i * g + j] = narrow<S>(v);
      acc = fma_rn(c, v, acc);
    }
  }
  if (partials != nullptr) store_partial(acc, partials);
}

// ---------------------------------------------------------------------------
// The vector bodies: K3's, and K1's and K2's on the same tile, loads and shuffles
// ---------------------------------------------------------------------------

// A tile is kTX 16-byte vectors of columns by kTileRows rows (the scalar body's tile
// rows), each thread of a kTX x kTY block one vector of kTileRows / kTY consecutive rows.
// A block takes a stack of `stack` tiles, one under the other, in turn; blockIdx.x runs
// along a row of stacks.  The hardware starts blocks in index order, so the tiles in
// flight lie in a band of a few stacks' rows that sweeps down the grid, as a plain copy's
// addresses do; a grid-stride walk of the tiles by the blocks the card holds would let the
// blocks drift apart over the grid.  A stack spreads a block's fixed costs, its dot's
// reduction, fence and ticket, over more tiles.
constexpr int kVecRows = kTileRows / kTY;

template <typename S>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(S); }

template <typename S>
dim3 vec_grid(int64_t rows, int64_t g, int64_t stack) {
  const int64_t stack_rows = kTileRows * stack;
  return dim3((unsigned)((g / vec_elems<S>() + kTX - 1) / kTX),
              (unsigned)((rows + stack_rows - 1) / stack_rows));
}

// The bf16 field operations two at a time: add.rn / mul.rn of bf16x2 round the exact sum
// or product of two bf16 values to bf16 once.  The scalar body computes it in f32 and
// rounds to bf16; f32 has more than 2 * 8 + 2 bits, so that double rounding never
// differs from the single one, and both bodies give the same bits.
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// the low and the high bf16 of a bf16x2 word, widened to f32 (exact)
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// y's vector from the thread's vectors of rows i - 1, i and i + 1 (zero where a row is
// missing) and x at the columns just left and right of it (``left``, ``right``: the raw
// element, zero off the grid), with stencil_at's operations in its order; acc += c * v in
// element order when kDot.
template <typename S, bool kDot>
__device__ __forceinline__ uint4 stencil_vec(const uint4& north, const uint4& mid,
                                             const uint4& south, S left, S right,
                                             compute_t<S> d, compute_t<S> o,
                                             compute_t<S>& acc) {
  using T = compute_t<S>;
  constexpr int V = vec_elems<S>();
  uint4 out;
  if constexpr (sizeof(S) == 2) {
    const unsigned* nw = reinterpret_cast<const unsigned*>(&north);
    const unsigned* cw = reinterpret_cast<const unsigned*>(&mid);
    const unsigned* sw = reinterpret_cast<const unsigned*>(&south);
    unsigned* yw = reinterpret_cast<unsigned*>(&out);
    const unsigned lw = (unsigned)__bfloat16_as_ushort(left) << 16;  // in the high half
    const unsigned rw = (unsigned)__bfloat16_as_ushort(right);      // in the low half
    const unsigned dd = __bfloat16_as_ushort(narrow<S>(d)) * 0x10001u;
    const unsigned oo = __bfloat16_as_ushort(narrow<S>(o)) * 0x10001u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // W and E of elements 2k and 2k + 1: x one column left and one right
      const unsigned w = __byte_perm(k > 0 ? cw[k - 1] : lw, cw[k], 0x5432);
      const unsigned e = __byte_perm(cw[k], k < 3 ? cw[k + 1] : rw, 0x5432);
      const unsigned nb = add_bf16x2(add_bf16x2(add_bf16x2(nw[k], sw[k]), w), e);
      yw[k] = add_bf16x2(mul_bf16x2(dd, cw[k]), mul_bf16x2(oo, nb));
      if (kDot) {
        acc = fma_rn(bf16_lo(cw[k]), bf16_lo(yw[k]), acc);
        acc = fma_rn(bf16_hi(cw[k]), bf16_hi(yw[k]), acc);
      }
    }
  } else {
    const S* nv = reinterpret_cast<const S*>(&north);
    const S* cv = reinterpret_cast<const S*>(&mid);
    const S* sv = reinterpret_cast<const S*>(&south);
    S* yv = reinterpret_cast<S*>(&out);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T vw = e > 0 ? cv[e - 1] : left;
      const T ve = e + 1 < V ? cv[e + 1] : right;
      const T nb = add_s<S>(add_s<S>(add_s<S>(nv[e], sv[e]), vw), ve);
      const T v = add_s<S>(mul_s<S>(d, cv[e]), mul_s<S>(o, nb));
      yv[e] = v;
      if (kDot) acc = fma_rn(cv[e], v, acc);
    }
  }
  return out;
}

// Where a thread of a vector body works: its first column c (its vector is columns c ..
// c + V - 1), whether that lies on the grid, and the column just beyond the tile's edge
// that lanes 0 and kTX - 1 read one element of (west of lane 0, east of the last lane).
template <typename S>
struct VecPlace {
  int64_t c;
  bool mine;   // c < g: the vector lies on the grid (g is a whole number of vectors)
  bool edge;   // the lane reads the element beyond the tile's edge, which lies on the grid
  int64_t ec;  // that element's column
  __device__ __forceinline__ explicit VecPlace(int64_t g) {
    constexpr int V = vec_elems<S>();
    const int lane = threadIdx.x;
    c = ((int64_t)blockIdx.x * kTX + lane) * V;
    mine = c < g;
    edge = (lane == 0 && c > 0) || (lane == kTX - 1 && c + V < g);
    ec = lane == 0 ? c - 1 : c + V;
  }
};

// The thread's first row in tile m of its block's stack (it takes rows first .. first +
// kVecRows - 1), or -1 once the stack has left the band, which holds for the whole block.
__device__ __forceinline__ int64_t vec_first(int m, int stack, int64_t rows) {
  const int64_t top = ((int64_t)blockIdx.y * stack + m) * kTileRows;
  return top >= rows ? -1 : top + (int64_t)threadIdx.y * kVecRows;
}

// The thread's vector of row i of the band f: the halo rows just beyond the band
// (nullptr = zero), zero beyond them and off the grid.
template <typename S>
__device__ __forceinline__ uint4 load_row(const S* f, const S* hp, const S* hn, int64_t i,
                                          int64_t rows, int64_t g, const VecPlace<S>& at) {
  const S* row = i < 0 ? hp : (i < rows ? f + i * g : (i == rows ? hn : nullptr));
  return at.mine && row != nullptr ? __ldg(reinterpret_cast<const uint4*>(row + at.c))
                                   : make_uint4(0u, 0u, 0u, 0u);
}

// W of the vector mid's first element and E of its last: the lane before's last element
// and the lane after's first, by shuffles; `beyond` (the element beyond the tile's edge)
// at lanes 0 and kTX - 1; zero off the grid (the side columns), selected, never
// multiplied.  Every lane of the warp must call it.
template <typename S>
__device__ __forceinline__ void west_east(const uint4& mid, S beyond, const VecPlace<S>& at,
                                          int64_t g, S* left, S* right) {
  constexpr int V = vec_elems<S>();
  const S* cv = reinterpret_cast<const S*>(&mid);
  S l = __shfl_up_sync(0xffffffffu, cv[V - 1], 1);
  S r = __shfl_down_sync(0xffffffffu, cv[0], 1);
  if (threadIdx.x == 0) l = beyond;
  if (threadIdx.x == kTX - 1) r = beyond;
  if (at.c == 0) l = narrow<S>(compute_t<S>(0));
  if (at.c + V >= g) r = narrow<S>(compute_t<S>(0));
  *left = l;
  *right = r;
}

// K3's vector body: y = A x, and <x, y> into dot[0] in the same launch when partials !=
// nullptr.  Each thread issues the loads of all its rows and the two beside them before
// computing any (HBM reads x once: the rows beside are other warps' rows of the tile and
// come from L1; lanes 0 and kTX - 1 also load the element beyond the tile's edge), takes
// W/E across lanes by shuffles, and writes y with streaming 16-byte stores.
template <typename S, bool kDot>
__global__ void __launch_bounds__(kTX * kTY)
spmv_vec_kernel(const S* __restrict__ x, const S* __restrict__ hp, const S* __restrict__ hn,
                S* __restrict__ y, int64_t rows, int64_t g, int stack, compute_t<S> diag,
                compute_t<S> offdiag, compute_t<S>* partials, unsigned int* tickets,
                compute_t<S>* dot) {
  using T = compute_t<S>;
  const T d = rnd<S>(diag), o = rnd<S>(offdiag);
  const VecPlace<S> at(g);
  T acc = T(0);
  for (int m = 0; m < stack; ++m) {
    const int64_t first = vec_first(m, stack, rows);
    if (first < 0) break;
    // x's rows first - 1 .. first + kVecRows: each row's north and south come from the
    // same thread's registers, the row before the first and the one after the last from
    // the warps beside it (L1) or the halo rows; zero beyond them
    uint4 v[kVecRows + 2];
    S beyond[kVecRows];
#pragma unroll
    for (int k = 0; k < kVecRows + 2; ++k) v[k] = load_row(x, hp, hn, first - 1 + k, rows, g, at);
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      beyond[k] = i < rows && at.edge ? x[i * g + at.ec] : narrow<S>(T(0));
    }
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      if (i >= rows) break;  // the same for the whole warp, and for its later rows
      S left, right;
      west_east(v[k + 1], beyond[k], at, g, &left, &right);
      if (at.mine) {
        __stcs(reinterpret_cast<uint4*>(y + i * g + at.c),
               stencil_vec<S, kDot>(v[k], v[k + 1], v[k + 2], left, right, d, o, acc));
      }
    }
  }
  if (kDot) store_partial_and_finish(acc, partials, tickets, dot);
}

// p' = r + beta*p on a vector, element by element, rounded as PUpdated rounds it.
template <typename T>
__device__ __forceinline__ uint4 pupdate_vec(const uint4& r, const uint4& p, T beta) {
  constexpr int V = vec_elems<T>();
  const T* rv = reinterpret_cast<const T*>(&r);
  const T* pv = reinterpret_cast<const T*>(&p);
  uint4 out;
  T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < V; ++e) ov[e] = add_rn(rv[e], mul_rn(beta, pv[e]));
  return out;
}

// K1's vector body: p' = r + beta*p into pout, and <p', A p'> into dot[0] in the same
// launch.  K3's vector body on the field p', which each thread forms in registers from
// the r and p vectors it loaded (every load issued first): rows of the band from r and p,
// the halo rows (already p') as they are, zero beyond them.  It stores p' of the band's
// own rows with 16-byte streaming stores; A p' stays in registers.
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
pupdate_dot_vec_kernel(const T* __restrict__ beta_ptr, const T* __restrict__ r,
                       const T* __restrict__ p, const T* __restrict__ hp,
                       const T* __restrict__ hn, T* __restrict__ pout, int64_t rows,
                       int64_t g, int stack, T diag, T offdiag, T* partials,
                       unsigned int* tickets, T* dot) {
  const VecPlace<T> at(g);
  const T beta = *beta_ptr;
  T acc = T(0);
  for (int m = 0; m < stack; ++m) {
    const int64_t first = vec_first(m, stack, rows);
    if (first < 0) break;
    // r (then p') and p of rows first - 1 .. first + kVecRows, and of the element beyond
    // the tile's edge in the thread's own rows
    uint4 v[kVecRows + 2], q[kVecRows + 2];
    T rb[kVecRows], pb[kVecRows];
#pragma unroll
    for (int k = 0; k < kVecRows + 2; ++k) {
      const int64_t i = first - 1 + k;
      v[k] = load_row(r, hp, hn, i, rows, g, at);
      q[k] = load_row(p, (const T*)nullptr, (const T*)nullptr, i, rows, g, at);
    }
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      const bool on = i < rows && at.edge;
      rb[k] = on ? r[i * g + at.ec] : T(0);
      pb[k] = on ? p[i * g + at.ec] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kVecRows + 2; ++k) {
      const int64_t i = first - 1 + k;
      if (i >= 0 && i < rows) v[k] = pupdate_vec(v[k], q[k], beta);
    }
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      if (i >= rows) break;  // the same for the whole warp, and for its later rows
      T left, right;
      west_east(v[k + 1], add_rn(rb[k], mul_rn(beta, pb[k])), at, g, &left, &right);
      if (at.mine) {
        __stcs(reinterpret_cast<uint4*>(pout + i * g + at.c), v[k + 1]);
        stencil_vec<T, true>(v[k], v[k + 1], v[k + 2], left, right, diag, offdiag, acc);
      }
    }
  }
  store_partial_and_finish(acc, partials, tickets, dot);
}

// K2's vector body: x += alpha*p, r -= alpha*(A p) in place, and <r', r'> into dot[0] in
// the same launch.  Each thread loads p's vectors of its rows and the two beside them
// (the halo rows at the band's edges) and x's and r's vectors of its own rows before any
// arithmetic, forms A p as K3's vector body does, and stores x' and r' with 16-byte
// stores.  x and r are read and written by the one thread that owns them; plain stores
// write back into the lines the loads just brought to L2, where streaming stores
// (evict-first) streamed 1.5-3% slower on the H100 (bench/recompute_bodies.py).
template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
update_recompute_vec_kernel(const T* __restrict__ alpha_ptr, T* __restrict__ x,
                            T* __restrict__ r, const T* __restrict__ p,
                            const T* __restrict__ hp, const T* __restrict__ hn, int64_t rows,
                            int64_t g, int stack, T diag, T offdiag, T* partials,
                            unsigned int* tickets, T* dot) {
  constexpr int V = vec_elems<T>();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const VecPlace<T> at(g);
  const T alpha = *alpha_ptr;
  T acc = T(0), unused = T(0);
  for (int m = 0; m < stack; ++m) {
    const int64_t first = vec_first(m, stack, rows);
    if (first < 0) break;
    uint4 v[kVecRows + 2], xv[kVecRows], rv[kVecRows];
    T beyond[kVecRows];
#pragma unroll
    for (int k = 0; k < kVecRows + 2; ++k) v[k] = load_row(p, hp, hn, first - 1 + k, rows, g, at);
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      const bool own = i < rows && at.mine;
      xv[k] = own ? *reinterpret_cast<const uint4*>(x + i * g + at.c) : zero;
      rv[k] = own ? *reinterpret_cast<const uint4*>(r + i * g + at.c) : zero;
      beyond[k] = i < rows && at.edge ? p[i * g + at.ec] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      const int64_t i = first + k;
      if (i >= rows) break;  // the same for the whole warp, and for its later rows
      T left, right;
      west_east(v[k + 1], beyond[k], at, g, &left, &right);
      if (at.mine) {
        const uint4 ap = stencil_vec<T, false>(v[k], v[k + 1], v[k + 2], left, right, diag,
                                               offdiag, unused);
        const T* pc = reinterpret_cast<const T*>(&v[k + 1]);
        const T* av = reinterpret_cast<const T*>(&ap);
        T* xe = reinterpret_cast<T*>(&xv[k]);
        T* re = reinterpret_cast<T*>(&rv[k]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          xe[e] = add_rn(xe[e], mul_rn(alpha, pc[e]));
          re[e] = sub_rn(re[e], mul_rn(alpha, av[e]));
          acc = fma_rn(re[e], re[e], acc);
        }
        *reinterpret_cast<uint4*>(x + i * g + at.c) = xv[k];
        *reinterpret_cast<uint4*>(r + i * g + at.c) = rv[k];
      }
    }
  }
  store_partial_and_finish(acc, partials, tickets, dot);
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
      const T v = stencil_at<T>(f, hp, hn, i0 + t, j, rows, g, diag, offdiag, &c);
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
      const T ap = stencil_at<T>(f, hp, hn, i, j, rows, g, diag, offdiag, &c);
      x[k] = add_rn(x[k], mul_rn(alpha, c));
      const T rn = sub_rn(r[k], mul_rn(alpha, ap));
      r[k] = rn;
      acc = fma_rn(rn, rn, acc);
    }
  }
  store_partial(acc, partials);
}

template <typename S>
int spmv(const void* x, const void* hp, const void* hn, void* y, int64_t rows, int64_t g,
         double diag, double offdiag, void* partials, void* dot, void* stream) {
  using T = compute_t<S>;
  const dim3 grid = grid_for(rows, g);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  spmv_kernel<S><<<grid, dim3(kTX, kTY), 0, s>>>(
      (const S*)x, (const S*)hp, (const S*)hn, (S*)y, rows, g, (T)diag, (T)offdiag, part);
  return finish_dot<T>(part, (int64_t)grid.x * grid.y, (T*)dot, s);
}

// Whether the vector bodies can take a launch: a stack in [1, 1024], a row a whole number
// of 16-byte vectors, and every operand (nullptr: absent) on a 16-byte boundary.
inline bool aligned16(const void* q) { return ((uintptr_t)q & 15u) == 0; }

template <typename S, typename... P>
bool vec_takes(int64_t g, int64_t stack, P... operands) {
  return stack >= 1 && stack <= 1024 && (g * (int64_t)sizeof(S)) % 16 == 0
         && (aligned16(operands) && ...);
}

// The vector bodies: K3's y = A x, and <x, y> into dot in the same launch when dot !=
// nullptr; K1's and K2's passes with their dots.  partials: one a block,
// tps_spmv_stencil5_const_vec_partials; tickets: a zeroed counter no concurrent launch
// shares.  Each refuses (cudaErrorInvalidValue) what vec_takes refuses.
template <typename S>
int spmv_vec(const void* x, const void* hp, const void* hn, void* y, int64_t rows, int64_t g,
             int64_t stack, double diag, double offdiag, void* partials, void* tickets,
             void* dot, void* stream) {
  using T = compute_t<S>;
  if (!vec_takes<S>(g, stack, x, y, hp, hn)) return (int)cudaErrorInvalidValue;
  const dim3 grid = vec_grid<S>(rows, g, stack), block(kTX, kTY);
  cudaStream_t s = (cudaStream_t)stream;
  if (dot != nullptr) {
    spmv_vec_kernel<S, true><<<grid, block, 0, s>>>(
        (const S*)x, (const S*)hp, (const S*)hn, (S*)y, rows, g, (int)stack, (T)diag,
        (T)offdiag, (T*)partials, (unsigned int*)tickets, (T*)dot);
  } else {
    spmv_vec_kernel<S, false><<<grid, block, 0, s>>>(
        (const S*)x, (const S*)hp, (const S*)hn, (S*)y, rows, g, (int)stack, (T)diag,
        (T)offdiag, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
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
int pupdate_dot_vec(const void* beta, const void* r, const void* p, const void* hp,
                    const void* hn, void* pout, int64_t rows, int64_t g, int64_t stack,
                    double diag, double offdiag, void* partials, void* tickets, void* dot,
                    void* stream) {
  if (!vec_takes<T>(g, stack, r, p, hp, hn, pout)) return (int)cudaErrorInvalidValue;
  const dim3 grid = vec_grid<T>(rows, g, stack);
  pupdate_dot_vec_kernel<T><<<grid, dim3(kTX, kTY), 0, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)r, (const T*)p, (const T*)hp, (const T*)hn, (T*)pout, rows, g,
      (int)stack, (T)diag, (T)offdiag, (T*)partials, (unsigned int*)tickets, (T*)dot);
  return (int)cudaGetLastError();
}

template <typename T>
int update_recompute_vec(const void* alpha, void* x, void* r, const void* p, const void* hp,
                         const void* hn, int64_t rows, int64_t g, int64_t stack, double diag,
                         double offdiag, void* partials, void* tickets, void* dot,
                         void* stream) {
  if (!vec_takes<T>(g, stack, x, r, p, hp, hn)) return (int)cudaErrorInvalidValue;
  const dim3 grid = vec_grid<T>(rows, g, stack);
  update_recompute_vec_kernel<T><<<grid, dim3(kTX, kTY), 0, (cudaStream_t)stream>>>(
      (const T*)alpha, (T*)x, (T*)r, (const T*)p, (const T*)hp, (const T*)hn, rows, g,
      (int)stack, (T)diag, (T)offdiag, (T*)partials, (unsigned int*)tickets, (T*)dot);
  return (int)cudaGetLastError();
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

// The bf16 state: x, y and halo rows bf16, partials and the dot f32.  K3 only: the JAX
// recompute and fused loops, which K1, K2 and K10 serve, reject a bf16 state.
int tps_spmv_stencil5_const_bf16(const void* x, const void* hp, const void* hn, void* y,
                                 int64_t rows, int64_t g, double diag, double offdiag,
                                 void* partials, void* dot, void* stream) {
  return spmv<__nv_bfloat16>(x, hp, hn, y, rows, g, diag, offdiag, partials, dot, stream);
}

// K3's vector body (see the header): the partials its dot needs over a (rows, g) band of
// elem_size-byte elements in stacks of `stack` tiles (one a block), and its three
// instances.
int64_t tps_spmv_stencil5_const_vec_partials(int64_t rows, int64_t g, int64_t elem_size,
                                             int64_t stack) {
  dim3 grid;
  switch (elem_size) {
    case 2: grid = vec_grid<__nv_bfloat16>(rows, g, stack); break;
    case 4: grid = vec_grid<float>(rows, g, stack); break;
    case 8: grid = vec_grid<double>(rows, g, stack); break;
    default: return -1;
  }
  return (int64_t)grid.x * grid.y;
}

int tps_spmv_stencil5_const_vec_f32(const void* x, const void* hp, const void* hn, void* y,
                                    int64_t rows, int64_t g, int64_t stack, double diag,
                                    double offdiag, void* partials, void* tickets, void* dot,
                                    void* stream) {
  return spmv_vec<float>(x, hp, hn, y, rows, g, stack, diag, offdiag, partials, tickets, dot,
                         stream);
}

int tps_spmv_stencil5_const_vec_f64(const void* x, const void* hp, const void* hn, void* y,
                                    int64_t rows, int64_t g, int64_t stack, double diag,
                                    double offdiag, void* partials, void* tickets, void* dot,
                                    void* stream) {
  return spmv_vec<double>(x, hp, hn, y, rows, g, stack, diag, offdiag, partials, tickets, dot,
                          stream);
}

int tps_spmv_stencil5_const_vec_bf16(const void* x, const void* hp, const void* hn, void* y,
                                     int64_t rows, int64_t g, int64_t stack, double diag,
                                     double offdiag, void* partials, void* tickets, void* dot,
                                     void* stream) {
  return spmv_vec<__nv_bfloat16>(x, hp, hn, y, rows, g, stack, diag, offdiag, partials,
                                 tickets, dot, stream);
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

// K1's vector body (see the header): its partials are K3's vector body's at the same
// element size and stack.
int tps_stencil5_const_pupdate_dot_vec_f32(const void* beta, const void* r, const void* p,
                                           const void* hp, const void* hn, void* pout,
                                           int64_t rows, int64_t g, int64_t stack,
                                           double diag, double offdiag, void* partials,
                                           void* tickets, void* dot, void* stream) {
  return pupdate_dot_vec<float>(beta, r, p, hp, hn, pout, rows, g, stack, diag, offdiag,
                                partials, tickets, dot, stream);
}

int tps_stencil5_const_pupdate_dot_vec_f64(const void* beta, const void* r, const void* p,
                                           const void* hp, const void* hn, void* pout,
                                           int64_t rows, int64_t g, int64_t stack,
                                           double diag, double offdiag, void* partials,
                                           void* tickets, void* dot, void* stream) {
  return pupdate_dot_vec<double>(beta, r, p, hp, hn, pout, rows, g, stack, diag, offdiag,
                                 partials, tickets, dot, stream);
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

// K2's vector body (see the header): its partials are K3's vector body's at the same
// element size and stack.
int tps_cg_const_update_recompute_vec_f32(const void* alpha, void* x, void* r, const void* p,
                                          const void* hp, const void* hn, int64_t rows,
                                          int64_t g, int64_t stack, double diag,
                                          double offdiag, void* partials, void* tickets,
                                          void* dot, void* stream) {
  return update_recompute_vec<float>(alpha, x, r, p, hp, hn, rows, g, stack, diag, offdiag,
                                     partials, tickets, dot, stream);
}

int tps_cg_const_update_recompute_vec_f64(const void* alpha, void* x, void* r, const void* p,
                                          const void* hp, const void* hn, int64_t rows,
                                          int64_t g, int64_t stack, double diag,
                                          double offdiag, void* partials, void* tickets,
                                          void* dot, void* stream) {
  return update_recompute_vec<double>(alpha, x, r, p, hp, hn, rows, g, stack, diag, offdiag,
                                      partials, tickets, dot, stream);
}

}  // extern "C"
