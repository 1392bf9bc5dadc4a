// The tiling, the stencil's input fields and the neighbour gather that the 5-point stencil
// kernels share (stencil5_const.cu: K1-K3, K10; stencil5.cu: K8, K9).
//
// A block of kTX x kTY threads covers kTX columns by kTileRows rows of a (rows, g) band;
// each thread walks kTileRows / kTY rows, kTY apart, so a warp reads 32 consecutive
// columns of one row.  One partial per block, so a dot over the band has
// tps_stencil5_partials(rows, g) partials for every stencil kernel.
//
// Neighbours are read straight from global memory; the N/S/W/E re-reads hit L1/L2, so HBM
// sees each field once.  Off-grid neighbours are selected away, never multiplied by a 0
// mask: they are never loaded, and a NaN outside the band cannot leak in.  N/S of the
// band's first/last row come from the halo rows (nullptr = zero, the Dirichlet edge); W/E
// at the grid's side columns are zero.  All index arithmetic is 64-bit.  A field stored
// as S is gathered in compute_t<S> (reduce.cuh): bf16 in f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kTX = 32;        // block width: columns
constexpr int kTY = 8;         // block height: thread rows
constexpr int kTileRows = 32;  // grid rows per block; each thread walks kTileRows / kTY

inline dim3 grid_for(int64_t rows, int64_t g) {
  return dim3((unsigned)((g + kTX - 1) / kTX), (unsigned)((rows + kTileRows - 1) / kTileRows));
}

// The stencil input field read as it is (K3, K8: x; K2: p), in the compute type.
template <typename S>
struct Field {
  const S* v;
  __device__ __forceinline__ compute_t<S> operator()(int64_t k) const { return widen(v[k]); }
};

// The stencil input formed on the fly as p' = r + beta*p (K1, K9, K10), rounded as
// PyTorch's `r + beta * p` rounds it.  A block forms its neighbours' p' from r and p too,
// so p' must never be written over p: another block may still read that p.
template <typename S>
struct PUpdated {
  const S* r;
  const S* p;
  compute_t<S> beta;
  __device__ __forceinline__ compute_t<S> operator()(int64_t k) const {
    return add_s<S>(widen(r[k]), mul_s<S>(beta, widen(p[k])));
  }
};

// f at (i, j) and its four neighbours, zero (or the halo row) off the band.
template <typename T>
struct Neighbours {
  T c, n, s, w, e;
};

// The field's values are stored as S (the halo rows too) and gathered in compute_t<S>.
template <typename S, typename F>
__device__ __forceinline__ Neighbours<compute_t<S>> gather5(const F& f, const S* hp,
                                                            const S* hn, int64_t i,
                                                            int64_t j, int64_t rows,
                                                            int64_t g) {
  using T = compute_t<S>;
  const int64_t k = i * g + j;
  const T zero = T(0);
  Neighbours<T> v;
  v.c = f(k);
  v.n = (i > 0) ? f(k - g) : (hp != nullptr ? widen(hp[j]) : zero);
  v.s = (i + 1 < rows) ? f(k + g) : (hn != nullptr ? widen(hn[j]) : zero);
  v.w = (j > 0) ? f(k - 1) : zero;
  v.e = (j + 1 < g) ? f(k + 1) : zero;
  return v;
}

}  // namespace
