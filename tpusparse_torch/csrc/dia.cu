// Diagonal-offset (DIA) SpMV for Hopper (sm_90a): K11.
//
// Replaces (tpusparse/kernels/dia.py):
//   tps_spmv_dia_*  <- spmv_dia_pallas (:84, body _dia_kernel :60)
// The Pallas kernel DMA'd one window of x per row block into VMEM and split each offset
// into a sublane and a lane shift over the (rows128, 128) lane layout, padding x with zero
// rows for the reads that leave the matrix.  On Hopper each diagonal's read of x is a
// plain load through L1/L2 at row i + off: no window, no lane layout, no padding.
//
// Operator: y[i] = sum over d of data[d*n + i] * x[i + offsets[d]], summed from 0 in the
// order of the diagonals.  A term whose x index falls outside [0, n) is left out, by
// select: it is never a product with a padded zero, so a NaN or Inf stored where a
// diagonal leaves the matrix cannot reach y (the plain dia-xla operator, too, sums only
// the rows where each diagonal lies inside the matrix).  Every product and sum is an
// explicitly rounded intrinsic: y equals the plain twin spmv_dia_plain
// (tpusparse_torch/kernels/dia.py) bit for bit.  Optionally the partials of <x, y>.
//
// A bf16 state (tps_spmv_dia_bf16): data, x and y in bf16, each product and each sum
// computed in f32 and rounded to bf16, in the Pallas kernel's order (dia.py:84-140: a bf16
// accumulator from 0, acc + data[d]*x per diagonal); the dot accumulates in f32
// (reduce.cuh).  14 B a row for the stencil's five diagonals.
//
// Offsets are a device array of ndiag int64, read by every thread of a warp at one
// address (a broadcast from L1), so any count works, up to csr_to_dia's 4096 and beyond.
//
// What bounds it on this card: bytes.  Per row it reads ndiag data words and x, and writes
// y: (ndiag + 2) words when x's ndiag reads of neighbouring rows hit L1/L2 (28 B f32, 56 B
// f64 for the 5-point stencil), against 2*ndiag flops.  The design is one thread per row
// (rows.cuh): reads of data are coalesced along each diagonal, and x's reads of
// neighbouring rows meet in L1/L2.  Index arithmetic is 64-bit: d*n + i reaches 2.1e9 at
// 20480^2.  y must not alias x or data.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "rows.cuh"

namespace {

// kDot: also the partials of <x, y> (a separate instantiation, so that the plain SpMV
// carries none of the dot's code).  S is the state's storage type; every product and sum
// is rounded to S (the identity for f32 and f64).
template <typename S, bool kDot>
__global__ void __launch_bounds__(kRowThreads)
spmv_dia_kernel(const S* __restrict__ data, const int64_t* __restrict__ offsets,
                const S* __restrict__ x, S* __restrict__ y, int64_t ndiag, int64_t n,
                compute_t<S>* partials) {
  using T = compute_t<S>;
  const int64_t i = row_index();
  T acc = T(0);
  if (i < n) {
    T out = T(0);
#pragma unroll 4
    for (int64_t d = 0; d < ndiag; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      if (j >= 0 && j < n) {
        out = add_s<S>(out, mul_s<S>(widen(data[d * n + i]), widen(__ldg(x + j))));
      }
    }
    y[i] = narrow<S>(out);
    if (kDot) acc = mul_rn(widen(__ldg(x + i)), out);
  }
  if (kDot) store_partial(acc, partials);
}

template <typename S>
int spmv_dia(const void* data, const void* offsets, const void* x, void* y, int64_t ndiag,
             int64_t n, void* partials, void* dot, void* stream) {
  using T = compute_t<S>;
  const int64_t blocks = row_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  if (part != nullptr) {
    spmv_dia_kernel<S, true><<<(unsigned)blocks, kRowThreads, 0, s>>>(
        (const S*)data, (const int64_t*)offsets, (const S*)x, (S*)y, ndiag, n, part);
  } else {
    spmv_dia_kernel<S, false><<<(unsigned)blocks, kRowThreads, 0, s>>>(
        (const S*)data, (const int64_t*)offsets, (const S*)x, (S*)y, ndiag, n, part);
  }
  return finish_dot<T>(part, blocks, (T*)dot, s);
}

}  // namespace

extern "C" {

// data (ndiag, n), offsets (ndiag) int64, x/y (n); partials sized by
// tps_row_partials(n) (ell.cu), dot (one element) or null for no dot.
int tps_spmv_dia_f32(const void* data, const void* offsets, const void* x, void* y,
                     int64_t ndiag, int64_t n, void* partials, void* dot, void* stream) {
  return spmv_dia<float>(data, offsets, x, y, ndiag, n, partials, dot, stream);
}

int tps_spmv_dia_f64(const void* data, const void* offsets, const void* x, void* y,
                     int64_t ndiag, int64_t n, void* partials, void* dot, void* stream) {
  return spmv_dia<double>(data, offsets, x, y, ndiag, n, partials, dot, stream);
}

// The bf16 state: data, x and y bf16; partials and the dot f32.
int tps_spmv_dia_bf16(const void* data, const void* offsets, const void* x, void* y,
                      int64_t ndiag, int64_t n, void* partials, void* dot, void* stream) {
  return spmv_dia<__nv_bfloat16>(data, offsets, x, y, ndiag, n, partials, dot, stream);
}

}  // extern "C"
