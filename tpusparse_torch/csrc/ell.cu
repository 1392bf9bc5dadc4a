// General-sparsity SpMV for Hopper (sm_90a) over a slot-major ELL operand: K12 and K13.
//
// Replaces (tpusparse/kernels/gather_ell.py):
//   tps_spmv_ell_*  <- _spmv_gather_jit (:283, body _gather_kernel :241), the windowed
//                      ladder pack, and _spmv_affine_jit (:645, body _affine_kernel :594),
//                      the affine/rot pack.
// Both compute y = A x for any sparsity; they differ only in how Mosaic, which gathers
// along lanes only, reached x: column windows DMA'd into VMEM, a select ladder over them,
// exact-diagonal rotations, and an XLA scatter-add for the entries no window covered.  On
// Hopper a gather is a load through L1/L2, so one kernel over the plain ELL layout backs
// both, takes every sparsity and needs none of those packs.
//
// Operator: y[i] = sum over k = 0..W-1 of vals[k*n + i] * x[cols[k*n + i]], summed from 0
// in slot order, every product and sum an explicitly rounded intrinsic: y equals the plain
// twin spmv_ell_plain (tpusparse_torch/kernels/ell.py) bit for bit.  Padding slots hold
// val 0 and an in-range column (formats.csr_to_ell).  x may hold more entries than the n
// rows (the sharded solver's band over a gather domain with the neighbours' halo rows);
// columns index x.  Optionally the partials of <x[dot_offset : dot_offset + n], y>: with a
// square matrix dot_offset is 0, over the gather domain it skips the halo row before the
// band.
//
// Layout: vals (W, n) in the state's dtype and cols (W, n) int32, slot-major, so that the
// threads of a warp, on neighbouring rows, read neighbouring addresses of each slot.
//
// What bounds it on this card: bytes.  Per row it reads W values, W int32 columns and W
// gathered x (through the read-only path, __ldg), and writes y: W*(itemsize + 4) +
// 2*itemsize bytes when each x comes from HBM once and its other W-1 reads hit L1/L2 (48 B
// f32, 76 B f64 for the 5-point stencil), against 2W flops.  The design is one thread per
// row (rows.cuh), so that neighbouring threads read neighbouring addresses of each slot
// and x's reads of neighbouring rows meet in L1/L2; the slot loop is unrolled so that
// several slots' loads are in flight before their sum needs them.  Index arithmetic is
// 64-bit: k*n + i reaches 2.1e9 at 20480^2.  y must not alias x or the operand.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "rows.cuh"

namespace {

// kDot: also the partials of <x, y> (a separate instantiation, so that the plain SpMV
// carries none of the dot's code).
template <typename T, bool kDot>
__global__ void __launch_bounds__(kRowThreads)
spmv_ell_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, int64_t width, int64_t n,
                int64_t dot_offset, T* partials) {
  const int64_t i = row_index();
  T acc = T(0);
  if (i < n) {
    T out = T(0);
#pragma unroll 4
    for (int64_t k = 0; k < width; ++k) {
      const int64_t e = k * n + i;
      out = add_rn(out, mul_rn(vals[e], __ldg(x + cols[e])));
    }
    y[i] = out;
    if (kDot) acc = mul_rn(__ldg(x + dot_offset + i), out);
  }
  if (kDot) store_partial(acc, partials);
}

template <typename T>
int spmv_ell(const void* vals, const void* cols, const void* x, void* y, int64_t width,
             int64_t n, int64_t dot_offset, void* partials, void* dot, void* stream) {
  const int64_t blocks = row_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  T* part = dot != nullptr ? (T*)partials : nullptr;
  if (part != nullptr) {
    spmv_ell_kernel<T, true><<<(unsigned)blocks, kRowThreads, 0, s>>>(
        (const T*)vals, (const int32_t*)cols, (const T*)x, (T*)y, width, n, dot_offset,
        part);
  } else {
    spmv_ell_kernel<T, false><<<(unsigned)blocks, kRowThreads, 0, s>>>(
        (const T*)vals, (const int32_t*)cols, (const T*)x, (T*)y, width, n, dot_offset,
        part);
  }
  return finish_dot<T>(part, blocks, (T*)dot, s);
}

}  // namespace

extern "C" {

// Number of per-block partials a dot of a row kernel (spmv_ell, spmv_dia) over n rows
// needs.
int64_t tps_row_partials(int64_t n) { return row_blocks(n); }

// vals (width, n), cols (width, n) int32 in [0, m), x (m >= n), y (n); partials sized by
// tps_row_partials(n), dot (one element) or null for no dot, which reads x from
// dot_offset (0 <= dot_offset <= m - n).
int tps_spmv_ell_f32(const void* vals, const void* cols, const void* x, void* y,
                     int64_t width, int64_t n, int64_t dot_offset, void* partials, void* dot,
                     void* stream) {
  return spmv_ell<float>(vals, cols, x, y, width, n, dot_offset, partials, dot, stream);
}

int tps_spmv_ell_f64(const void* vals, const void* cols, const void* x, void* y,
                     int64_t width, int64_t n, int64_t dot_offset, void* partials, void* dot,
                     void* stream) {
  return spmv_ell<double>(vals, cols, x, y, width, n, dot_offset, partials, dot, stream);
}

}  // extern "C"
