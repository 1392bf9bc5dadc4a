// Card-to-card synchronisation of the sharded CG loop for Hopper (sm_90a): what the
// per-card loop's shards pass each other inside their CUDA graphs, without the host.
//
// Ports no TPU kernel.  It is the counterpart of the collectives inside the JAX package's
// sharded lax.while_loop (tpusparse/solvers/cg_sharded.py): jax.lax.ppermute of a band's
// boundary rows (:468-469) and jax.lax.psum of the dots (:427, :446, :472, :476), which
// XLA runs device to device, so that every device holds the same sums and evaluates the
// loop's condition itself.  tpusparse_torch/solvers/cg_sharded.py (CardLoop) captures each
// shard's iteration into a graph of the shard's own card (a WHILE node's body may hold the
// kernels of one device only); the shards meet at three sync points an iteration (the
// rows, <p, A.p>, <r, r>), each a publish on the writer's card and a wait on the reader's:
//
//   publish_rows_kernel     a shard's boundary rows (on a 2-D mesh also its side columns,
//                           strided) stored straight into its neighbours' halo buffers on
//                           their cards, P2P stores through the unified address; then the
//                           neighbour's flag for this sync point set to the epoch with a
//                           system-scope release, after the data (every thread fences, the
//                           block meets, one thread releases).  One block a neighbour.
//   publish_partial_kernel  a shard's 0-d dot partial stored into its slot of every
//                           shard's slot array for the sync point, then its flag there set
//                           the same way (one thread a destination: store, then release).
//   wait_kernel             on the shard's own card, one thread: system-scope acquire loads
//                           of the flags it needs until each holds the epoch; for a dot,
//                           then the slots added in shard order, left to right, in the
//                           partial's type (IEEE-rounded adds, no fast math, no atomics),
//                           which is the bits of the mesh's ordered sum (_sum_in_order), on
//                           every card alike.
//
// Epochs: ctl[0] of each shard, a 64-bit counter on its card that nothing resets.  A
// publish sets its flags to ctl[0] + 1; the wait that follows on the same stream waits for
// ctl[0] + 1 and then stores it into ctl[0].  So the graph advances the counter at every
// sync point, every shard's counter passes the same values, and a flag left by an earlier
// sync point, solve or replay is always below what a wait asks for.  An iteration skipped
// by an IF node runs no publish and no wait on any card (every card evaluates the same
// condition on the same bits).
//
// Bounded waits: a wait spinning for longer than bound_ns (%globaltimer) writes its code
// (the shard and the sync point) into the shard's error word ctl[1] and returns; a wait
// that finds the error word set does not spin; a dot's wait then writes NaN, which stops
// the loop's condition (rr > tol2 is false), and the solve's one read raises.  No __trap:
// it would poison the context, and the process could not report.
//
// What bounds them: latency.  A publish moves two rows (2 g words) or N words; a wait reads
// N + 1 words: each is one launch, one NVLink (or HBM) round trip for its release or
// acquire, and a few microseconds in all against an iteration's milliseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ void store_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float quiet_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// One block a link; a link is 5 int64: source, source stride (elements), elements,
// destination (on the neighbour's card), flag (on the neighbour's card).  W is a word of
// the state's width (2, 4 or 8 bytes): the copy moves bits.
template <typename W>
__global__ void publish_rows_kernel(const long long* links, const u64* ctl) {
  const long long* l = links + 5 * blockIdx.x;
  const W* src = (const W*)l[0];
  const long long stride = l[1], n = l[2];
  W* dst = (W*)l[3];
  for (long long j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j * stride];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) store_release_sys((u64*)l[4], ctl[0] + 1);
}

// dests: n slot pointers, then n flag pointers (one a shard, on its card).
template <typename W>
__global__ void publish_partial_kernel(const W* part, const long long* dests, int n,
                                       const u64* ctl) {
  const int j = threadIdx.x;
  if (j >= n) return;
  *(volatile W*)dests[j] = *part;
  store_release_sys((u64*)dests[n + j], ctl[0] + 1);
}

// Waits for flags[j] >= ctl[0] + 1 for every bit j of mask (j < nflags), then with kSum
// writes slots[0] + slots[1] + ... + slots[nflags - 1] (left to right) into out, NaN when
// the shard's error word is set.  Advances ctl[0].
template <typename T, bool kSum>
__global__ void wait_kernel(u64* ctl, const u64* flags, int nflags, u64 mask,
                            const T* slots, T* out, long long code, long long bound_ns) {
  const u64 epoch = ctl[0] + 1;
  volatile long long* error = (volatile long long*)(ctl + 1);
  if (*error == 0) {
    const u64 t0 = global_ns();
    for (int j = 0; j < nflags && *error == 0; ++j) {
      if (!((mask >> j) & 1ull)) continue;
      while (load_acquire_sys(flags + j) < epoch) {
        if ((long long)(global_ns() - t0) > bound_ns) {
          *error = code;
          break;
        }
        __nanosleep(64);
      }
    }
  }
  if constexpr (kSum) {
    T s;
    if (*error != 0) {
      s = quiet_nan(T());
    } else {
      const volatile T* v = slots;
      s = v[0];
      for (int j = 1; j < nflags; ++j) s = add_rn(s, v[j]);
    }
    *out = s;
  }
  ctl[0] = epoch;
}

template <typename W>
int publish_rows(const void* links, int nlinks, const void* ctl, cudaStream_t s) {
  publish_rows_kernel<W><<<nlinks, 1024, 0, s>>>((const long long*)links, (const u64*)ctl);
  return (int)cudaGetLastError();
}

template <typename W>
int publish_partial(const void* part, const void* dests, int n, const void* ctl,
                    cudaStream_t s) {
  publish_partial_kernel<W><<<1, 32 * ((n + 31) / 32), 0, s>>>(
      (const W*)part, (const long long*)dests, n, (const u64*)ctl);
  return (int)cudaGetLastError();
}

template <typename T>
int wait(void* ctl, const void* flags, int nflags, u64 mask, const void* slots, void* out,
         long long code, long long bound_ns, cudaStream_t s) {
  if (out != nullptr) {
    wait_kernel<T, true><<<1, 1, 0, s>>>((u64*)ctl, (const u64*)flags, nflags, mask,
                                         (const T*)slots, (T*)out, code, bound_ns);
  } else {
    wait_kernel<T, false><<<1, 1, 0, s>>>((u64*)ctl, (const u64*)flags, nflags, mask,
                                          nullptr, nullptr, code, bound_ns);
  }
  return (int)cudaGetLastError();
}

template <typename F>
cudaError_t attributes(F f) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, f);
}

}  // namespace

extern "C" {

// width: the state's bytes an element (2, 4 or 8).
int tps_mesh_publish_rows(const void* links, int nlinks, int width, const void* ctl,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 2: return publish_rows<uint16_t>(links, nlinks, ctl, s);
    case 4: return publish_rows<uint32_t>(links, nlinks, ctl, s);
    case 8: return publish_rows<uint64_t>(links, nlinks, ctl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int tps_mesh_publish_partial_f32(const void* part, const void* dests, int n, const void* ctl,
                                 void* stream) {
  return publish_partial<uint32_t>(part, dests, n, ctl, (cudaStream_t)stream);
}

int tps_mesh_publish_partial_f64(const void* part, const void* dests, int n, const void* ctl,
                                 void* stream) {
  return publish_partial<uint64_t>(part, dests, n, ctl, (cudaStream_t)stream);
}

int tps_mesh_wait_f32(void* ctl, const void* flags, int nflags, unsigned long long mask,
                      const void* slots, void* out, long long code, long long bound_ns,
                      void* stream) {
  return wait<float>(ctl, flags, nflags, mask, slots, out, code, bound_ns,
                     (cudaStream_t)stream);
}

int tps_mesh_wait_f64(void* ctl, const void* flags, int nflags, unsigned long long mask,
                      const void* slots, void* out, long long code, long long bound_ns,
                      void* stream) {
  return wait<double>(ctl, flags, nflags, mask, slots, out, code, bound_ns,
                      (cudaStream_t)stream);
}

// Load the kernels' module on the current device now (lazy loading would load it at the
// first launch, inside a capture).
int tps_mesh_preload() {
  cudaError_t err = attributes(publish_rows_kernel<uint16_t>);
  if (err == cudaSuccess) err = attributes(publish_rows_kernel<uint32_t>);
  if (err == cudaSuccess) err = attributes(publish_rows_kernel<uint64_t>);
  if (err == cudaSuccess) err = attributes(publish_partial_kernel<uint32_t>);
  if (err == cudaSuccess) err = attributes(publish_partial_kernel<uint64_t>);
  if (err == cudaSuccess) err = attributes(wait_kernel<float, true>);
  if (err == cudaSuccess) err = attributes(wait_kernel<float, false>);
  if (err == cudaSuccess) err = attributes(wait_kernel<double, true>);
  if (err == cudaSuccess) err = attributes(wait_kernel<double, false>);
  return (int)err;
}

// Let kernels on `device` load and store `peer`'s memory (access already given counts as
// success).  The current device is left as it was.
int tps_mesh_enable_peer(int device, int peer) {
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

}  // extern "C"
