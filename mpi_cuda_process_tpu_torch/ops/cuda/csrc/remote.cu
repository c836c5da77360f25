// ring_exchange: both ring directions of one mesh axis for one slab pair,
// every chunk landed in place in its destination's output slab, for every
// ring of shards that lives on one device, in one ordinary launch.
//
// Replaces: the TPU package's ops/pallas/remote.py — build_ring_exchange_call
// and its _ring_kernel (the in-kernel remote-DMA halo exchange), with the
// chunk geometry of pick_chunks (the wrapper computes it, remote.py here).
//
// On the TPU each chip runs the kernel for its own shard: it stages its
// slab chunk by chunk through a VMEM send ring and pushes each chunk into
// the ring neighbour's VMEM receive ring with a remote DMA, under send,
// receive and credit semaphores, because a chunk must sit in VMEM before
// the neighbour's kernel can drain it into HBM.  On one card the
// destination of every chunk is already device memory: the neighbour's
// output slab.  So the sender writes each chunk straight to its place
// there, and nothing is staged or read back: no receive ring, no credits,
// and a block never waits on another.  Direction 0 sends a shard's hi slab
// to the next shard, where it lands as that shard's from_left; direction 1
// sends the lo slab to the previous shard (from_right).
//
// The protocol that stays is the record of the landing: every block that
// wrote a share of chunk c of (destination, direction) adds one to that
// chunk's ready counter (fence, then a release add) after its stores.  At
// exit every ready counter equals the blocks that wrote into its chunk
// (remote.py::drained_counts), which the wrapper's RingState checks; the
// launch zeroes the counters first (one memset on the stream), the role of
// the TPU kernel's per-call barrier.  The consumer of the received slabs
// runs after this kernel in stream order, which is the receiver's wait on
// one card.  The ring across cards (ROADMAP B7) builds
// on this form: the same stores into peer memory over NVLink, system-scope
// release adds on flags in the receiver's memory, and a receiver that
// acquires them before it reads; the kernel already takes a raw pointer to
// every shard's slabs and counters for that.
//
// Bound on an H100: device-memory bytes, each slab read once and each
// received slab written once.  What the design does for it: an ordinary
// launch of as many blocks as the chunks need (no residency cap), each
// thread with ILP independent 16-byte loads in flight before its stores,
// and a grid of (part, run, chunk x direction x shard) blocks, so a block
// copies one contiguous span of one run and computes no index by division.

#include <cuda/atomic>
#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;  // independent units a thread loads before it stores
constexpr int SPAN = THREADS * ILP;  // units a block copies of one run
constexpr int MAX_SHARDS = 32;  // shards of one launch (kernel parameters)

// Chunk geometry in units of 16 bytes (a float4) where every run, stride
// and pointer aligns to them, else of one element (a float, or the 2 bytes
// of a bfloat16, copied as an unsigned short): chunk c of a slab is `runs`
// runs of `run_len` units, `run_stride` apart, starting at c *
// chunk_stride; it lands at the same offsets of the destination's output
// slab.  The kernel copies units and never reads them as numbers.
struct Args {
  const void* src[MAX_SHARDS][2];  // d = 0: the hi slab; d = 1: the lo slab
  void* out[MAX_SHARDS][2];        // d = 0: from_left; d = 1: from_right
  int* ready[MAX_SHARDS];          // (2, nc) ready counters of each shard
  int dest[MAX_SHARDS][2];         // d = 0: the next shard; 1: the previous
  int nc;
  long run_len, run_stride, chunk_stride;
};

// grid (parts of a run, runs, nc * 2 * S): block (p, r, (s * 2 + d) * nc
// + c) copies units [p * SPAN, (p + 1) * SPAN) of run r of chunk c of
// shard s's direction-d slab into dest[s][d]'s output slab.
template <class T>
__global__ void __launch_bounds__(THREADS) ring_exchange(const Args a) {
  const int zc = blockIdx.z;
  const int c = zc % a.nc, sd = zc / a.nc;
  const int d = sd & 1, s = sd >> 1;
  const int to = a.dest[s][d];
  const long off = c * a.chunk_stride + blockIdx.y * a.run_stride;
  const T* __restrict__ src = static_cast<const T*>(a.src[s][d]) + off;
  T* __restrict__ out = static_cast<T*>(a.out[to][d]) + off;
  const long e0 = static_cast<long>(blockIdx.x) * SPAN + threadIdx.x;
  T v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long e = e0 + j * THREADS;
    if (e < a.run_len) v[j] = src[e];
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long e = e0 + j * THREADS;
    if (e < a.run_len) out[e] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<int, cuda::thread_scope_device> r(
        a.ready[to][d * a.nc + c]);
    r.fetch_add(1, cuda::memory_order_release);
  }
}

// The kernel's instance for a unit of `unit` bytes (16, 4 or 2), or null.
const void* kernel_for(int unit) {
  switch (unit) {
    case 16:
      return reinterpret_cast<const void*>(ring_exchange<float4>);
    case 4:
      return reinterpret_cast<const void*>(ring_exchange<float>);
    case 2:
      return reinterpret_cast<const void*>(
          ring_exchange<unsigned short>);
    default:
      return nullptr;
  }
}

}  // namespace

// The blocks that write into one chunk: runs times the parts of a run of
// `run_len` units.
EXPORT long ring_exchange_blocks(long runs, long run_len) {
  return runs * ((run_len + SPAN - 1) / SPAN);
}

// One launch on `stream`: for each of the S shards (indices 0..S-1 of this
// launch), slabs[s] (its hi slab) lands in next[s]'s from_left and
// slabs[S + s] (its lo slab) in prev[s]'s from_right, chunk by chunk.  The
// received slabs are `out`, (2, S) slabs of `slab_bytes` each (from_left,
// then from_right); `counters` (S, 2, nc) int32 are the ready counters,
// zeroed here on the stream before the copy.  The geometry is in units of
// `unit` bytes: 16 (every run, stride and pointer 16-byte aligned), or the
// element's 4 (float32) or 2 (bfloat16).  Returns a cudaError_t code.
EXPORT int ring_exchange_launch(int S, const void* const* slabs, void* out,
                                long slab_bytes, int* counters,
                                const int* next, const int* prev, int nc,
                                long runs, long run_len, long run_stride,
                                long chunk_stride, int unit, void* stream) {
  const void* kernel = kernel_for(unit);
  const long parts = (run_len + SPAN - 1) / SPAN;
  if (S < 1 || S > MAX_SHARDS || nc < 1 || runs < 1 || runs > 65535 ||
      run_len < 1 || parts > 0x7fffffffL ||
      static_cast<long>(nc) * 2 * S > 65535 || !kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      counters, 0, sizeof(int) * static_cast<size_t>(S) * 2 * nc, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{};
  char* o = static_cast<char*>(out);
  for (int s = 0; s < S; ++s) {
    a.src[s][0] = slabs[s];
    a.src[s][1] = slabs[S + s];
    a.out[s][0] = o + s * slab_bytes;
    a.out[s][1] = o + (S + s) * slab_bytes;
    a.ready[s] = counters + s * 2 * nc;
    a.dest[s][0] = next[s];
    a.dest[s][1] = prev[s];
  }
  a.nc = nc;
  a.run_len = run_len;
  a.run_stride = run_stride;
  a.chunk_stride = chunk_stride;
  void* params[] = {&a};
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(runs),
                  static_cast<unsigned>(nc * 2 * S));
  e = cudaLaunchKernel(kernel, grid, dim3(THREADS), params, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

EXPORT const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
