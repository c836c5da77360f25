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
// one card.
//
// Bound on an H100: device-memory bytes, each slab read once and each
// received slab written once.  What the design does for it: an ordinary
// launch of as many blocks as the chunks need (no residency cap), each
// thread with ILP independent 16-byte loads in flight before its stores,
// and a grid of (part, run, chunk x direction x shard) blocks, so a block
// copies one contiguous span of one run and computes no index by division.

// ring_send and ring_drain: the same shift between processes (ROADMAP B7),
// the TPU kernel's remote-DMA protocol again.  Every process exports one
// region of device memory a site (cudaMalloc, cudaIpcGetMemHandle) and
// maps its peers' (cudaIpcOpenMemHandle): `nslots` receive slots a
// (direction, local shard), a ready flag and a credit a block.  ring_send
// stores every chunk of each local shard's slab into its destination's
// receive slot for this epoch (epoch % nslots; in a peer's region, or in
// this process's own for a local neighbour), then publishes the block's
// ready flag in the receiver's region as the epoch (__threadfence_system,
// then a system-scope release store).  ring_drain acquires each block's
// flag at the epoch, copies the slot into the output slab at the same
// offsets and releases the block's credit, carrying the epoch, into the
// sender's region; a send reuses a slot only once its credit reads epoch -
// nslots.  Epochs never repeat, so nothing is zeroed between launches (a
// peer could not zero a counter of ours): the memset of ring_exchange is
// the epoch here.  Send and drain are two stream-ordered launches of one
// grid each, one flag and one credit a block: a drain block waits only for
// the send block of the same span, and a send block only for the drain
// block that last read its slot, so no block waits on another block of its
// own launch and a launch that spins leaves every other launch free to
// run.  A wait spins on one thread with __nanosleep up to `timeout_ns`
// (%globaltimer); past it the block claims this process's error word,
// records the site, epoch, shard, direction, chunk and peer in mapped host
// memory and returns, and every later wait of the process returns at once,
// so a dead peer never hangs the run: the wrapper raises.  Bound: the same
// bytes as ring_exchange, each over the slot: the send reads each slab
// once and writes its slot, the drain reads the slot and writes the
// output.

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


// ---- the peer ring across processes: ring_send, ring_drain ----------------

// One launch's operands, per (local shard s, direction d):
//   ring_send:  src = the slab (d = 0: hi, 1: lo), dst = the destination's
//               receive slot for this epoch, ready = the destination's
//               flags of (its shard, d), credit = this process's credits
//               of (s, d);
//   ring_drain: src = this process's receive slot of (s, d) for this
//               epoch, dst = the output slab, ready = this process's flags
//               of (s, d), credit = the sender's credits of (its shard, d).
// A flags or credits array holds one int a block: (chunk, run, part).
struct PeerArgs {
  const void* src[MAX_SHARDS][2];
  void* dst[MAX_SHARDS][2];
  int* ready[MAX_SHARDS][2];
  int* credit[MAX_SHARDS][2];
  int peer[MAX_SHARDS][2];  // the other side's process, for the record
  int nc, epoch, nslots, site;
  long run_len, run_stride, chunk_stride;
  unsigned long long timeout_ns;
  volatile int* record;  // mapped host memory: the first timeout's details
};

// Set by the first wait that times out in this process; read by every wait.
__device__ int g_claimed = 0;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 of a block: wait until *flag >= want (system-scope acquire).
// False when this process's error word is claimed, by this wait (its
// deadline passed: `code` 1 for a drain's ready flag, 2 for a send's
// credit, recorded with the block's place) or by an earlier one.
__device__ bool await_epoch(int* flag, int want, const PeerArgs& a, int code,
                            int s, int d, int c) {
  cuda::atomic_ref<int, cuda::thread_scope_system> f(*flag);
  if (f.load(cuda::memory_order_acquire) >= want) return true;
  cuda::atomic_ref<int, cuda::thread_scope_device> claimed(g_claimed);
  const unsigned long long t0 = now_ns();
  unsigned ns = 64;
  for (;;) {
    if (claimed.load(cuda::memory_order_relaxed) != 0) return false;
    __nanosleep(ns);
    if (ns < 8192) ns <<= 1;
    if (f.load(cuda::memory_order_acquire) >= want) return true;
    if (now_ns() - t0 > a.timeout_ns) {
      int free_word = 0;
      if (claimed.compare_exchange_strong(free_word, 1,
                                          cuda::memory_order_relaxed)) {
        a.record[1] = a.site;
        a.record[2] = a.epoch;
        a.record[3] = s;
        a.record[4] = d;
        a.record[5] = c;
        a.record[6] = a.peer[s][d];
        a.record[7] = want;
        __threadfence_system();
        a.record[0] = code;
        __threadfence_system();
      }
      return false;
    }
  }
}

// grid (parts of a run, runs, nc * 2 * S): block (p, r, (s * 2 + d) * nc +
// c) moves units [p * SPAN, (p + 1) * SPAN) of run r of chunk c of (s, d);
// its flag and credit are entry (c * runs + r) * parts + p.
template <class T>
__global__ void __launch_bounds__(THREADS) ring_send(const PeerArgs a) {
  const int zc = blockIdx.z;
  const int c = zc % a.nc, sd = zc / a.nc;
  const int d = sd & 1, s = sd >> 1;
  const long fi = (static_cast<long>(c) * gridDim.y + blockIdx.y)
      * gridDim.x + blockIdx.x;
  __shared__ bool go;
  if (threadIdx.x == 0)
    go = await_epoch(a.credit[s][d] + fi, a.epoch - a.nslots, a, 2, s, d, c);
  __syncthreads();
  if (!go) return;
  const long off = c * a.chunk_stride + blockIdx.y * a.run_stride;
  const T* __restrict__ src = static_cast<const T*>(a.src[s][d]) + off;
  T* __restrict__ out = static_cast<T*>(a.dst[s][d]) + off;
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
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_system> r(a.ready[s][d][fi]);
    r.store(a.epoch, cuda::memory_order_release);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS) ring_drain(const PeerArgs a) {
  const int zc = blockIdx.z;
  const int c = zc % a.nc, sd = zc / a.nc;
  const int d = sd & 1, s = sd >> 1;
  const long fi = (static_cast<long>(c) * gridDim.y + blockIdx.y)
      * gridDim.x + blockIdx.x;
  __shared__ bool go;
  if (threadIdx.x == 0)
    go = await_epoch(a.ready[s][d] + fi, a.epoch, a, 1, s, d, c);
  __syncthreads();
  if (!go) return;
  const long off = c * a.chunk_stride + blockIdx.y * a.run_stride;
  // the slot was written by another launch, maybe another process: read it
  // at L2 (no stale L1 line)
  const T* src = static_cast<const T*>(a.src[s][d]) + off;
  T* __restrict__ out = static_cast<T*>(a.dst[s][d]) + off;
  const long e0 = static_cast<long>(blockIdx.x) * SPAN + threadIdx.x;
  T v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long e = e0 + j * THREADS;
    if (e < a.run_len) v[j] = __ldcg(src + e);
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const long e = e0 + j * THREADS;
    if (e < a.run_len) out[e] = v[j];
  }
  // every load of the slot has returned: the sender may write it again
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    cuda::atomic_ref<int, cuda::thread_scope_system> r(a.credit[s][d][fi]);
    r.store(a.epoch, cuda::memory_order_release);
  }
}

// The instance of ring_send (drain = 0) or ring_drain (1) for a unit of
// `unit` bytes, or null.
const void* peer_kernel_for(int drain, int unit) {
  switch (unit) {
    case 16:
      return drain ? reinterpret_cast<const void*>(ring_drain<float4>)
                   : reinterpret_cast<const void*>(ring_send<float4>);
    case 4:
      return drain ? reinterpret_cast<const void*>(ring_drain<float>)
                   : reinterpret_cast<const void*>(ring_send<float>);
    case 2:
      return drain
          ? reinterpret_cast<const void*>(ring_drain<unsigned short>)
          : reinterpret_cast<const void*>(ring_send<unsigned short>);
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

// ---- the peer ring's regions and launches ---------------------------------
// Every entry point takes the process's card (the runtime of this library
// keeps its own current device) and returns a cudaError_t code.

// The bytes of an IPC handle (what peer_region_alloc writes).
EXPORT long peer_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// One region of `bytes` on `device`, zeroed (slots, flags and credits start
// at epoch 0), and its IPC handle.
EXPORT int peer_region_alloc(int device, long bytes, void** ptr,
                             void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(e);
}

// A peer's region, mapped into this process (peer access enabled when the
// region lives on another card).
EXPORT int peer_region_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(
        ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(e);
}

// Unmap a peer's region: before its owner frees it.
EXPORT int peer_region_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(e);
}

// Free this process's region: once every peer has closed it.
EXPORT int peer_region_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaFree(ptr);
  return static_cast<int>(e);
}

// Copy `bytes` of device memory to the host (the flag check), synchronously.
EXPORT int peer_region_read(int device, void* host, const void* src,
                            long bytes) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpy(host, src, static_cast<size_t>(bytes),
                   cudaMemcpyDeviceToHost);
  return static_cast<int>(e);
}

// The process's error record: 8 ints of mapped host memory, zeroed.
EXPORT int peer_record_alloc(int device, int** host) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaHostAlloc(reinterpret_cast<void**>(host), 8 * sizeof(int),
                      cudaHostAllocMapped | cudaHostAllocPortable);
  if (e == cudaSuccess)
    for (int i = 0; i < 8; ++i) (*host)[i] = 0;
  return static_cast<int>(e);
}

// Clear the error word and the record (after a deliberate timeout).
EXPORT int peer_record_reset(int device, int* host) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_claimed, &zero, sizeof(int));
  if (e == cudaSuccess)
    for (int i = 0; i < 8; ++i) host[i] = 0;
  return static_cast<int>(e);
}

// One ring_send (drain = 0) or ring_drain (1) launch on `stream` for the S
// local shards: src, dst, ready, credit and peer hold 2 S entries, (s, d)
// at s * 2 + d, as PeerArgs says.  Geometry in units of `unit` bytes, as
// ring_exchange_launch's; `record` is the mapped error record.
EXPORT int ring_peer_launch(int drain, int device, int S,
                            const void* const* src, void* const* dst,
                            int* const* ready, int* const* credit,
                            const int* peer, int nc, int epoch, int nslots,
                            int site, long runs, long run_len,
                            long run_stride, long chunk_stride, int unit,
                            double timeout_s, int* record, void* stream) {
  const void* kernel = peer_kernel_for(drain, unit);
  const long parts = (run_len + SPAN - 1) / SPAN;
  if (S < 1 || S > MAX_SHARDS || nc < 1 || runs < 1 || runs > 65535 ||
      run_len < 1 || parts > 0x7fffffffL ||
      static_cast<long>(nc) * 2 * S > 65535 || !kernel || epoch < 1 ||
      nslots < 1 || timeout_s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  PeerArgs a{};
  for (int s = 0; s < S; ++s)
    for (int d = 0; d < 2; ++d) {
      a.src[s][d] = src[s * 2 + d];
      a.dst[s][d] = dst[s * 2 + d];
      a.ready[s][d] = ready[s * 2 + d];
      a.credit[s][d] = credit[s * 2 + d];
      a.peer[s][d] = peer[s * 2 + d];
    }
  a.nc = nc;
  a.epoch = epoch;
  a.nslots = nslots;
  a.site = site;
  a.run_len = run_len;
  a.run_stride = run_stride;
  a.chunk_stride = chunk_stride;
  a.timeout_ns = static_cast<unsigned long long>(timeout_s * 1e9);
  void* rec = nullptr;
  e = cudaHostGetDevicePointer(&rec, record, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.record = static_cast<volatile int*>(rec);
  void* params[] = {&a};
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(runs),
                  static_cast<unsigned>(nc * 2 * S));
  e = cudaLaunchKernel(kernel, grid, dim3(THREADS), params, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

EXPORT const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
