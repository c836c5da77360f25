// ring_exchange: both ring directions of one mesh axis for one slab pair,
// chunk by chunk through an nslots-deep receive ring with credit flow
// control, for every ring of shards that lives on one device, in one
// cooperative launch.
//
// Replaces: the TPU package's ops/pallas/remote.py — build_ring_exchange_call
// and its _ring_kernel (the in-kernel remote-DMA halo exchange), with the
// chunk geometry of pick_chunks (the wrapper computes it, remote.py here).
//
// On the TPU each chip runs the kernel for its own shard: it stages its
// slab chunk by chunk through a VMEM send ring and pushes each chunk into
// the ring neighbour's VMEM receive ring with a remote DMA, under send,
// receive and credit semaphores, behind a per-call barrier.  Here the shards
// of a mesh that share one card are the ring's members, and the protocol
// runs between co-resident thread blocks: the grid is (G, 2, S), G blocks
// for each (direction, shard), and the G blocks of one (direction, shard)
// each move a fixed share of every chunk.  Direction 0 sends a shard's hi
// slab to the next shard, where it lands as that shard's from_left;
// direction 1 sends the lo slab to the previous shard (from_right).  Per
// chunk c, slot q = c % nslots and use u = c / nslots:
//
//   1. for u > 0 the sender waits until its neighbour's credit counter of
//      slot q reaches G * u (every share of the slot's last use drained);
//   2. it writes its share straight into the neighbour's receive slot in
//      device memory (no send ring: a block's stores need no staging) and
//      signals the slot's ready counter (fence, then a release add);
//   3. the receiver waits until its own ready counter of slot q reaches
//      G * (u + 1) (every sender block's share landed), drains its share of
//      the slot into the output slab and credits the slot (a release add).
//
// At exit every ready and credit counter equals G times the uses of its
// slot: every signal sent was consumed.  The sender waits for its trailing
// credits before it exits, the counterpart of the TPU kernel's epilogue, so
// a kernel that returns has seen every credit.  That is the port's form of
// "every semaphore is zero at exit"; the wrapper zeroes the counters before
// each launch (one memset on the stream), the role of the TPU kernel's
// per-call barrier, so back-to-back launches never see stale counts.
//
// Blocks wait on other blocks, so all of them must be resident at once: a
// cooperative launch guarantees that or fails (the wrapper raises).  A wait
// that spins past 2 s of %globaltimer traps, so a protocol fault fails the
// run at the next synchronize instead of hanging it.  Thread 0 of a block
// waits (acquire), then __syncthreads(), before the block reads a slot; the
// slots are read and written with __ldcg/__stcg (L2, not the SM's L1).
//
// The kernel takes a raw pointer to every shard's slabs, receive ring and
// counters, so a ring across cards (peer writes over NVLink, system-scope
// flags, one launch per card) can reuse it; the wrapper refuses such a ring
// today (ROADMAP B7).
//
// Bound on an H100: device-memory bytes, each slab read once and each
// received slab written once; the ring adds one write and one read of every
// chunk in L2 (a ring of two 2 MiB chunks per direction fits it).

#include <cuda/atomic>
#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SHARDS = 32;  // shards of one launch (kernel parameters)
constexpr unsigned long long TIMEOUT_NS = 2000000000ull;

// Chunk geometry in units of 16 bytes (a float4) where every run, stride
// and pointer aligns to them, else of one element (a float, or the 2 bytes
// of a bfloat16, copied as an unsigned short): chunk c of a slab is `runs`
// runs of `run_len` units, `run_stride` apart, starting at c *
// chunk_stride; in a receive slot the chunk is packed (runs * run_len
// units).  The kernel copies units and never reads them as numbers.
struct Args {
  const void* src[MAX_SHARDS][2];  // d = 0: the hi slab; d = 1: the lo slab
  void* out[MAX_SHARDS][2];        // d = 0: from_left; d = 1: from_right
  void* recv[MAX_SHARDS];          // (2, nslots, chunk) receive rings
  int* ready[MAX_SHARDS];          // (2, nslots) ready counters
  int* credit[MAX_SHARDS];         // (2, nslots) credit counters
  int dest[MAX_SHARDS][2];         // d = 0: the next shard; 1: the previous
  int G, nc, nslots;
  long runs, run_len, run_stride, chunk_stride;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block waits until *p >= target (thread 0 spins with acquire loads).
__device__ __forceinline__ void wait_at_least(int* p, int target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> r(*p);
    if (r.load(cuda::memory_order_acquire) < target) {
      const unsigned long long t0 = globaltimer();
      while (r.load(cuda::memory_order_acquire) < target) {
        if (globaltimer() - t0 > TIMEOUT_NS) __trap();
        __nanosleep(64);
      }
    }
  }
  __syncthreads();
}

// Every thread of the block is done with the slot; one release add.
__device__ __forceinline__ void signal(int* p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<int, cuda::thread_scope_device> r(*p);
    r.fetch_add(1, cuda::memory_order_release);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS) ring_exchange(const Args a) {
  const int g = blockIdx.x, d = blockIdx.y, s = blockIdx.z;
  const int to = a.dest[s][d];
  const long n = a.runs * a.run_len;  // units of one chunk
  const long lo = n * g / a.G, hi = n * (g + 1) / a.G;  // this block's share
  const T* src = static_cast<const T*>(a.src[s][d]);
  T* out = static_cast<T*>(a.out[s][d]);
  T* send_ring = static_cast<T*>(a.recv[to]) + d * a.nslots * n;
  const T* recv_ring = static_cast<const T*>(a.recv[s]) + d * a.nslots * n;
  int* send_ready = a.ready[to] + d * a.nslots;
  int* send_credit = a.credit[to] + d * a.nslots;
  int* my_ready = a.ready[s] + d * a.nslots;
  int* my_credit = a.credit[s] + d * a.nslots;
  for (int c = 0; c < a.nc; ++c) {
    const int q = c % a.nslots, u = c / a.nslots;
    const long base = c * a.chunk_stride;
    if (u > 0) wait_at_least(send_credit + q, a.G * u);
    T* slot = send_ring + q * n;
    for (long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const long r = i / a.run_len, e = i - r * a.run_len;
      __stcg(slot + i, src[base + r * a.run_stride + e]);
    }
    signal(send_ready + q);
    wait_at_least(my_ready + q, a.G * (u + 1));
    const T* rslot = recv_ring + q * n;
    for (long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const long r = i / a.run_len, e = i - r * a.run_len;
      out[base + r * a.run_stride + e] = __ldcg(rslot + i);
    }
    signal(my_credit + q);
  }
  // epilogue: consume the trailing credits of every slot this block's
  // neighbour drained
  const int used = a.nc < a.nslots ? a.nc : a.nslots;
  for (int q = 0; q < used; ++q)
    wait_at_least(send_credit + q, a.G * ((a.nc - q + a.nslots - 1) / a.nslots));
}

template <class T>
int blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ring_exchange<T>, THREADS, 0));
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

// The largest G at which a (G, 2, S) grid is co-resident on the current
// device, at most one block per SM (capped by the chunk's units: no block
// idles), for units of `unit` bytes.  Returns a cudaError_t code.
EXPORT int ring_exchange_blocks(int S, long units, int unit, int* G) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = unit == 16  ? blocks_per_sm<float4>(&per_sm)
           : unit == 4 ? blocks_per_sm<float>(&per_sm)
           : unit == 2 ? blocks_per_sm<unsigned short>(&per_sm)
                       : static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  const int resident = sms * (per_sm < 1 ? 1 : per_sm);
  const int cap = sms < resident ? sms : resident;
  long g = cap / (2 * S);
  const long need = (units + THREADS - 1) / THREADS;
  if (g > need) g = need;
  *G = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

// One cooperative launch on `stream`: for each of the S shards (indices
// 0..S-1 of this launch), hi[s] goes to next[s]'s from_left and lo[s] to
// prev[s]'s from_right, through the receive rings recv[s] (2, nslots, chunk)
// with the counters ready[s] and credit[s] (2, nslots each), which must be
// zero.  The geometry is in units of `unit` bytes: 16 (every run, stride
// and pointer 16-byte aligned), or the element's 4 (float32) or 2
// (bfloat16).  Returns a cudaError_t code.
EXPORT int ring_exchange_launch(int S, const void* const* hi,
                                const void* const* lo, void* const* from_left,
                                void* const* from_right, void* const* recv,
                                int* const* ready, int* const* credit,
                                const int* next, const int* prev, int nc,
                                int nslots, long runs, long run_len,
                                long run_stride, long chunk_stride, int unit,
                                int G, void* stream) {
  const void* kernel = kernel_for(unit);
  if (S < 1 || S > MAX_SHARDS || G < 1 || nc < 1 || nslots < 1 || !kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  for (int s = 0; s < S; ++s) {
    // block (g, d, s) sends src[s][d] into dest[s][d]'s ring and drains
    // ring s, which prev[s] (d = 0) or next[s] (d = 1) fills, into out[s][d]
    a.src[s][0] = hi[s];
    a.src[s][1] = lo[s];
    a.out[s][0] = from_left[s];
    a.out[s][1] = from_right[s];
    a.recv[s] = recv[s];
    a.ready[s] = ready[s];
    a.credit[s] = credit[s];
    a.dest[s][0] = next[s];
    a.dest[s][1] = prev[s];
  }
  a.G = G;
  a.nc = nc;
  a.nslots = nslots;
  a.runs = runs;
  a.run_len = run_len;
  a.run_stride = run_stride;
  a.chunk_stride = chunk_stride;
  void* params[] = {&a};
  const dim3 grid(G, 2, S);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, grid, dim3(THREADS), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

EXPORT const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
