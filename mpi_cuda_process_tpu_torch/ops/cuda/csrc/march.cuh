// The tiled compute_fn kernels (K4 zchunk_heat, K7 whole2d): one update of
// a halo-padded block, marched down its first axis through a ring of
// planes in shared memory.
//
// A block takes work items in turn (a persistent grid, sized to the card's
// waves by the host): an item is a tile of TY rows by TX cells of the
// output planes and a run of ZR planes along the march axis (3D: z; 2D: y,
// where a "plane" is one row of TX + 2 cells).  It copies the padded
// planes of the run into a ring of S slots, IN_FLIGHT planes ahead of the
// one it waits for, and updates output plane z once planes z - h .. z + h
// are in: iteration q waits for plane q, passes one barrier, issues plane
// q + IN_FLIGHT into slot (q + IN_FLIGHT) % S and computes output plane
// q - 2h.  A slot is overwritten only after the barrier that follows its
// plane's last read, which needs S >= IN_FLIGHT + 2h + 1
// (kernels.py::ring_slots; tests/compute_schedule.py replays the order on
// the CPU and raises on a read of a slot that does not hold its plane).
//
// Alignment.  The padded row pitch (X + 2h cells) is rarely a multiple of
// 16 bytes, and the interior starts h cells into a row, so a row's cells
// are not 16-byte aligned.  Each row segment is copied as the 16-byte
// aligned words that cover it (cp.async of 16 bytes), into a row buffer at
// the same offset mod 16 as in device memory; a table gives each row's
// first cell in shared memory.  A word that reaches before the tensor's
// first byte or past its last (only at the block's two ends) is copied
// cell by cell, the segment's cells only, so no copy reads outside the
// tensor (kernels.py::row_copy_plan is the same plan, held by the CPU
// tests).  Taps then read shared memory at any 4- or 2-byte offset.
//
// Cells.  A group of RW warps updates one tile row at a time (2D: the
// block updates the row), its lanes taking NU interleaved units each (a
// unit is a cell of float32 or int32, a pair of bfloat16 cells): shared
// reads of a tap are consecutive words across the warp (no bank conflict)
// and stores are coalesced.  The taps are stencil_taps.cuh's /
// stencil2d.cuh's updates over a ring accessor, in the plain order, so
// every type is bit-equal to the plain version; a bfloat16 pair is read
// with one byte permute of two aligned words and added with the bf16x2
// ops of stencil_taps.cuh.  With the z queue (ZQ; heat3d, heat3d4th, a
// tile of one row a group) a thread keeps its cells' values of planes
// z - h .. z + h in registers, one plane read a step, and only the
// in-plane taps come from shared memory.
//
// Bound on an H100: device-memory bytes (one read of the padded block, one
// write of the interior).  Each cell is read from device memory about once
// (the tile's halo rows and columns again, from L2), every load is a
// 16-byte copy that lands in shared memory without passing registers, and
// IN_FLIGHT planes of every resident block are in flight at once.

#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "stencil2d.cuh"

namespace march {

// planes a block keeps in flight (cp.async groups outstanding; more cost
// the shared memory of the blocks an SM holds, and were no faster)
constexpr int IN_FLIGHT = 2;
// bytes of pad before and after each row buffer's words: a pair read
// touches the 4-byte word before a row's first cell or after its last
constexpr int ROW_PAD = 16;

// A launch's geometry (kernels.py::march_geometry computes the same).
struct Geom {
  int M;            // output planes along the march axis (3D: Z; 2D: H)
  int Y, X;         // output rows and cells of a plane (2D: Y = 1)
  int PY, PX;       // padded rows and cells of a plane (2D: PY = 1)
  int TX, TY, ZR;   // the tile's cells and rows, the run's planes
  int PR;           // rows of a plane tile (3D: TY + 2h; 2D: 1)
  int RWB;          // bytes of a row buffer
  int S;            // ring slots
  int tiles_x, tiles_y, runs;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest IN_FLIGHT - 1 has landed
__device__ __forceinline__ void cp_async_wait_landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(IN_FLIGHT - 1) : "memory");
}

template <int KIND>
__host__ __device__ constexpr bool is_2d() {
  return KIND == HEAT5 || KIND == LIFE;
}
template <int KIND>
__host__ __device__ constexpr int halo_of() {
  return is_2d<KIND>() ? 1 : kind_halo(KIND);
}
// bfloat16 cells go in pairs (a unit of two cells, the bf16x2 ops);
// float32 and int32 cells one by one
template <class T>
__host__ __device__ constexpr bool paired() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// One row of a unit's taps: where the thread's first unit's cell sits in a
// row buffer.  A unit `off` cells further (a constant) reads the cell
// e + off + dx, widened (float; int for Life), or in bfloat16 the pair of
// cells from there: two aligned 4-byte words and one byte permute whose
// selector the row's parity fixes, so the words a row's taps share are
// read once and every address is the row's register plus a constant.
template <class T>
struct Row {
  int e;
  __device__ __forceinline__ void init(int elem) { e = elem; }
  __device__ __forceinline__ auto read(const T* s, int off, int dx) const {
    return widen(s[e + off + dx]);
  }
};
template <>
struct Row<__nv_bfloat16> {
  int w;              // the word holding the first unit's cell
  unsigned sel[2];    // byte-permute selectors for even and odd dx
  __device__ __forceinline__ void init(int elem) {
    w = elem >> 1;
    const bool odd = elem & 1;
    sel[0] = odd ? 0x5432u : 0x3210u;
    sel[1] = odd ? 0x7654u : 0x5432u;
  }
  __device__ __forceinline__ bf2 read(const __nv_bfloat16* s, int off,
                                      int dx) const {
    const unsigned* ws = reinterpret_cast<const unsigned*>(s);
    const int j = w + (off >> 1) + (dx >> 1);
    return bf2{__byte_perm(ws[j], ws[j + 1], sel[dx & 1])};
  }
};

// Taps of a unit `off` cells from the thread's first: row[dz + H][dy + H]
// is the row dy rows and dz planes from the unit's (3D).
template <class T, int H>
struct Ring3 {
  using value_type = T;
  const T* s;
  const Row<T> (&row)[2 * H + 1][2 * H + 1];
  int off;
  __device__ __forceinline__ auto operator()(int dz, int dy, int dx) const {
    return row[dz + H][dy + H].read(s, off, dx);
  }
};
// 2D: the march axis is y, a plane is one row.
template <class T>
struct Ring2 {
  using value_type = T;
  const T* s;
  const Row<T> (&row)[3];
  int off;
  __device__ __forceinline__ auto operator()(int dy, int dx) const {
    return row[dy + 1].read(s, off, dx);
  }
};

// The z queue of a thread whose group owns one tile row (3D kinds whose
// taps off the plane are the cell's own column, heat3d and heat3d4th):
// its units' cells in planes qc - h .. qc + h, one plane read a step, so
// the z taps come from registers and shared memory serves the in-plane
// ones.
template <class T, int H, int NU>
struct ZQueue {
  using V = decltype(Row<T>{}.read(nullptr, 0, 0));
  V v[NU][2 * H + 1];
};
template <class T, int H, int NU>
struct Ring3Q {
  using value_type = T;
  const T* s;
  const Row<T> (&row)[2 * H + 1][2 * H + 1];
  int off;
  const ZQueue<T, H, NU>& zq;
  int u;
  __device__ __forceinline__ auto operator()(int dz, int dy, int dx) const {
    if (dy == 0 && dx == 0) return zq.v[u][dz + H];
    return row[dz + H][dy + H].read(s, off, dx);
  }
};

template <class T>
__device__ __forceinline__ void store_cell(T* q, float v) {
  *q = narrow<T>(v);
}
__device__ __forceinline__ void store_cell(int* q, int v) { *q = v; }
// a pair: one 4-byte store where the pair is aligned and whole, else its
// cells one by one (a ragged row's last pair, an odd row pitch)
__device__ __forceinline__ void store_cell(__nv_bfloat16* q, bf2 v,
                                           bool second) {
  if (second && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    *reinterpret_cast<unsigned*>(q) = v.v;
    return;
  }
  reinterpret_cast<unsigned short*>(q)[0] =
      static_cast<unsigned short>(v.v & 0xffffu);
  if (second) {
    reinterpret_cast<unsigned short*>(q)[1] =
        static_cast<unsigned short>(v.v >> 16);
  }
}

// The update of one unit through accessor `a`.
template <int KIND, class A>
__device__ __forceinline__ auto update(const A& a, const Coef& c) {
  if constexpr (KIND == LIFE) {
    return life8(a);
  } else if constexpr (KIND == HEAT5) {
    return heat5(a, c.a);
  } else {
    return heat_update<KIND>(a, c);
  }
}

// Copy padded plane `pz`'s tile (rows y0 .., cells x0 .. x0 + TX + 2h) into
// ring slot `slot`: 3D, groups of RW warps take rows and their lanes a
// row's 16-byte words; 2D, the block takes the one row's words.
template <int KIND, class T, int NT, int RW>
__device__ __forceinline__ void issue_plane(
    const T* __restrict__ p, unsigned char* smem, int* rs, const Geom& g,
    int pz, int slot, int x0, int y0, uintptr_t lo, uintptr_t hi) {
  constexpr int H = halo_of<KIND>();
  constexpr int ES = sizeof(T);
  constexpr int GROUP = is_2d<KIND>() ? NT : 32 * RW;
  const int grp = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  const int n = min(g.TX + 2 * H, g.PX - x0);  // the segment's cells
  for (int r = grp; r < g.PR; r += NT / GROUP) {
    const int row = slot * g.PR + r;
    unsigned char* dst = smem + static_cast<long>(row) * g.RWB + ROW_PAD;
    const int py = is_2d<KIND>() ? 0 : y0 + r;
    if (py >= g.PY) {  // past the block: any in-bounds offset (masked)
      if (lane == 0) rs[row] = (row * g.RWB + ROW_PAD) / ES;
      continue;
    }
    const T* src = p + (static_cast<long>(pz) * g.PY + py) * g.PX + x0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a1 = a + static_cast<uintptr_t>(n) * ES;
    const uintptr_t w0 = a & ~static_cast<uintptr_t>(15);
    const int nw = static_cast<int>((((a1 + 15) & ~static_cast<uintptr_t>(15))
                                     - w0) >> 4);
    if (lane == 0) {
      rs[row] = (row * g.RWB + ROW_PAD) / ES + static_cast<int>(a - w0) / ES;
    }
    if (w0 >= lo && w0 + 16 * static_cast<uintptr_t>(nw) <= hi) {
      for (int k = lane; k < nw; k += GROUP) {
        cp_async16(dst + 16 * k, reinterpret_cast<const void*>(w0 + 16 * k));
      }
      continue;
    }
    for (int k = lane; k < nw; k += GROUP) {
      const uintptr_t wa = w0 + 16 * static_cast<uintptr_t>(k);
      unsigned char* d = dst + 16 * k;
      if (wa >= lo && wa + 16 <= hi) {
        cp_async16(d, reinterpret_cast<const void*>(wa));
      } else {  // the tensor's first or last word: the segment's cells
#pragma unroll
        for (int i = 0; i < 16 / ES; ++i) {
          const uintptr_t ca = wa + i * ES;
          if (ca >= a && ca < a1) {
            reinterpret_cast<T*>(d)[i] = *reinterpret_cast<const T*>(ca);
          }
        }
      }
    }
  }
}

// Update output plane `z` of the item, whose centre plane sits in ring
// position `qc` (planes qc - h .. qc + h in slots (qc + dz) % S).  A thread
// updates NU units of each of its rows, GROUP units apart (3D: a group of
// RW warps a row; 2D: the block on the row); with ZQ, the group's one row
// and its z taps from the queue.
template <int KIND, class T, int NT, int NU, int RW, bool ZQ>
__device__ __forceinline__ void compute_plane(
    T* __restrict__ out, const unsigned char* smem, const int* rs,
    const Geom& g, const Coef& c, int z, int qc, int x0, int y0,
    const ZQueue<T, halo_of<KIND>(), NU>& zq) {
  constexpr int H = halo_of<KIND>();
  constexpr bool D2 = is_2d<KIND>();
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = D2 ? NT : 32 * RW;
  const int grp = threadIdx.x / GROUP, pos = threadIdx.x % GROUP;
  const T* s = reinterpret_cast<const T*>(smem);
  const int first = H + pos * UW;    // the first unit's cell in a row
  const int xlim = g.X - x0 - pos * UW;  // units at off < xlim are inside
  int sl[2 * H + 1];
#pragma unroll
  for (int dz = -H; dz <= H; ++dz) {
    sl[dz + H] = ((qc + dz) % g.S) * g.PR;
  }
  const int rows = D2 ? 1 : g.TY;
  for (int r = grp; r < rows; r += NT / GROUP) {
    const int y = D2 ? 0 : y0 + r;
    if (y >= g.Y) break;
    T* op = out + (static_cast<long>(z) * g.Y + y) * g.X + x0 + pos * UW;
    if constexpr (D2) {
      Row<T> row[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        row[dy + 1].init(rs[sl[dy + 1]] + first);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int off = u * GROUP * UW;
        if (off < xlim) {
          const auto v = update<KIND>(Ring2<T>{s, row, off}, c);
          if constexpr (paired<T>()) {
            store_cell(op + off, v, off + 1 < xlim);
          } else {
            store_cell(op + off, v);
          }
        }
      }
    } else {
      Row<T> row[2 * H + 1][2 * H + 1];
#pragma unroll
      for (int dz = -H; dz <= H; ++dz) {
#pragma unroll
        for (int dy = -H; dy <= H; ++dy) {
          row[dz + H][dy + H].init(rs[sl[dz + H] + r + H + dy] + first);
        }
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int off = u * GROUP * UW;
        if (off < xlim) {
          const auto v = [&] {
            if constexpr (ZQ) {
              return update<KIND>(Ring3Q<T, H, NU>{s, row, off, zq, u}, c);
            } else {
              return update<KIND>(Ring3<T, H>{s, row, off}, c);
            }
          }();
          if constexpr (paired<T>()) {
            store_cell(op + off, v, off + 1 < xlim);
          } else {
            store_cell(op + off, v);
          }
        }
      }
    }
  }
}

// Read plane q's cells of the thread's units in its group's row into the
// newest place of the z queue, the older ones moving down one.
template <int KIND, class T, int NT, int NU, int RW>
__device__ __forceinline__ void push_plane(
    ZQueue<T, halo_of<KIND>(), NU>& zq, const unsigned char* smem,
    const int* rs, const Geom& g, int q) {
  constexpr int H = halo_of<KIND>();
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = 32 * RW;
  const int r = threadIdx.x / GROUP, pos = threadIdx.x % GROUP;
  Row<T> row;
  row.init(rs[(q % g.S) * g.PR + r + H] + H + pos * UW);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int d = 0; d < 2 * H; ++d) zq.v[u][d] = zq.v[u][d + 1];
    zq.v[u][2 * H] = row.read(reinterpret_cast<const T*>(smem),
                              u * GROUP * UW, 0);
  }
}

// NT threads, MINB blocks an SM (the register cap: 65536 / (NT MINB)), NU
// units a thread in each of its rows, RW warps a row (3D); ZQ: the z queue
// (a tile of one row a group).
template <int KIND, class T, int NT, int MINB, int NU, int RW, bool ZQ>
__global__ void __launch_bounds__(NT, MINB)
march_step(const T* __restrict__ p, T* __restrict__ out, Geom g, Coef c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = halo_of<KIND>();
  int* rs = reinterpret_cast<int*>(smem + static_cast<long>(g.S) * g.PR *
                                              g.RWB);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p);
  const uintptr_t hi = lo + static_cast<uintptr_t>(g.M + 2 * H) * g.PY *
                                g.PX * sizeof(T);
  const int items = g.tiles_x * g.tiles_y * g.runs;
  ZQueue<T, H, NU> zq;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tx = item % g.tiles_x;
    const int rest = item / g.tiles_x;
    const int x0 = tx * g.TX, y0 = (rest % g.tiles_y) * g.TY;
    const int z0 = (rest / g.tiles_y) * g.ZR;
    const int nin = min(g.ZR, g.M - z0) + 2 * H;  // padded planes of the run
#pragma unroll
    for (int q = 0; q < IN_FLIGHT; ++q) {
      if (q < nin) {
        issue_plane<KIND, T, NT, RW>(p, smem, rs, g, z0 + q, q % g.S, x0, y0,
                                     lo, hi);
      }
      cp_async_commit();
    }
    for (int q = 0; q < nin; ++q) {
      cp_async_wait_landed();  // plane q (this thread's copies)
      __syncthreads();         // everyone's; and iteration q - 1 is done
      if (q + IN_FLIGHT < nin) {
        issue_plane<KIND, T, NT, RW>(p, smem, rs, g, z0 + q + IN_FLIGHT,
                                     (q + IN_FLIGHT) % g.S, x0, y0, lo, hi);
      }
      cp_async_commit();
      if constexpr (ZQ) {
        push_plane<KIND, T, NT, NU, RW>(zq, smem, rs, g, q);
      }
      if (q >= 2 * H) {
        compute_plane<KIND, T, NT, NU, RW, ZQ>(
            out, smem, rs, g, c, z0 + q - 2 * H, q - H, x0, y0, zq);
      }
    }
    __syncthreads();  // the next item's copies reuse slots read above
  }
}

// Host side: refuse a geometry the kernel cannot run (a ring one slot
// short, a row buffer too small for a segment, a tile row that is not NU
// units of each thread of its group), then launch a grid of the blocks the
// card holds at once (no more than the items).
inline bool geometry_ok(const Geom& g, int h, int es, bool d2, int tx,
                        int groups, bool zq) {
  if (zq && g.TY != groups) return false;
  const int seg = (g.TX + 2 * h) * es;
  const int need = 2 * ROW_PAD + ((seg + 15 + 15) / 16) * 16;
  if (g.S < IN_FLIGHT + 2 * h + 1 || g.RWB < need || g.RWB % 16) return false;
  if (g.TX != tx || g.TY < 1 || g.ZR < 1) return false;
  if (d2 && (g.TY != 1 || g.PR != 1)) return false;
  if (!d2 && g.PR != g.TY + 2 * h) return false;
  return true;
}

template <int KIND, class T, int NT, int MINB, int NU, int RW, bool ZQ>
int launch(const T* p, T* out, const Geom& g, const Coef& c,
           cudaStream_t stream) {
  constexpr int H = halo_of<KIND>();
  constexpr int UNIT = (paired<T>() ? 2 : 1) * (is_2d<KIND>() ? NT : 32 * RW);
  constexpr int TX = NU * UNIT;
  if (!geometry_ok(g, H, sizeof(T), is_2d<KIND>(), TX, NT / (32 * RW), ZQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = march_step<KIND, T, NT, MINB, NU, RW, ZQ>;
  const size_t smem = static_cast<size_t>(g.S) * g.PR * (g.RWB + 4);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long items = static_cast<long>(g.tiles_x) * g.tiles_y * g.runs;
  const int grid = static_cast<int>(std::min<long>(items, per_sm * sms));
  kern<<<grid, NT, smem, stream>>>(p, out, g, c);
  return static_cast<int>(cudaGetLastError());
}

// The builds a tile names (kernels.py::BUILDS, in order): threads, blocks
// an SM and, for 3D, warps a tile row (2D: the block is on the row); each
// in two unrolls, NU = 4 or 8 units a thread a row (the tile's TX is NU
// units of each thread of a row's group).
#define MARCH_BUILDS(X) X(0, 256, 2, 1) X(1, 512, 2, 1) X(2, 256, 2, 2)

// The kinds that take the z queue: 3D, every tap off the plane in the
// cell's own column.
template <int KIND>
__host__ __device__ constexpr bool queues() {
  return KIND == HEAT7 || KIND == HEAT13;
}

template <int KIND, class T, int NT, int MINB, int RW, bool ZQ>
int launch_unroll(const T* p, T* out, const Geom& g, const Coef& c,
                  cudaStream_t s) {
  constexpr int UNIT = (paired<T>() ? 2 : 1) * (is_2d<KIND>() ? NT : 32 * RW);
  if (g.TX == 4 * UNIT) {
    return launch<KIND, T, NT, MINB, 4, RW, ZQ>(p, out, g, c, s);
  }
  if (g.TX == 8 * UNIT) {
    return launch<KIND, T, NT, MINB, 8, RW, ZQ>(p, out, g, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KIND, class T>
int launch_build(int build, bool zq, const T* p, T* out, const Geom& g,
                 const Coef& c, cudaStream_t s) {
  switch (build) {
#define MARCH_CASE(ID, NT, MINB, RW)                                        \
  case ID: {                                                                \
    if constexpr (is_2d<KIND>() && RW != 1) {                               \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    } else if constexpr (queues<KIND>()) {                                  \
      if (zq) {                                                             \
        return launch_unroll<KIND, T, NT, MINB, RW, true>(p, out, g, c, s); \
      }                                                                     \
      return launch_unroll<KIND, T, NT, MINB, RW, false>(p, out, g, c, s);  \
    } else {                                                                \
      if (zq) return static_cast<int>(cudaErrorInvalidValue);               \
      return launch_unroll<KIND, T, NT, MINB, RW, false>(p, out, g, c, s);  \
    }                                                                       \
  }
    MARCH_BUILDS(MARCH_CASE)
#undef MARCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace march
