// The tiled one-step kernels: the compute_fn kernels K4 zchunk_heat, K5
// zchunk_wave and K7 whole2d (one update of a halo-padded block) and the
// raw-step kernels K1 raw_step_heat, K2 raw_step_wave and
// raw_step_grayscott (one guard-frame step of the raw grid, the frame
// pinned here), marched down their first axis through a ring of planes in
// shared memory.
//
// A block takes work items in turn (a persistent grid, sized to the card's
// waves by the host): an item is a tile of TY rows by TX cells of the
// output planes and a run of ZR planes along the march axis (3D: z; 2D: y,
// where a "plane" is one row of TX + 2 cells).  A batched launch (the N
// members of an ensemble, Geom::N; the padded kinds only) has N times the
// items, member after member, each member's input and output one block
// (in_stride, out_stride cells) after the previous one's.  It copies the input planes
// of the run into a ring of S slots, IN_FLIGHT planes ahead of the one it
// waits for, and updates output plane z once input planes z - h .. z + h
// are in: iteration q waits for the run's input plane q, passes one
// barrier, issues plane q + IN_FLIGHT into slot (q + IN_FLIGHT) % S and
// computes the output plane whose plane z + h is q.  A slot is overwritten
// only after the barrier that follows its plane's last read, which needs
// S >= IN_FLIGHT + 2h + 1 (march.py::ring_slots; tests/compute_schedule.py
// replays the order on the CPU and raises on a read of a slot that does
// not hold its plane).
//
// Input and output.  The output is (M, Y, X), row pitch X.  The input is
// (PM, PY, PX), and output index i on each axis is input index i + CO: a
// padded block (K4, K5, K7: PM = M + 2h, CO = h) or, with FRAME, the raw
// grid itself (K1, K2, Gray-Scott: PM = M, CO = 0); CO is a compile-time
// constant, so the padded kernels carry none of the raw grid's clipping.  A
// tile's input rows and cells are those of its output cells widened by h on
// each side, clipped to the input: on the raw grid nothing outside it is
// copied, a row buffer's table entry points h cells before its first copied
// cell where the tile starts at the wall, and a run that starts at z = 0
// iterates from plane 0 (its first h output planes are frame).  Input planes
// past the grid's end are not issued.
//
// The frame (FRAME, FR = h).  A cell whose coordinate lies within h of a
// wall keeps its old value, read from the ring's centre plane (Gray-Scott:
// each field's own): bit for bit the plain step's re-pin.  A frame plane or
// row takes no taps; only a tile that touches an x wall selects cell by
// cell, and an item whose tile and run touch no wall carries no test at all
// (each test is block- or group-uniform).  One launch writes every cell.
//
// u_prev (K5 and K2, the wave kind).  The dense (M, Y, X) operand read once
// per output cell, by the thread that updates the cell: every wave tile is a
// z-queue tile (one row a group), and each thread loads its units' u_prev of
// output plane z into registers with coalesced loads before the barrier of
// the iteration that computes z (on the raw grid u_prev is indexed as the
// output, so K2 loads it as K5 does).  Timed on an H100 beside two other
// forms (PERF.md section 6): a ring of u_prev rows in shared memory, filled
// by cp.async in the commit group of the plane that completes z, was 7-10 %
// slower; loads one plane ahead (a second set of registers) were 15 % slower
// in float32 and no faster in bfloat16.
//
// Two fields (Gray-Scott, NF = fields_of<KIND>() = 2).  Each field has its
// own ring of S slots and its own row table, laid out after the first's
// (field f's slot s is the ring's slot f S + s), with the same geometry;
// the v plane tile of plane q is issued beside the u plane tile, in the
// same commit group, so one wait lands both.  The update reads both
// fields' taps from shared memory (no z queue: timed on an H100, the
// queues' registers made it no faster, PERF.md section 6) and writes both
// outputs, and frame cells keep both centres.  NF is a compile-time
// constant: a one-field kind carries none of the second field's code.
//
// Alignment.  A row pitch is rarely a multiple of 16 bytes, and the
// interior starts h cells into a row, so a row's cells are not 16-byte
// aligned.  Each row segment is copied as the 16-byte aligned words that
// cover it (cp.async of 16 bytes), into a row buffer at the same offset
// mod 16 as in device memory; a table gives each padded row's first cell
// in shared memory.  A word
// that reaches before the tensor's first byte or past its last (only at
// the tensor's two ends) is copied cell by cell, the segment's cells only,
// so no copy reads outside the tensor (march.py::row_copy_plan is the same
// plan, held by the CPU tests).  Taps then read shared memory at any 4- or
// 2-byte offset.
//
// Cells.  A group of RW warps updates one tile row at a time (2D: the
// block updates the row), its lanes taking NU interleaved units each (a
// unit is a cell of float32 or int32, a pair of bfloat16 cells): shared
// reads of a tap are consecutive words across the warp (no bank conflict)
// and stores are coalesced.  The taps are stencil_taps.cuh's /
// stencil2d.cuh's updates over a ring accessor, in the plain order, so
// every type is bit-equal to the plain version; a bfloat16 pair is read
// with one byte permute of two aligned words and added with the bf16x2
// ops of stencil_taps.cuh.  With the z queue (ZQ; heat3d, heat3d4th,
// wave3d, a tile of one row a group) a thread keeps its cells' values of
// planes z - h .. z + h in registers, one plane read a step, and only the
// in-plane taps come from shared memory.
//
// Bound on an H100: device-memory bytes (one read of each input, one write
// of each output).  Each cell is read from device memory about once (the
// tile's halo rows and columns again, from L2), every load is a 16-byte
// copy that lands in shared memory without passing registers, and
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
// touches the 4-byte word before a row's first cell or after its last,
// and a raw tile at the wall reads up to h cells before its first
constexpr int ROW_PAD = 16;

// A launch's geometry (march.py::march_geometry computes the same).
struct Geom {
  int M;            // output planes along the march axis (3D: Z; 2D: H)
  int Y, X;         // output rows and cells of a plane (2D: Y = 1)
  int PM, PY, PX;   // input planes, rows and cells (2D: PY = 1)
  int TX, TY, ZR;   // the tile's cells and rows, the run's planes
  int PR;           // rows of a plane tile (3D: TY + 2h; 2D: 1)
  int RWB;          // bytes of a row buffer
  int S;            // ring slots
  int tiles_x, tiles_y, runs;
  // members of a batched launch (an ensemble: N blocks of the input and of
  // the output back to back, the padded kinds only) and their strides in
  // cells; 1 and one block's cells otherwise
  int N;
  long in_stride, out_stride;
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
// Fields a kind marches: Gray-Scott's u and v, each read with its
// neighbours; one for every other kind (wave3d's u_prev is read at the
// cell only and takes no ring).
template <int KIND>
__host__ __device__ constexpr int fields_of() {
  return KIND == GRAYSCOTT ? 2 : 1;
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

// The value of a unit: a float (int for Life) or a bfloat16 pair.
template <class T>
using Val = decltype(Row<T>{}.read(nullptr, 0, 0));

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
// taps off the plane are the cell's own column, heat3d, heat3d4th and
// wave3d): its units' cells in planes z - h .. z + h, one plane read a
// step, so the z taps come from registers and shared memory serves the
// in-plane ones.
template <class T, int H, int NU>
struct ZQueue {
  Val<T> v[NU][2 * H + 1];
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

// u_prev of a thread's units in the output plane being computed (wave).
template <class T, int NU>
struct UpRegs {
  Val<T> v[NU];
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
template <class T, class V>
__device__ __forceinline__ void store_unit(T* q, const V& v, bool second) {
  if constexpr (paired<T>()) {
    store_cell(q, v, second);
  } else {
    store_cell(q, v);
  }
}

// A unit's u_prev from device memory: a cell, or a pair (one 4-byte load
// where it is aligned and whole).
__device__ __forceinline__ float load_unit(const float* q, bool) {
  return *q;
}
__device__ __forceinline__ bf2 load_unit(const __nv_bfloat16* q,
                                         bool second) {
  if (second && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    return bf2{*reinterpret_cast<const unsigned*>(q)};
  }
  const unsigned short* c = reinterpret_cast<const unsigned short*>(q);
  return bf2{static_cast<unsigned>(c[0]) |
             (second ? static_cast<unsigned>(c[1]) << 16 : 0u)};
}

// Frame cells of a unit at x (a pair: x and x + 1) keep the centre `c`.
__device__ __forceinline__ float pin_x(float v, float c, int x, int fr,
                                       int X) {
  return (x < fr || x >= X - fr) ? c : v;
}
__device__ __forceinline__ bf2 pin_x(bf2 v, bf2 c, int x, int fr, int X) {
  const unsigned m = ((x < fr || x >= X - fr) ? 0x0000ffffu : 0u) |
                     ((x + 1 < fr || x + 1 >= X - fr) ? 0xffff0000u : 0u);
  return bf2{(v.v & ~m) | (c.v & m)};
}

// The update of one unit through accessor `a` (`up`: its u_prev, wave).
template <int KIND, class A, class V>
__device__ __forceinline__ auto update(const A& a, const Coef& c,
                                       const V& up) {
  if constexpr (KIND == LIFE) {
    return life8(a);
  } else if constexpr (KIND == HEAT5) {
    return heat5(a, c.a);
  } else if constexpr (KIND == WAVE7) {
    return wave_update(a, up, c);
  } else if constexpr (KIND == ADVECT) {
    return advect_update(a, c);
  } else {
    return heat_update<KIND>(a, c);
  }
}

// Copy a segment of n cells at `src` as the aligned 16-byte words that
// cover it into the row buffer at `dst` (the lanes of a GROUP take the
// words); the tensor spans [lo, hi).  Returns the segment's first cell's
// place in the buffer (cells from `dst`).
template <class T, int GROUP>
__device__ __forceinline__ int copy_row(unsigned char* dst, const T* src,
                                        int n, uintptr_t lo, uintptr_t hi,
                                        int lane) {
  constexpr int ES = sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a1 = a + static_cast<uintptr_t>(n) * ES;
  const uintptr_t w0 = a & ~static_cast<uintptr_t>(15);
  const int nw = static_cast<int>((((a1 + 15) & ~static_cast<uintptr_t>(15))
                                   - w0) >> 4);
  if (w0 >= lo && w0 + 16 * static_cast<uintptr_t>(nw) <= hi) {
    for (int k = lane; k < nw; k += GROUP) {
      cp_async16(dst + 16 * k, reinterpret_cast<const void*>(w0 + 16 * k));
    }
  } else {
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
  return static_cast<int>(a - w0) / ES;
}

// Copy input plane `pz`'s tile (rows of output y0 - h .., cells of output
// x0 - h .. x0 + TX + h, clipped to the input) into ring slot `slot`: 3D,
// groups of RW warps take rows and their lanes a row's 16-byte words; 2D,
// the block takes the one row's words.  rs[row] is the row's cell of
// output x0 - h.  FRAME: the input is the raw grid (CO = 0).
template <int KIND, class T, int NT, int RW, bool FRAME>
__device__ __forceinline__ void issue_plane(
    const T* __restrict__ p, unsigned char* smem, int* rs, const Geom& g,
    int pz, int slot, int x0, int y0, uintptr_t lo, uintptr_t hi) {
  constexpr int H = halo_of<KIND>();
  constexpr int ES = sizeof(T);
  constexpr int GROUP = is_2d<KIND>() ? NT : 32 * RW;
  const int grp = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  constexpr int CO = FRAME ? 0 : H;
  const int xv = x0 + CO - H;        // the segment's first cell (virtual)
  const int xs = FRAME ? max(xv, 0) : xv;  // its first cell in the input
  const int n = min(xv + g.TX + 2 * H, g.PX) - xs;
  for (int r = grp; r < g.PR; r += NT / GROUP) {
    const int row = slot * g.PR + r;
    const int base = (row * g.RWB + ROW_PAD) / ES;
    const int py = is_2d<KIND>() ? 0 : y0 + CO - H + r;
    if ((FRAME && py < 0) || py >= g.PY) {  // outside: any in-bounds offset
      if (lane == 0) rs[row] = base;
      continue;
    }
    const int at = copy_row<T, GROUP>(
        smem + static_cast<long>(row) * g.RWB + ROW_PAD,
        p + (static_cast<long>(pz) * g.PY + py) * g.PX + xs, n, lo, hi,
        lane);
    if (lane == 0) rs[row] = base + at - (xs - xv);
  }
}

// The NU units of one row of a thread (3D): `row` its taps' rows, `op`
// its first unit's output cell, units at off < xlim inside the grid (two
// fields: `row2` and `op2` the second's).  WHOLE: every unit (a pair's
// both cells) is inside, so the units run as straight-line code the
// compiler can interleave; else each is guarded.
template <int KIND, class T, int NT, int NU, int RW, bool ZQ, bool FRAME,
          bool WHOLE>
__device__ __forceinline__ void update_row(
    T* __restrict__ op, T* __restrict__ op2, const T* s,
    const Row<T> (&row)[2 * halo_of<KIND>() + 1][2 * halo_of<KIND>() + 1],
    const Row<T> (&row2)[2 * halo_of<KIND>() + 1][2 * halo_of<KIND>() + 1],
    const Geom& g, const Coef& c, int xlim, int x0, bool xwall,
    const ZQueue<T, halo_of<KIND>(), NU>& zq, const UpRegs<T, NU>& ur) {
  constexpr int H = halo_of<KIND>();
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = 32 * RW;
  constexpr int FR = FRAME ? H : 0;
  const int x = x0 + (threadIdx.x % GROUP) * UW;  // the first unit's cell
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int off = u * GROUP * UW;
    if constexpr (fields_of<KIND>() == 2) {
      if (WHOLE || off < xlim) {
        Val<T> nu, nv;
        grayscott_update(Ring3<T, H>{s, row, off}, Ring3<T, H>{s, row2, off},
                         c, nu, nv);
        if (FRAME && xwall &&
            (x0 + off < FR || x0 + off + GROUP * UW > g.X - FR)) {
          nu = pin_x(nu, row[H][H].read(s, off, 0), x + off, FR, g.X);
          nv = pin_x(nv, row2[H][H].read(s, off, 0), x + off, FR, g.X);
        }
        store_unit(op + off, nu, WHOLE || off + 1 < xlim);
        store_unit(op2 + off, nv, WHOLE || off + 1 < xlim);
      }
    } else if (WHOLE || off < xlim) {
      Val<T> upv{};
      if constexpr (KIND == WAVE7) upv = ur.v[u];
      auto v = [&] {
        if constexpr (ZQ) {
          return update<KIND>(Ring3Q<T, H, NU>{s, row, off, zq, u}, c, upv);
        } else {
          return update<KIND>(Ring3<T, H>{s, row, off}, c, upv);
        }
      }();
      // the group's cells of unit u span x0 + off .. + GROUP UW: test cell
      // by cell only where that span reaches into the frame
      if (FRAME && xwall &&
          (x0 + off < FR || x0 + off + GROUP * UW > g.X - FR)) {
        const auto centre = [&] {
          if constexpr (ZQ) {
            return zq.v[u][H];
          } else {
            return row[H][H].read(s, off, 0);
          }
        }();
        v = pin_x(v, centre, x + off, FR, g.X);
      }
      store_unit(op + off, v, WHOLE || off + 1 < xlim);
    }
  }
}

// Update output plane `z` of the item, whose newest input plane (z + h's)
// sits in ring slot `sq` (plane z + dz in slot (sq - h + dz) mod S).  A
// thread updates NU units of each of its rows, GROUP units apart (3D: a
// group of RW warps a row; 2D: the block on the row); with ZQ, the group's
// one row and its z taps from the queue.  Frame cells (FRAME, an item
// whose tile or run touches a wall: `wall`) keep the centre; u_prev
// (wave) comes from the registers `ur`.  Two fields: the second's rows sit
// S PR rows further in the table, its output is `out2`.
template <int KIND, class T, int NT, int NU, int RW, bool ZQ, bool FRAME>
__device__ __forceinline__ void compute_plane(
    T* __restrict__ out, T* __restrict__ out2, const unsigned char* smem,
    const int* rs, const Geom& g, const Coef& c, int z, int sq, int x0,
    int y0, bool wall, const ZQueue<T, halo_of<KIND>(), NU>& zq,
    const UpRegs<T, NU>& ur) {
  constexpr int H = halo_of<KIND>();
  constexpr bool D2 = is_2d<KIND>();
  constexpr int NF = fields_of<KIND>();
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = D2 ? NT : 32 * RW;
  const int grp = threadIdx.x / GROUP, pos = threadIdx.x % GROUP;
  const int fo = g.S * g.PR;  // the second field's rows in the table
  const T* s = reinterpret_cast<const T*>(smem);
  const int first = H + pos * UW;    // the first unit's cell in a row
  const int xlim = g.X - x0 - pos * UW;  // units at off < xlim are in
  // every unit of the thread's row inside (its last pair whole)
  const bool whole = xlim >= (NU - 1) * GROUP * UW + UW;
  int sl[2 * H + 1];
#pragma unroll
  for (int dz = -H; dz <= H; ++dz) {  // S > 2h: one wrap at most
    const int sd = sq - H + dz;
    sl[dz + H] = (sd < 0 ? sd + g.S : sd) * g.PR;
  }
  // frame tests: only on an item at a wall (FRAME), each uniform
  constexpr int FR = FRAME ? H : 0;
  const bool zframe = FRAME && wall && (z < FR || z >= g.M - FR);
  const bool xwall = FRAME && wall && (x0 < FR || x0 + g.TX > g.X - FR);
  const int rows = D2 ? 1 : g.TY;
  for (int r = grp; r < rows; r += NT / GROUP) {
    const int y = D2 ? 0 : y0 + r;
    if (y >= g.Y) break;
    const long at = (static_cast<long>(z) * g.Y + y) * g.X + x0 + pos * UW;
    T* op = out + at;
    if constexpr (D2) {
      Row<T> row[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        row[dy + 1].init(rs[sl[dy + 1]] + first);
      }
      if (KIND != LIFE && whole) {  // Life: no gain, and it spills
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int off = u * GROUP * UW;
          store_unit(op + off, update<KIND>(Ring2<T>{s, row, off}, c, 0),
                     true);
        }
      } else {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int off = u * GROUP * UW;
          if (off < xlim) {
            store_unit(op + off, update<KIND>(Ring2<T>{s, row, off}, c, 0),
                       off + 1 < xlim);
          }
        }
      }
    } else {
      if (FRAME && wall && (zframe || y < FR || y >= g.Y - FR)) {
        // a frame row: every cell of each field keeps its value
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          Row<T> centre;
          centre.init(rs[f * fo + sl[H] + r + H] + first);
          T* fp = (f == 0 ? out : out2) + at;
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            const int off = u * GROUP * UW;
            if (off < xlim) {
              store_unit(fp + off, centre.read(s, off, 0), off + 1 < xlim);
            }
          }
        }
        continue;
      }
      Row<T> row[2 * H + 1][2 * H + 1], row2[2 * H + 1][2 * H + 1];
#pragma unroll
      for (int dz = -H; dz <= H; ++dz) {
#pragma unroll
        for (int dy = -H; dy <= H; ++dy) {
          row[dz + H][dy + H].init(rs[sl[dz + H] + r + H + dy] + first);
          if constexpr (NF == 2) {
            row2[dz + H][dy + H].init(rs[fo + sl[dz + H] + r + H + dy] +
                                      first);
          }
        }
      }
      T* op2 = NF == 2 ? out2 + at : nullptr;
      if (whole) {
        update_row<KIND, T, NT, NU, RW, ZQ, FRAME, true>(
            op, op2, s, row, row2, g, c, xlim, x0, xwall, zq, ur);
      } else {
        update_row<KIND, T, NT, NU, RW, ZQ, FRAME, false>(
            op, op2, s, row, row2, g, c, xlim, x0, xwall, zq, ur);
      }
    }
  }
}

// Read ring slot sq's cells of the thread's units in its group's row into
// the newest place of the z queue, the older ones moving down one.
template <int KIND, class T, int NT, int NU, int RW>
__device__ __forceinline__ void push_plane(
    ZQueue<T, halo_of<KIND>(), NU>& zq, const unsigned char* smem,
    const int* rs, const Geom& g, int sq) {
  constexpr int H = halo_of<KIND>();
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = 32 * RW;
  const int r = threadIdx.x / GROUP, pos = threadIdx.x % GROUP;
  Row<T> row;
  row.init(rs[sq * g.PR + r + H] + H + pos * UW);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int d = 0; d < 2 * H; ++d) zq.v[u][d] = zq.v[u][d + 1];
    zq.v[u][2 * H] = row.read(reinterpret_cast<const T*>(smem),
                              u * GROUP * UW, 0);
  }
}

// Load u_prev of output plane z for the thread's units in its group's row
// (a z-queue tile: one row a group).
template <class T, int NT, int NU, int RW>
__device__ __forceinline__ void load_uprev(UpRegs<T, NU>& ur,
                                           const T* __restrict__ up,
                                           const Geom& g, int z, int x0,
                                           int y0) {
  constexpr int UW = paired<T>() ? 2 : 1;
  constexpr int GROUP = 32 * RW;
  const int y = y0 + threadIdx.x / GROUP, pos = threadIdx.x % GROUP;
  if (y >= g.Y) return;
  const int xlim = g.X - x0 - pos * UW;
  const T* q = up + (static_cast<long>(z) * g.Y + y) * g.X + x0 +
               pos * UW;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int off = u * GROUP * UW;
    if (off < xlim) ur.v[u] = load_unit(q + off, off + 1 < xlim);
  }
}

// NT threads, MINB blocks an SM (the register cap: 65536 / (NT MINB)), NU
// units a thread in each of its rows, RW warps a row (3D); ZQ: the z queue
// (a tile of one row a group); FRAME: the raw grid's frame pinned (K1, K2,
// Gray-Scott).  `q`: the wave kind's u_prev, loaded into registers, or
// Gray-Scott's v, marched through its own ring beside u; `out2`:
// Gray-Scott's new v.
template <int KIND, class T, int NT, int MINB, int NU, int RW, bool ZQ,
          bool FRAME>
__global__ void __launch_bounds__(NT, MINB)
march_step(const T* __restrict__ p, const T* __restrict__ q,
           T* __restrict__ out, T* __restrict__ out2, Geom g, Coef c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = halo_of<KIND>();
  constexpr int NF = fields_of<KIND>();
  int* rs = reinterpret_cast<int*>(smem + static_cast<long>(NF) * g.S *
                                              g.PR * g.RWB);
  // the whole batch's bytes: a word of a row at a member's edge may read
  // the neighbouring member's cells (never used), none outside the tensor
  const uintptr_t span = static_cast<uintptr_t>(g.PM) * g.PY * g.PX *
                         sizeof(T) * g.N;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p);
  const uintptr_t hi = lo + span;
  const uintptr_t lo2 = reinterpret_cast<uintptr_t>(q);
  const uintptr_t hi2 = lo2 + span;
  // a member's items, then the next member's: the item's member b reads
  // and writes its own blocks (u_prev is output-shaped, Gray-Scott's v
  // input-shaped)
  const int per_member = g.tiles_x * g.tiles_y * g.runs;
  const int items = per_member * g.N;
  const long q_stride = KIND == WAVE7 ? g.out_stride : g.in_stride;
  const T* pb = p;
  const T* qb = q;
  ZQueue<T, H, NU> zq;
  UpRegs<T, NU> ur;
  constexpr int CO = FRAME ? 0 : H;  // input index of output index 0
  constexpr int FR = FRAME ? H : 0;
  // plane pz's tiles into slot `slot` (the second field's: slot S + slot),
  // every field's in one commit group
  const auto issue = [&](int pz, int slot, int x0, int y0) {
    issue_plane<KIND, T, NT, RW, FRAME>(pb, smem, rs, g, pz, slot, x0, y0,
                                        lo, hi);
    if constexpr (NF == 2) {
      issue_plane<KIND, T, NT, RW, FRAME>(qb, smem, rs, g, pz, g.S + slot,
                                          x0, y0, lo2, hi2);
    }
  };
  for (int bitem = blockIdx.x; bitem < items; bitem += gridDim.x) {
    const int b = bitem / per_member;
    const int item = bitem - b * per_member;
    pb = p + b * g.in_stride;
    qb = q == nullptr ? q : q + b * q_stride;
    T* const ob = out + b * g.out_stride;
    T* const ob2 = out2 == nullptr ? out2 : out2 + b * g.out_stride;
    const int x0 = (item % g.tiles_x) * g.TX;
    const int rest = item / g.tiles_x;
    const int y0 = (rest % g.tiles_y) * g.TY;
    const int z0 = (rest / g.tiles_y) * g.ZR;
    const int nz = min(g.ZR, g.M - z0);
    const bool wall = FRAME && (x0 < FR || x0 + g.TX > g.X - FR ||
                                y0 < FR || y0 + g.TY > g.Y - FR ||
                                z0 < FR || z0 + nz > g.M - FR);
    // the run's input planes plo .. plo + nin - 1 (on the raw grid those
    // past PM are not issued); iteration i computes output plane
    // plo + i - CO - h once it is one of the run's
    const int plo = FRAME ? max(z0 - H, 0) : z0;
    const int nin = z0 + nz + CO + H - plo;
#pragma unroll
    for (int i = 0; i < IN_FLIGHT; ++i) {
      if (i < nin && (!FRAME || plo + i < g.PM)) issue(plo + i, i, x0, y0);
      cp_async_commit();
    }
    // slots of plane i and of plane i + IN_FLIGHT (S > IN_FLIGHT), kept
    // by counting, not by division
    int sq = 0, si = IN_FLIGHT;
    for (int i = 0; i < nin; ++i) {
      const int pz = plo + i, z = pz - CO - H;
      if constexpr (KIND == WAVE7) {
        if (z >= z0) load_uprev<T, NT, NU, RW>(ur, qb, g, z, x0, y0);
      }
      cp_async_wait_landed();  // plane i (this thread's copies)
      __syncthreads();         // everyone's; and iteration i - 1 is done
      if (i + IN_FLIGHT < nin && (!FRAME || pz + IN_FLIGHT < g.PM)) {
        issue(pz + IN_FLIGHT, si, x0, y0);
      }
      cp_async_commit();
      if constexpr (ZQ) {
        if (!FRAME || pz < g.PM) {
          push_plane<KIND, T, NT, NU, RW>(zq, smem, rs, g, sq);
        }
      }
      if (z >= z0) {
        compute_plane<KIND, T, NT, NU, RW, ZQ, FRAME>(
            ob, ob2, smem, rs, g, c, z, sq, x0, y0, wall, zq, ur);
      }
      sq = sq + 1 == g.S ? 0 : sq + 1;
      si = si + 1 == g.S ? 0 : si + 1;
    }
    __syncthreads();  // the next item's copies reuse slots read above
  }
}

// The geometry of a launch on output (M, Y, X): a padded input (K4, K5,
// K7) or the raw grid (K1, K2, Gray-Scott, `raw`: its frame pinned), a
// tile, and the row buffers and ring march.py::march_geometry sized.
inline Geom make_geom(int M, int Y, int X, int h, bool raw, bool d2, int tx,
                      int ty, int zr, int rwb, int slots) {
  Geom g{};
  const int pad = raw ? 0 : 2 * h;
  g.M = M;
  g.Y = Y;
  g.X = X;
  g.PM = M + pad;
  g.PY = d2 ? 1 : Y + pad;
  g.PX = X + pad;
  g.TX = tx;
  g.TY = ty;
  g.ZR = zr;
  g.PR = d2 ? 1 : ty + 2 * h;
  g.RWB = rwb;
  g.S = slots;
  if (tx > 0 && ty > 0 && zr > 0) {
    g.tiles_x = (X + tx - 1) / tx;
    g.tiles_y = (Y + ty - 1) / ty;
    g.runs = (M + zr - 1) / zr;
  }
  g.N = 1;
  g.in_stride = static_cast<long>(g.PM) * g.PY * g.PX;
  g.out_stride = static_cast<long>(M) * Y * X;
  return g;
}

// Shared memory of a launch: each of `fields` rings of S slots of PR row
// buffers, and each row's 4-byte table entry (march.py::march_geometry).
inline size_t ring_bytes(const Geom& g, int fields) {
  return static_cast<size_t>(fields) * g.S * g.PR * (g.RWB + 4);
}

// Host side: refuse a geometry the kernel cannot run (a ring one slot
// short, a row buffer too small for a segment, a tile row that is not NU
// units of each thread of its group, a frame on a grid with no interior,
// u_prev in registers on a tile of more than one row a group, rings that
// together exceed one block's shared memory), then launch a grid of the
// blocks the card holds at once (no more than the items).
constexpr size_t SMEM_LIMIT = 227 * 1024;  // march.py's _build.SMEM_LIMIT

inline bool geometry_ok(const Geom& g, int h, int es, bool d2, int tx,
                        int groups, bool zq, bool frame, bool uprev,
                        int fields) {
  if (g.tiles_x < 1 || g.tiles_y < 1 || g.runs < 1 || g.N < 1) return false;
  if (frame && g.N != 1) return false;  // the raw kinds are unbatched
  if (static_cast<long>(g.tiles_x) * g.tiles_y * g.runs * g.N >= (1L << 31))
    return false;
  if (zq && g.TY != groups) return false;
  const int seg = (g.TX + 2 * h) * es;
  const int need = 2 * ROW_PAD + ((seg + 15 + 15) / 16) * 16;
  if (g.S < IN_FLIGHT + 2 * h + 1 || g.RWB < need || g.RWB % 16) return false;
  if (g.TX != tx || g.TY < 1 || g.ZR < 1) return false;
  if (d2 && (g.TY != 1 || g.PR != 1)) return false;
  if (!d2 && g.PR != g.TY + 2 * h) return false;
  if (frame && g.M <= 2 * h) return false;
  if (uprev && !zq) return false;
  if (ring_bytes(g, fields) > SMEM_LIMIT) return false;
  return true;
}

template <int KIND, class T, int NT, int MINB, int NU, int RW, bool ZQ,
          bool FRAME>
int launch(const T* p, const T* q, T* out, T* out2, const Geom& g,
           const Coef& c, cudaStream_t stream) {
  constexpr int H = halo_of<KIND>();
  constexpr int UNIT = (paired<T>() ? 2 : 1) * (is_2d<KIND>() ? NT : 32 * RW);
  constexpr int TX = NU * UNIT;
  // u_prev (wave) and the second field's input and output (Gray-Scott)
  const bool operands = (KIND != WAVE7 && fields_of<KIND>() == 1) ||
                        (q != nullptr && (fields_of<KIND>() == 1 || out2));
  if (!operands ||
      !geometry_ok(g, H, sizeof(T), is_2d<KIND>(), TX, NT / (32 * RW), ZQ,
                   FRAME, KIND == WAVE7, fields_of<KIND>())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = march_step<KIND, T, NT, MINB, NU, RW, ZQ, FRAME>;
  const size_t smem = ring_bytes(g, fields_of<KIND>());
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
  const long items =
      static_cast<long>(g.tiles_x) * g.tiles_y * g.runs * g.N;
  const int grid = static_cast<int>(std::min<long>(items, per_sm * sms));
  kern<<<grid, NT, smem, stream>>>(p, q, out, out2, g, c);
  return static_cast<int>(cudaGetLastError());
}

// The builds a tile names (march.py::BUILDS, in order): threads, blocks
// an SM and, for 3D, warps a tile row (2D: the block is on the row); each
// in two unrolls, NU = 4 or 8 units a thread a row (the tile's TX is NU
// units of each thread of a row's group).
#define MARCH_BUILDS(X) X(0, 256, 2, 1) X(1, 512, 2, 1) X(2, 256, 2, 2)

// The kinds that take the z queue: 3D, every tap off the plane in the
// cell's own column.
template <int KIND>
__host__ __device__ constexpr bool queues() {
  return KIND == HEAT7 || KIND == HEAT13 || KIND == WAVE7;
}

template <int KIND, class T, int NT, int MINB, int RW, bool ZQ, bool FRAME>
int launch_unroll(const T* p, const T* q, T* out, T* out2, const Geom& g,
                  const Coef& c, cudaStream_t s) {
  constexpr int UNIT = (paired<T>() ? 2 : 1) * (is_2d<KIND>() ? NT : 32 * RW);
  if (g.TX == 4 * UNIT) {
    return launch<KIND, T, NT, MINB, 4, RW, ZQ, FRAME>(p, q, out, out2, g, c,
                                                       s);
  }
  if (g.TX == 8 * UNIT) {
    return launch<KIND, T, NT, MINB, 8, RW, ZQ, FRAME>(p, q, out, out2, g, c,
                                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of build `build` (zq: the z queue; every wave tile takes
// it).  FRAME: the raw grid (K1, K2, Gray-Scott).  `q`: u_prev (wave) or
// v (Gray-Scott, whose new v goes to `out2`).
template <int KIND, class T, bool FRAME = false>
int launch_build(int build, bool zq, const T* p, const T* q, T* out,
                 const Geom& g, const Coef& c, cudaStream_t s,
                 T* out2 = nullptr) {
  switch (build) {
#define MARCH_CASE(ID, NT, MINB, RW)                                       \
  case ID: {                                                               \
    if constexpr (is_2d<KIND>() && RW != 1) {                              \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    } else if constexpr (queues<KIND>()) {                                 \
      if (zq) {                                                            \
        return launch_unroll<KIND, T, NT, MINB, RW, true, FRAME>(          \
            p, q, out, out2, g, c, s);                                     \
      }                                                                    \
      if constexpr (KIND == WAVE7) {                                       \
        return static_cast<int>(cudaErrorInvalidValue);                    \
      } else {                                                             \
        return launch_unroll<KIND, T, NT, MINB, RW, false, FRAME>(         \
            p, q, out, out2, g, c, s);                                     \
      }                                                                    \
    } else {                                                               \
      if (zq) return static_cast<int>(cudaErrorInvalidValue);              \
      return launch_unroll<KIND, T, NT, MINB, RW, false, FRAME>(           \
          p, q, out, out2, g, c, s);                                       \
    }                                                                      \
  }
    MARCH_BUILDS(MARCH_CASE)
#undef MARCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace march
