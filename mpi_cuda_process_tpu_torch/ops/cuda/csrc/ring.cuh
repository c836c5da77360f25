// The streaming k-step kernel, one template for K10 (streamfused.cu: the 3D
// kinds) and K8's guard-frame launches (fullgrid.cu: the 2D kinds).
//
// A block owns a (TY, TX) column of the core (2D: a TX-wide strip of one
// row) and marches it down the march axis (3D: z; 2D: rows) through the
// planes [zc0, zc1) of its chunk, a temporal wavefront of K levels (K = k
// steps; red-black SOR: 2k one-colour half-sweeps).  Level 0 holds loaded
// planes of the window, level s = 1..K-1 planes of its region, and level K
// writes the output plane:
//
//   level s's region  (TY + 2 e_s, TX + 2 e_s), e_s = (K - s) h  (2D: one
//                     row, TX + 2 e_s wide); level 0's is (TY + 2m,
//                     TX + 2 mu), m = K h, the x range widened outward to
//                     mu = m rounded up to 8 cells (16 bytes for either type)
//
// THE SKEWED SCHEDULE.  In iteration p, level s computes plane
//
//   z_s = p + 1 - s (h + 1)
//
// and level 0 holds every plane up to p (landed before the iteration's one
// barrier).  So every plane a level reads was written in an EARLIER
// iteration: level s reads level s-1's planes z_s - h .. z_s + h, and the
// newest of them, z_s + h = z_{s-1} - 1, was written in iteration p - 1.
// All K levels update in the same phase, between one __syncthreads() and
// the next: ONE barrier per plane, where a schedule that lets level s read
// what level s-1 writes in the same iteration needs K + 1.  The cost is the
// ring slots below and a pipeline that fills over K (h + 1) planes.
//
// RING SLOTS (streamfused.py::ring_slots computes them and passes them to
// every launch; tests/ring_schedule.py replays this schedule on the CPU
// with exactly those counts, an evicted or in-flight slot holding NaN and a
// read of a slot that does not hold its plane raising):
//
//   S1 = 2h + 2  for levels 1..K-1: in iteration p level s+1 reads planes
//                z_s - 2h - 1 .. z_s - 1 of level s while level s writes z_s.
//                Wave reads level s-2's u at plane z_s as its u_prev (the
//                loaded u_prev for s = 1), 2h + 2 planes behind what level
//                s-2 writes: one slot more (2h + 3) once K >= 3.
//   S0 = 2h + 1 + IN_FLIGHT  for level 0: level 1 reads planes p - 2h .. p
//                while planes p + 1 .. p + IN_FLIGHT are in flight (wave:
//                one more once K >= 2, for level 2's u_prev).
//
// LOADS.  Level 0 keeps IN_FLIGHT = 2 planes in flight: iteration p issues
// plane p + 2 and the next iteration waits for plane p + 1 only
// (cp.async.wait_group 1).  A block whose window rows lie in the operands
// as they are (window.cuh::row_ptr: y inside the source, x inside the grid)
// copies them in 16-byte cp.async units (VEC_LOAD); RAW clamps z per plane
// (a whole row pointer), so only the y/x walls decide.  Other blocks load a
// cell at a time through window.cuh::cell_ptr (4-byte cp.async for 4-byte
// types, a plain load and store for bfloat16).  Every thread takes a share
// of the copies.
//
// THREADS.  Warps own levels: the launch gives each level s = 1..K a run
// of warps in proportion to its work (the fewest units a thread, such that
// the warps suffice).  In 3D a unit is a STRIP: NR = strip_rows(kind)
// consecutive rows of one column of the level's region (the last strip of
// a column overlaps its neighbour, so every strip is whole; the overlap's
// cells are computed twice, alike), consecutive lanes on consecutive
// columns.  A thread keeps its first strip's column values of the previous
// planes in registers across iterations and loads only the newest plane:
// a 7-point update reads its z and y neighbours from registers (the rows
// the strip holds) and only x - 1, x + 1 and the newest plane from shared
// memory (and y - 1 / y + 1 at the strip's ends), 3 + 2/NR reads where a
// cell-by-cell walk reads 7.  In 2D a unit is a cell of the level's row;
// a thread's cells lie Tn apart, handled NR at a time, and its first NR
// keep their columns.  A thread's strips past its first load their
// columns each plane.  A strip's NR cells are all computed (no branch
// between them: a frame or other-colour cell selects its old value), then
// stored, so their loads and arithmetic interleave.  Only loaded VALUES
// are reused, never partial sums, so the rounding order is the plain one.
// Ring positions move by one plane an iteration (an add and a compare), no
// % per cell.  A block runs up to 1024 threads at 64 registers a thread,
// or up to 512 at 64 (two blocks an SM) or 128 (one): three builds,
// ring_step's LB and MINB, chosen by the tile.
//
// FRAME.  Pinned on GLOBAL coordinates, (oz, oy) + local, as in fused.cu.
// The march-axis frame is one test per level and iteration; a block whose
// updated cells are all off the y/x frame (FRAME_FREE) skips the per-cell
// y/x test; SOR's colour is the parity of the global coordinate sum.
//
// Every update is stencil_taps.cuh's / stencil2d.cuh's over an accessor,
// in the plain version's rounding order, so the kernel is bit-equal to k
// plain steps, in float32, bfloat16 (rings in bfloat16) and int32 (Life).

#pragma once

#include <type_traits>

#include "stencil2d.cuh"
#include "window.cuh"

namespace ring {

constexpr int MAX_THREADS = 1024;
constexpr int WARPS = MAX_THREADS / 32;
constexpr int IN_FLIGHT = 2;   // level-0 planes in flight
constexpr int X_ALIGN = 8;     // level 0's x margin is rounded up to this
// Bits of a launch's `paths` (streamfused.py / fullgrid.py PATHS).
constexpr int VEC_LOAD = 1;    // 16-byte row copies where rows allow
constexpr int FRAME_FREE = 2;  // no y/x frame test where no cell is frame

__host__ __device__ constexpr bool is2d(int kind) {
  return kind == HEAT5 || kind == WAVE5 || kind == LIFE ||
         kind == ADVECT2D || kind == GRAYSCOTT2D || kind == SOR5;
}
__host__ __device__ constexpr bool is_wave(int kind) {
  return kind == WAVE7 || kind == WAVE5;
}
__host__ __device__ constexpr bool is_gs(int kind) {
  return kind == GRAYSCOTT || kind == GRAYSCOTT2D;
}
__host__ __device__ constexpr bool is_sor(int kind) {
  return kind == SOR7 || kind == SOR5;
}
__host__ __device__ constexpr int levels_of(int kind, int k) {
  return k * (is_sor(kind) ? 2 : 1);
}

// A launch's plan: the tile, the ring slots, the fast paths allowed and
// the level each warp computes (0: it only loads).
struct Plan {
  int K, m, mu;      // levels, margin K*h, level 0's x margin
  int TY, TX, CZ;    // core column (2D: TY = 1) and march-axis chunk
  int S0, S1;        // ring slots of level 0 and of levels 1..K-1
  int paths;
  unsigned char level[WARPS];
};

// Geometry of the levels (host and device): region extents and origins
// relative to the block's core origin, ring offsets in cells of T.
struct Geom {
  int K, h, m, mu, TY, TX, S0, S1;
  bool d2, two, gs;
  __host__ __device__ int ry(int l) const {
    return d2 ? 1 : (l == 0 ? TY + 2 * m : TY + 2 * (K - l) * h);
  }
  __host__ __device__ int rx(int l) const {
    return l == 0 ? TX + 2 * mu : TX + 2 * (K - l) * h;
  }
  __host__ __device__ int oy(int l) const {
    return d2 ? 0 : (l == 0 ? -m : -(K - l) * h);
  }
  __host__ __device__ int ox(int l) const {
    return l == 0 ? -mu : -(K - l) * h;
  }
  __host__ __device__ long plane(int l) const {
    return static_cast<long>(ry(l)) * rx(l);
  }
  __host__ __device__ int slots(int l) const { return l == 0 ? S0 : S1; }
  // ring of level l (0..K-1), field f (f = 1: wave's loaded u_prev at
  // level 0 only; Gray-Scott's v at every level).  Layout: level 0 of
  // field 0, level 0 of field 1, levels 1..K-1 of field 0, then of field 1
  __host__ __device__ long mid() const {
    long b = 0;
    for (int t = 1; t < K; ++t) b += S1 * plane(t);
    return b;
  }
  __host__ __device__ long base(int l, int f) const {
    const long lvl0 = S0 * plane(0);
    if (l == 0) return f * lvl0;
    long b = (two ? 2 : 1) * lvl0 + (f ? mid() : 0);
    for (int t = 1; t < l; ++t) b += S1 * plane(t);
    return b;
  }
  __host__ __device__ long cells() const {
    return (two ? 2 : 1) * S0 * plane(0) + (gs ? 2 : 1) * mid();
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest IN_FLIGHT - 1 has landed
__device__ __forceinline__ void cp_async_wait_landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(IN_FLIGHT - 1) : "memory");
}

// One cell of a window plane into level 0's ring: 4-byte cp.async, or a
// plain load and store for 2-byte cells (cp.async copies 4, 8 or 16).
template <class T>
__device__ __forceinline__ void copy_cell(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src);
  } else {
    *dst = *src;
  }
}

template <class T>
using value_t = std::conditional_t<std::is_same<T, int>::value, int, float>;

template <class T>
__device__ __forceinline__ void store(T* p, value_t<T> v) {
  if constexpr (std::is_same<T, int>::value) {
    *p = v;
  } else {
    *p = narrow<T>(v);
  }
}

// Cells a thread keeps the columns of in registers: a strip of that many
// rows of one column (3D; every update of a strip reads its y neighbours
// from the strip's registers), or that many cells of its level's row, Tn
// apart (2D).
__host__ __device__ constexpr int strip_rows(int kind) {
  return (is2d(kind) ? 4 : 8) / (kind_halo(kind) * (is_gs(kind) ? 2 : 1));
}

// Neighbour access for cell j of a strip of level s: a value of the
// strip's own columns (dx = 0; dy = 0, or a row the strip holds) from the
// registers c (planes z - H .. z + H - 1) and nw (plane z + H), the rest
// from level s-1's planes in the ring (32-bit offsets into the block's
// shared memory).  j is a constant once the strip's loop is unrolled, so
// every register index is.
template <class T, int H, int NR, bool D2>
struct StripAcc {
  using value_type = T;
  using V = value_t<T>;
  const V (&c)[NR][2 * H];
  const V (&nw)[NR];
  const T* sm;
  const int (&pl)[2 * H + 1];  // planes z - H .. z + H of level s-1
  int o;                       // the cell's offset in a plane
  int sy;                      // a row of level s-1's plane
  int j;
  __device__ __forceinline__ V col(int jj, int dz) const {
    return dz < H ? c[jj][H + dz] : nw[jj];
  }
  __device__ __forceinline__ V operator()(int dz, int dy, int dx) const {
    if (dx == 0 && dy == 0) return col(j, dz);
    if (!D2 && dx == 0 && j + dy >= 0 && j + dy < NR) return col(j + dy, dz);
    return widen(sm[pl[H + dz] + o + dy * sy + dx]);
  }
};

// The 2D updates' a(dy, dx): the march axis is dy.
template <class A>
struct MarchAcc2 {
  using value_type = typename A::value_type;
  const A& a;
  __device__ __forceinline__ auto operator()(int dy, int dx) const {
    return a(dy, 0, dx);
  }
};

// The new value(s) of one cell of level s from its accessors: keep copies
// the previous level's (a frame cell, or a cell of the colour SOR's level
// s leaves), the centre `u0` (`u1`: Gray-Scott's v).  The update is
// computed either way and selected, so a strip's cells have no branches
// between them (as the plain version computes every cell and selects).
template <int KIND, class A, class V>
__device__ __forceinline__ void update(const A& a, const A& b, float uprev,
                                       bool keep, V u0, V u1, const Coef& c,
                                       V& v0, V& v1) {
  V n0, n1 = u1;
  if constexpr (KIND == GRAYSCOTT) {
    grayscott_update(a, b, c, n0, n1);
  } else if constexpr (KIND == GRAYSCOTT2D) {
    grayscott5(MarchAcc2<A>{a}, MarchAcc2<A>{b}, c, n0, n1);
  } else if constexpr (KIND == WAVE7) {
    n0 = wave_update(a, uprev, c);
  } else if constexpr (KIND == WAVE5) {
    n0 = wave5(MarchAcc2<A>{a}, uprev, c.a);
  } else if constexpr (KIND == HEAT5 || KIND == SOR5) {
    n0 = heat5(MarchAcc2<A>{a}, c.a);
  } else if constexpr (KIND == ADVECT2D) {
    n0 = advect5(MarchAcc2<A>{a}, c.a, c.c0);
  } else if constexpr (KIND == LIFE) {
    n0 = life8(MarchAcc2<A>{a});
  } else {
    n0 = field_update<KIND>(a, c);
  }
  v0 = keep ? u0 : n0;
  v1 = keep ? u1 : n1;
}

__device__ __forceinline__ int wrap_inc(int q, int S) {
  return q + 1 == S ? 0 : q + 1;
}
__device__ __forceinline__ int pos_mod(int a, int S) {
  const int r = a % S;
  return r < 0 ? r + S : r;
}

template <int KIND, int SRC, class T, bool FRAME>
__device__ __forceinline__ void run(const WindowT<T>& w, const Plan& a,
                                    const Coef& c, T* sm, bool vec) {
  constexpr int h = kind_halo(KIND);
  constexpr bool D2 = is2d(KIND), WV = is_wave(KIND), GS = is_gs(KIND),
                 SOR = is_sor(KIND);
  constexpr int NC = GS ? 2 : 1;  // fields a cell reads with neighbours
  constexpr int NR = strip_rows(KIND);
  using V = value_t<T>;
  using Acc = StripAcc<T, h, NR, D2>;
  const Geom g{a.K, h, a.m, a.mu, a.TY, a.TX, a.S0, a.S1, D2, WV || GS, GS};
  const int K = a.K, m = a.m, mu = a.mu;
  const int x0 = blockIdx.x * a.TX, y0 = D2 ? 0 : blockIdx.y * a.TY;
  // a batched launch folds the members into z: member b's chunks are
  // chunks b .. chunks (b + 1) - 1, and each primes its own rings
  const int chunks = (w.Z + a.CZ - 1) / a.CZ;
  const int b = blockIdx.z / chunks;
  const int zc0 = (blockIdx.z - b * chunks) * a.CZ,
            zc1 = min(zc0 + a.CZ, w.Z);
  const int zb = zc0 - m;  // the first loaded plane; slot(z) = (z - zb) % S

  // ---- this thread's level (0: none) and its units of work: 3D, strips
  // of NR rows of one column of the level's region (the last strip of a
  // column overlaps its neighbour, so every strip is whole); 2D, cells of
  // the level's row, Tn apart ----
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int s = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i)
    if (i == warp) s = a.level[i];
  int first = 0, nw_ = 0;
#pragma unroll
  for (int i = WARPS - 1; i >= 0; --i)
    if (i < nwarps && a.level[i] == s) {
      first = i;
      ++nw_;
    }
  const int tl = (warp - first) * 32 + (threadIdx.x & 31), Tn = nw_ * 32;
  // ---- level 0: copies of plane q into its ring slot, one commit group,
  // shared by every thread.  The walk over the plane's rows and units is
  // set up per call (two divisions), so no thread keeps load state across
  // the compute ----
  auto issue = [&](int q, int slot) {
    constexpr int U = 16 / sizeof(T);
    const int RY0 = D2 ? 1 : a.TY + 2 * m, RX0 = a.TX + 2 * mu;
    const int per_row = vec ? RX0 / U : a.TX + 2 * m;
    const int start = threadIdx.x, step = blockDim.x;
    if (q < zc1 + m && start < RY0 * per_row) {
      T* d0 = sm + slot * RY0 * RX0;
      T* d1 = d0 + (WV || GS ? a.S0 * RY0 * RX0 : 0);
      const int zq = SRC == RAW ? min(max(q, 0), w.Z - 1) : q;
      int row = start / per_row, col = start - row * per_row;
      const int drow = step / per_row, dcol = step - drow * per_row;
      for (int i = start; i < RY0 * per_row; i += step) {
        const int y = D2 ? 0 : y0 - m + row;
        if (vec) {
          const int x = x0 - mu + col * U, o = row * RX0 + col * U;
          cp_async16(d0 + o, row_ptr<SRC>(w, 0, zq, y, b) + x);
          if constexpr (WV || GS)
            cp_async16(d1 + o, row_ptr<SRC>(w, 1, zq, y, b) + x);
        } else {
          const int x = x0 - m + col, o = row * RX0 + col + (mu - m);
          copy_cell(d0 + o, cell_ptr<SRC>(w, 0, q, y, x, 0, b));
          if constexpr (WV || GS)
            copy_cell(d1 + o, cell_ptr<SRC>(w, 1, q, y, x, 0, b));
        }
        col += dcol;
        row += drow;
        if (col >= per_row) {
          col -= per_row;
          ++row;
        }
      }
    }
    cp_async_commit();
  };

  const int sl = s > 0 ? s : 1;  // level constants of an idle warp: unused
  const int e = (K - sl) * h;
  const int RXs = g.rx(sl), RYs = g.ry(sl), RXi = g.rx(sl - 1);
  const int units = D2 ? RXs : RXs * ((RYs + NR - 1) / NR);
  const int rounds = s > 0 && tl < units ? (units - 1 - tl) / Tn + 1 : 0;
  // a cell's offset in level s-1's plane, less its own (iy * RXi + ix)
  const int oin = (g.oy(sl) - g.oy(sl - 1)) * RXi + g.ox(sl) - g.ox(sl - 1);
  // rings as (first cell, plane, end): level s-1 (in; Gray-Scott's v at
  // + vin), level s (out; v at + vout), wave's u_prev (the loaded u_prev
  // for level 1, else level s-2's u)
  const int Pin = static_cast<int>(g.plane(sl - 1));
  const int bin = static_cast<int>(g.base(sl - 1, 0));
  const int ein = bin + g.slots(sl - 1) * Pin;
  const int vin = GS ? static_cast<int>(g.base(sl - 1, 1)) - bin : 0;
  const int Pout = static_cast<int>(g.plane(sl));
  const int bout = sl < K ? static_cast<int>(g.base(sl, 0)) : 0;
  const int eout = bout + g.S1 * Pout;
  const int vout = GS && sl < K ? static_cast<int>(g.base(sl, 1)) - bout : 0;
  const int lu = sl >= 2 ? sl - 2 : 0;
  const int Pup = static_cast<int>(g.plane(lu)), RXu = g.rx(lu);
  const int bup = static_cast<int>(g.base(lu, sl >= 2 ? 0 : 1));
  const int eup = bup + g.slots(lu) * Pup;
  const int oup = (g.oy(sl) - g.oy(lu)) * RXu + g.ox(sl) - g.ox(lu);
  // a strip's step from one cell to the next in each ring and in the grid
  const int si = D2 ? Tn : RXi, so = D2 ? Tn : RXs, su = D2 ? Tn : RXu;
  const int gyo = w.oy + y0 + g.oy(sl), gxo = x0 + g.ox(sl);
  const long gsz = static_cast<long>(w.Y) * w.X;
  // the columns of the first unit's cells on the previous planes
  V cache[NC][NR][2 * h];
  // ring positions at the first iteration (p = zb): plane z - h of level
  // s-1, plane z of level s and of the u_prev ring; each moves one plane
  // an iteration, wrapping at its ring's end
  const int z0 = zb + 1 - sl * (h + 1);
  int q_in = bin + pos_mod(z0 - h - zb, g.slots(sl - 1)) * Pin;
  int q_out = bout + pos_mod(z0 - zb, g.S1) * Pout;
  int q_up = bup + pos_mod(z0 - zb, g.slots(lu)) * Pup;
  int q_ld = IN_FLIGHT % a.S0;

#pragma unroll
  for (int d = 0; d < IN_FLIGHT; ++d) issue(zb + d, d);
  const int pend = zc1 - 1 + K * (h + 1);
  for (int p = zb; p < pend; ++p) {
    cp_async_wait_landed();
    __syncthreads();  // plane p is in; every read of iteration p-1 is done
    issue(p + IN_FLIGHT, q_ld);
    const int z = p + 1 - s * (h + 1);
    if (rounds > 0 && z >= zc0 - e && z < zc1 + e) {
      const bool reload = z == zc0 - e;  // the level's first plane
      const int gz = w.oz + z;
      const bool keep_z = gz < h || gz >= w.GZ - h;
      int pin[2 * h + 1];  // planes z - h .. z + h of level s-1
#pragma unroll
      for (int jz = 0; jz <= 2 * h; ++jz) {
        const int q = q_in + jz * Pin;
        pin[jz] = q < ein ? q : q - (ein - bin);
      }
      // frame and colour of the cell at (iy, ix) of the level's region
      auto keep_of = [&](int iy, int ix) {
        const int gy = gyo + iy, gx = gxo + ix;
        bool keep = keep_z;
        if constexpr (FRAME) {
          if constexpr (D2)
            keep = keep || gx < h || gx >= w.GX - h;
          else
            keep = keep || gy < h || gy >= w.GY - h || gx < h ||
                   gx >= w.GX - h;
        }
        if constexpr (SOR)
          keep = keep || other_colour(gz + (D2 ? 0 : gy) + gx, s);
        return keep;
      };
      // the new value(s) of the cell at (iy, ix) into level s's ring, or
      // (level K) into the output
      auto put = [&](int iy, int ix, V v0, V v1, V u) {
        if (s < K) {
          const int od = q_out + iy * RXs + ix;
          store(sm + od, v0);
          if constexpr (GS) store(sm + od + vout, v1);
        } else {
          const int y = y0 + iy, x = x0 + ix;
          if (y < w.Y && x < w.X) {
            const long go = z * gsz + static_cast<long>(y) * w.X + x;
            store(out_ptr(w, 0, b) + go, v0);
            // wave's new u_prev: level K-1's u; Gray-Scott's new v
            if constexpr (WV) store(out_ptr(w, 1, b) + go, u);
            if constexpr (GS) store(out_ptr(w, 1, b) + go, v1);
          }
        }
      };
      auto uprev_of = [&](int iy, int ix) {
        return WV ? widen(sm[q_up + iy * RXu + ix + oup]) : 0.0f;
      };
      // the first unit: cells j < n of the strip whose cell 0 is (iy, ix),
      // their columns of the previous planes in `cache` (reload: load
      // them first).  All NR cells are computed, then stored, so loads and
      // arithmetic of different cells interleave: a 2D thread's cells past
      // its row's end (j >= n) repeat its last cell and are not stored.
      auto strip = [&](int iy, int ix, int n, V (&cache)[NC][NR][2 * h],
                       bool reload) {
        const int o = iy * RXi + ix + oin;
        int oj[NR];  // cell j's offset in a plane of level s-1
#pragma unroll
        for (int j = 0; j < NR; ++j) oj[j] = o + (D2 ? min(j, n - 1) : j) * si;
        if (reload) {
#pragma unroll
          for (int f = 0; f < NC; ++f)
#pragma unroll
            for (int jz = 0; jz < 2 * h; ++jz)
#pragma unroll
              for (int j = 0; j < NR; ++j)
                cache[f][j][jz] = widen(sm[pin[jz] + oj[j] + f * vin]);
        }
        V nw[NC][NR];
#pragma unroll
        for (int f = 0; f < NC; ++f)
#pragma unroll
          for (int j = 0; j < NR; ++j)
            nw[f][j] = widen(sm[pin[2 * h] + oj[j] + f * vin]);
        V r0[NR], r1[NR];
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const Acc a0{cache[0], nw[0], sm, pin, oj[j], RXi, j};
          const Acc a1{cache[NC - 1], nw[NC - 1], sm, pin, oj[j] + vin, RXi,
                       j};
          const int dj = D2 ? min(j, n - 1) : j;
          const int iyj = D2 ? iy : iy + j, ixj = D2 ? ix + dj * Tn : ix;
          update<KIND>(a0, a1, uprev_of(iyj, ixj), keep_of(iyj, ixj),
                       cache[0][j][h], cache[NC - 1][j][h], c, r0[j], r1[j]);
        }
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (!D2 || j < n)
            put(D2 ? iy : iy + j, D2 ? ix + j * Tn : ix, r0[j], r1[j],
                cache[0][j][h]);
        // the next plane's columns
#pragma unroll
        for (int f = 0; f < NC; ++f)
#pragma unroll
          for (int j = 0; j < NR; ++j) {
#pragma unroll
            for (int jz = 0; jz + 1 < 2 * h; ++jz)
              cache[f][j][jz] = cache[f][j][jz + 1];
            cache[f][j][2 * h - 1] = nw[f][j];
          }
      };
      if constexpr (D2) {
        // the thread's cells tl, tl + Tn, ..: the first NR keep their
        // columns, the rest load them each plane, NR at a time
        strip(0, tl, min(rounds, NR), cache, reload);
        for (int jb = NR; jb < rounds; jb += NR) {
          V fresh[NC][NR][2 * h];
          strip(0, tl + jb * Tn, min(rounds - jb, NR), fresh, true);
        }
      } else {
        // strips tl, tl + Tn, ..: the first keeps its columns, the rest
        // load them each plane
        for (int r = 0; r < rounds; ++r) {
          const int u = tl + r * Tn, st = u / RXs, ix = u - st * RXs;
          const int iy = min(st * NR, RYs - NR);
          if (r == 0) {
            strip(iy, ix, NR, cache, reload);
          } else {
            V fresh[NC][NR][2 * h];
            strip(iy, ix, NR, fresh, true);
          }
        }
      }
    }
    q_in = q_in + Pin < ein ? q_in + Pin : bin;
    q_out = q_out + Pout < eout ? q_out + Pout : bout;
    q_up = q_up + Pup < eup ? q_up + Pup : bup;
    q_ld = wrap_inc(q_ld, a.S0);
  }
}

// LB: the block's most threads; MINB: the blocks an SM must hold (1024 x
// 1 and 512 x 2: 64 registers a thread, and with 512 threads two blocks
// share an SM, one computing while the other waits at its barrier; 512 x
// 1: 128 registers, one block).
template <int KIND, int SRC, class T, int LB, int MINB>
__global__ void __launch_bounds__(LB, MINB)
ring_step(const WindowT<T> w, const Plan a, const Coef c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr bool D2 = is2d(KIND);
  const int m = a.m, mu = a.mu;
  const int x0 = blockIdx.x * a.TX, y0 = D2 ? 0 : blockIdx.y * a.TY;
  // block-uniform: the window's rows lie in the operands as they are
  // (y inside the source's rows, x inside the grid) ...
  const int ylo = SRC == YZSLAB ? -w.m : 0;
  const int yhi = SRC == YZSLAB ? w.Y + w.m : w.Y;
  const bool rows =
      D2 || (y0 - m >= ylo && y0 + a.TY + m <= yhi);
  const bool vec = (a.paths & VEC_LOAD) && rows && x0 - mu >= 0 &&
                   x0 + a.TX + mu <= w.X;
  // ... and no updated cell lies on the y/x frame
  const int gy0 = w.oy + y0;
  const bool frame_free =
      (a.paths & FRAME_FREE) && x0 - m >= 0 && x0 + a.TX + m <= w.GX &&
      (D2 || (gy0 - m >= 0 && gy0 + a.TY + m <= w.GY));
  if (frame_free)
    run<KIND, SRC, T, false>(w, a, c, sm, vec);
  else
    run<KIND, SRC, T, true>(w, a, c, sm, vec);
}

// Host: the launch of ring_step<KIND, SRC, T> with tile (ty, tx, cz),
// `threads` and the build for `blocks` blocks an SM (1 or 2; a block of
// more than 512 threads takes 1), ring slots (s0, s1) and the fast paths
// `paths` allowed, over `members` members (an ensemble's: the grid's z
// holds every member's chunks, member after member, at most 65535).
// Returns a cudaError_t code.
template <int KIND, int SRC, class T>
int launch(const WindowT<T>& w, int k, const Coef& c, int ty, int tx, int cz,
           int threads, int blocks, int s0, int s1, int paths,
           cudaStream_t st, int members = 1) {
  constexpr int h = kind_halo(KIND);
  constexpr bool D2 = is2d(KIND);
  Plan a{};
  a.K = levels_of(KIND, k);
  a.m = a.K * h;
  a.mu = (a.m + X_ALIGN - 1) / X_ALIGN * X_ALIGN;
  a.TY = D2 ? 1 : ty;
  a.TX = tx;
  a.CZ = cz;
  a.S0 = s0;
  a.S1 = s1;
  const int W = threads / 32;
  if (threads % 32 || W < 1 || W > WARPS || a.K < 1 || a.K > W || ty < 1 ||
      tx < 1 || cz < 1 || tx >= (1 << 15) || s0 < 1 || s1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{a.K, h, a.m, a.mu, a.TY, a.TX, a.S0, a.S1, D2,
               is_wave(KIND) || is_gs(KIND), is_gs(KIND)};
  // warps to levels: the fewest units a thread, N, for which
  // ceil(units of level s / (32 N)) warps each fit the block; a unit is a
  // strip of NR rows of a column (3D; every region has at least NR rows)
  // or a cell of the row (2D)
  constexpr int NR = strip_rows(KIND);
  if (!D2 && ty < NR) return static_cast<int>(cudaErrorInvalidValue);
  long units[WARPS + 1], total = 0;
  for (int s = 1; s <= a.K; ++s) {
    units[s] = D2 ? g.rx(s) : g.rx(s) * ((g.ry(s) + NR - 1) / NR);
    total += units[s];
  }
  const int WL = W;
  long N = (total + 32L * WL - 1) / (32L * WL);
  for (;; ++N) {
    long need = 0;
    for (int s = 1; s <= a.K; ++s) need += (units[s] + 32 * N - 1) / (32 * N);
    if (need <= WL) break;
  }
  int wi = 0;
  for (int s = 1; s <= a.K; ++s) {
    const long n = (units[s] + 32 * N - 1) / (32 * N);
    for (long i = 0; i < n; ++i) a.level[wi++] = static_cast<unsigned char>(s);
  }
  // 16-byte row copies need 16-byte rows in the operands (X; the wrapper
  // clears VEC_LOAD where an operand's address is off) and in the window
  // (the tile's x origin TX * bx - mu and the row TX + 2 mu)
  if ((static_cast<long>(w.X) * sizeof(T)) % 16 ||
      (static_cast<long>(tx) * sizeof(T)) % 16)
    a.paths = paths & ~VEC_LOAD;
  else
    a.paths = paths;
  const size_t smem = sizeof(T) * static_cast<size_t>(g.cells());
  if (smem >= (1u << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // z: every member's chunks, member after member
  const long gz = static_cast<long>((w.Z + cz - 1) / cz) * members;
  if (members < 1 || gz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w.X + a.TX - 1) / a.TX, D2 ? 1 : (w.Y + a.TY - 1) / a.TY,
                  static_cast<unsigned>(gz));
  auto go = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, st>>>(w, a, c);
    return static_cast<int>(cudaGetLastError());
  };
  if (threads > MAX_THREADS / 2)
    return go(ring_step<KIND, SRC, T, MAX_THREADS, 1>);
  return blocks > 1 ? go(ring_step<KIND, SRC, T, MAX_THREADS / 2, 2>)
                    : go(ring_step<KIND, SRC, T, MAX_THREADS / 2, 1>);
}

}  // namespace ring
