// K3 fused_step<KIND, SRC>, K6 (the same template, SRC = ZSLAB) and K9
// (SRC = YZSLAB): k guard-frame (or periodic) steps per device-memory pass,
// by overlapped tiling in shared memory.
//
// Replaces: the TPU package's ops/pallas/fused.py — build_fused_call's
// _fused_kernel (padded 4-block windows, unsharded and sharded_global mode)
// and _fused_raw_kernel (pad-free 9-block windows), build_zslab_padfree_call's
// _fused_zslab_kernel (K6), build_yzslab_padfree_call's _fused_yzslab_kernel
// with _assemble_yz_window and _yzslab_specs (K9), their _run_micros /
// _window_frame, and the
// micro-steps _micro_heat, _micro_heat3d27, _micro_heat3d4th, _micro_wave,
// _micro_sor, _micro_advect and _micro_grayscott, every one for every window
// source.  On the TPU the
// kernels differ in how a VMEM window is assembled from aligned BlockSpecs;
// here one kernel computes its own
// window from local coordinates, and a window-source policy (window.cuh)
// says where each window cell is read from: RAW for --fuse on one device
// (auto, tiled and padfree), PADDED for --fuse under --mesh (the
// sharded_global mode), ZSLAB for --fuse --fuse-kind padfree under a z-only
// --mesh and YZSLAB under a --mesh that shards y (the exchanged slabs and,
// for YZSLAB, the two-pass composed corner pieces as separate operands, so
// no padded copy of the block exists).
//
// The frame is pinned on GLOBAL coordinates, (oz, oy) + local, against the
// global extent (GZ, GY, GX): a window cell past a global wall is frame
// (pinned every micro-step; its value only ever feeds other pinned cells),
// while a cell past an interior shard face holds real neighbour data and is
// updated like any other.  RAW passes origin 0 and the grid's own extent.
//
// Bound on an H100: device-memory bytes.  One pass reads each field once
// and writes it once for k steps, so the bytes per step fall k-fold against
// the one-step kernels (K1/K2, K4/K5).  What bounds it in practice is
// instructions: a block of (TZ, TY, TX) core cells loads a (TZ+2m, TY+2m,
// TX+2m) window (m = k*halo) and recomputes the shrinking margin in every
// micro-step (1.59x the useful cell updates at core (16, 16, 32), k = 4;
// 2.74x at k = 8, 5x at (8, 8, 32)), so the design spends as few
// instructions as it can on each loaded cell and each update:
//
//   * threads own (y, x) COLUMNS of the window and walk them down z, so no
//     cell is located by division (a thread's first column costs one
//     division a micro-step, the next ones an add and a compare) and a
//     column's own cells (the z neighbours and the centre) stay in
//     registers: a 7-point update reads 4 neighbours and the next plane's
//     cell from shared memory, not 7 cells;
//   * block-uniform fast paths.  A block whose window rows lie in the
//     operands as they are (no wall clamp, wrap or seam past the slabs:
//     window.cuh::rows_direct) and inside the grid's x extent loads them
//     with 16-byte cp.async copies, one row pointer (window.cuh::row_ptr,
//     up to 9 pieces for ZSLAB/YZSLAB, as the TPU's BlockSpecs assemble
//     the window) per 16 bytes, where the rows align to 16 bytes (X *
//     itemsize, the tile's TX and m; fused.py checks the operands'
//     addresses); where only the rows allow it (an x edge, unaligned
//     rows), a cell at a time from its row pointer.  A block whose updated
//     cells are all off the global frame (or periodic) runs the micro-steps
//     with no frame test.  Every other block keeps the per-cell path: each
//     window cell through cell_ptr (wrap or clamp), the frame test on each
//     update (its y/x part once a column);
//   * the face kinds (all but heat3d27 and heat3d4th) load the next
//     plane's in-plane neighbours before they update a cell, so the loads'
//     latency hides behind the update's dependent chain of rounded adds;
//   * the tile (TZ, TY, TX) and the block's threads come from fused.py's
//     table per (kind, dtype, k), chosen by timing on the card: a deeper
//     tile recomputes fewer cells, and 1024 threads hide the latency of
//     the one block its window leaves room for on an SM (two blocks of a
//     smaller tile, one loading while the other computes, lost to it).
//
// What still bounds it is instruction latency (scripts/torch_fused_tiles.py,
// PERF.md): more threads at one tile run faster with the same
// instructions, and walking pairs of columns with 8-byte accesses, which
// halves the shared-memory accesses, ran slower (64 registers a thread).
//
// Per block:
//   1. load the window of every field into dynamic shared memory from its
//      source;
//   2. apply k micro-steps in shared memory, micro-step s updating the
//      cells at least s*halo from the window edge, re-pinning the global
//      guard frame (ghost cells included), __syncthreads() between steps.
//      Red-black SOR runs 2k one-colour half-sweeps of halo 1 instead
//      (m = 2k): sweep j relaxes colour (j-1) % 2 of the GLOBAL coordinate
//      sum with heat's 7-point taps and leaves the other colour, frame
//      re-pinned after each, as _micro_sor does.  It relaxes in place in
//      one buffer: a half-sweep writes only cells of its colour and reads
//      only the cell itself and its face neighbours, all of the other
//      colour, which it leaves (so a column's registers, read before the
//      sweep writes, still hold every value the sweep reads) — and the
//      window may be twice as large.  Heat and advection ping-pong between
//      two buffers.  Wave writes the new u into u_prev's buffer in place
//      (each cell reads u_prev only at itself) and then swaps roles, so the
//      old u becomes the new u_prev for free.  Gray-Scott reads both
//      fields' neighbours, so neither can be overwritten in place: it
//      ping-pongs two pairs, four buffers;
//   3. write the (TZ, TY, TX) core (the cells at least m from the window
//      edge, all valid after k micro-steps), masked to the block.
//
// Storage type T: float32, or bfloat16 (the windows, the operands and the
// outputs).  The arithmetic is stencil_taps.cuh's, in the plain version's
// order, rounded to bfloat16 after every op as the plain version rounds it,
// so every level of a window is exact in T and is kept in T: the kernels
// stay bit-equal to the plain version on float32 and bfloat16 tensors, and
// the bfloat16 windows take half the shared memory.  The per-cell path
// reads cells with plain loads (window.cuh::cell_ptr), so a clamped 2-byte
// row needs no alignment.
//
// Shared memory is 2 buffers (Gray-Scott: 4; SOR: 1) x window x sizeof(T)
// (fused.py::smem_bytes), up to 221,184 B (Gray-Scott's four bfloat16
// buffers at m = 8), so the launch raises the kernel's dynamic
// shared-memory limit above the 48 KB default first (cudaFuncSetAttribute).


#include "window.cuh"

namespace {

constexpr int MAX_THREADS = 1024;  // a block's threads: fused.py's table

// Bits of a launch's `paths`: the fast paths it may take (fused.py sets
// all that apply; clearing them times the per-cell path alone).
constexpr int VEC_LOAD = 1;    // 16-byte row copies (the rows align)
constexpr int FRAME_FREE = 2;  // no frame test where no update is frame
constexpr int ROW_LOAD = 4;    // cells from row pointers where rows allow

// Window buffers a kind keeps in shared memory (fused.py::buffers).
__host__ __device__ constexpr int kind_buffers(int kind) {
  return kind == GRAYSCOTT ? 4 : (kind == SOR7 ? 1 : 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block's window: its extent, strides and local origin.
struct Geo {
  int m, WZ, WY, WX, sy, sz, oz, oy, ox;
};

// Neighbour access for a cell of a column: the column's own cells (dy = dx
// = 0) from the registers r[H + dz], the others from the window in shared
// memory.  The update reads the same values in the same order as from the
// window alone, so the result is the same.
template <class T, int H>
struct ColumnAcc {
  using value_type = T;
  const T* p;  // the cell in shared memory
  int sy, sz;
  float r[2 * H + 1];
  __device__ __forceinline__ float operator()(int dz, int dy, int dx) const {
    if (dy == 0 && dx == 0) return r[H + dz];
    return widen(p[dz * sz + dy * sy + dx]);
  }
};

// A thread's walk over the cells (or columns) of an (n, RX) row-major
// range, blockDim.x apart: one division to start, then an add and a
// compare per step.
struct Walk2 {
  int row, col, drow, dcol, RX;
  __device__ __forceinline__ Walk2(int RX_) : RX(RX_) {
    row = threadIdx.x / RX;
    col = threadIdx.x - row * RX;
    drow = blockDim.x / RX;
    dcol = blockDim.x - drow * RX;
  }
  __device__ __forceinline__ void next() {
    col += dcol;
    row += drow;
    if (col >= RX) {
      col -= RX;
      ++row;
    }
  }
};

// Load every field's window, by the block's load path:
//   LOAD_VEC   rows that rows_direct admits, x inside the grid, 16-byte
//              aligned: cp.async copies of 16 bytes, a row pointer per copy;
//   LOAD_ROWS  rows that rows_direct admits: a cell at a time from its row
//              pointer, x wrapped or clamped only past the grid's x edge;
//   LOAD_CELLS any other window: each cell through cell_ptr.
// The walk locates a cell (or a 16-byte unit) without division.
enum LoadPath { LOAD_VEC, LOAD_ROWS, LOAD_CELLS };

template <int SRC, int NF, class T>
__device__ __forceinline__ void load_window(const WindowT<T>& w, T* buf0,
                                            T* buf1, const Geo& g,
                                            LoadPath path, int periodic,
                                            int b) {
  if (path == LOAD_VEC) {
    constexpr int PER = 16 / sizeof(T);
    const int U = g.WX / PER, n = g.WZ * g.WY * U;
    Walk2 t(U);  // (row of the window, unit of the row)
    int wz = t.row / g.WY, wy = t.row - wz * g.WY;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int so = (wz * g.WY + wy) * g.WX + t.col * PER;
      const int x = g.ox + t.col * PER;
      cp_async16(buf0 + so,
                 row_ptr<SRC>(w, 0, g.oz + wz, g.oy + wy, b) + x);
      if constexpr (NF == 2)
        cp_async16(buf1 + so,
                   row_ptr<SRC>(w, 1, g.oz + wz, g.oy + wy, b) + x);
      const int before = t.row;
      t.next();
      wy += t.row - before;
      while (wy >= g.WY) {
        wy -= g.WY;
        ++wz;
      }
    }
    cp_async_wait_all();
    return;
  }
  const int n = g.WZ * g.WY * g.WX;
  Walk2 t(g.WX);  // (row of the window, x)
  int wz = t.row / g.WY, wy = t.row - wz * g.WY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int z = g.oz + wz, y = g.oy + wy, x = g.ox + t.col;
    if (path == LOAD_ROWS) {
      const int xs = x < 0 || x >= w.X ? wrap_or_clamp(x, w.X, periodic) : x;
      buf0[i] = row_ptr<SRC>(w, 0, z, y, b)[xs];
      if constexpr (NF == 2) buf1[i] = row_ptr<SRC>(w, 1, z, y, b)[xs];
    } else {
      buf0[i] = *cell_ptr<SRC>(w, 0, z, y, x, periodic, b);
      if constexpr (NF == 2)
        buf1[i] = *cell_ptr<SRC>(w, 1, z, y, x, periodic, b);
    }
    const int before = t.row;
    t.next();
    wy += t.row - before;
    while (wy >= g.WY) {
      wy -= g.WY;
      ++wz;
    }
  }
}

// Whether a kind's update reads only the cell and its six face neighbours
// (heat3d27 and heat3d4th read more): its columns prefetch the next plane.
__host__ __device__ constexpr bool face_kind(int kind) {
  return kind != HEAT27 && kind != HEAT13;
}

// Neighbour access for a face kind: the cell, its z neighbours and its
// four in-plane neighbours, all in registers.
template <class T>
struct FaceAcc {
  using value_type = T;
  float zm, c, zp, ym, yp, xm, xp;
  __device__ __forceinline__ float operator()(int dz, int dy, int dx) const {
    return dz < 0 ? zm
                  : dz > 0 ? zp
                           : dy < 0 ? ym
                                    : dy > 0 ? yp
                                             : dx < 0 ? xm : dx > 0 ? xp : c;
  }
};

// One field's values along a column of a face kind: the plane below, the
// cell, the plane above, and the cell's in-plane neighbours.
struct Face {
  float zm, c, zp, ym, yp, xm, xp;
};

// The in-plane neighbours of the cell at p and the cell `up` elements
// above it (sz; on the window's last plane 0, a value no update reads).
template <class T>
__device__ __forceinline__ void load_plane(const T* p, int sy, int up,
                                           Face& f) {
  f.ym = widen(p[-sy]);
  f.yp = widen(p[sy]);
  f.xm = widen(p[-1]);
  f.xp = widen(p[1]);
  f.zp = widen(p[up]);
}

// One column of micro-step s for a face kind, z = lo .. zend - 1: each
// iteration first loads the next plane's neighbours (they are not written
// in this step, or feed only cells it leaves: SOR), then updates the cell
// from registers and stores it, so the loads' latency hides behind the
// arithmetic; the loads are unconditional (no branch splits the unrolled
// loop).  The same values, taps and order as the plain update.
template <int KIND, bool FRAME, class T>
__device__ __forceinline__ void face_column(T* cur, T* nxt, T* vcur, T* vnxt,
                                            int q0, int lo, int zend,
                                            int sy, int sz, bool frame_yx,
                                            int gz0, int gyx, int s,
                                            const WindowT<T>& w,
                                            const Coef& c) {
  constexpr int h = kind_halo(KIND);
  constexpr bool wave = KIND == WAVE7, gs = KIND == GRAYSCOTT,
                 sor = KIND == SOR7;
  int q = lo * sz + q0;
  Face u, v, un, vn;
  u.zm = widen(cur[q - sz]);
  u.c = widen(cur[q]);
  load_plane(cur + q, sy, sz, u);
  if constexpr (gs) {
    v.zm = widen(vcur[q - sz]);
    v.c = widen(vcur[q]);
    load_plane(vcur + q, sy, sz, v);
  }
  float up = 0.0f, upn = 0.0f;  // wave: u_prev at the cell, and above it
  if constexpr (wave) up = widen(nxt[q]);
  for (int z = lo; z < zend; ++z, q += sz) {
    // the next plane (plane zend on the last pass: inside the window, and
    // never read), and the one above it, clamped to the window
    const int above = z + 2 < zend + lo ? sz : 0;
    load_plane(cur + q + sz, sy, above, un);
    if constexpr (gs) load_plane(vcur + q + sz, sy, above, vn);
    if constexpr (wave) upn = widen(nxt[q + sz]);
    const int gz = gz0 + z;
    bool keep = false;
    if constexpr (FRAME) keep = frame_yx || gz < h || gz >= w.GZ - h;
    if constexpr (sor) keep = keep || other_colour(gz + gyx, s);
    const FaceAcc<T> a{u.zm, u.c, u.zp, u.ym, u.yp, u.xm, u.xp};
    if constexpr (wave) {
      nxt[q] = keep ? cur[q] : narrow<T>(wave_update(a, up, c));
      up = upn;
    } else if constexpr (gs) {
      if (keep) {
        nxt[q] = cur[q];
        vnxt[q] = vcur[q];
      } else {
        const FaceAcc<T> av{v.zm, v.c, v.zp, v.ym, v.yp, v.xm, v.xp};
        float nu, nv;
        grayscott_update(a, av, c, nu, nv);
        nxt[q] = narrow<T>(nu);
        vnxt[q] = narrow<T>(nv);
      }
      vn.zm = v.c;
      vn.c = v.zp;
      v = vn;
    } else if constexpr (sor) {
      if (!keep) cur[q] = narrow<T>(field_update<KIND>(a, c));
    } else {
      nxt[q] = keep ? cur[q] : narrow<T>(field_update<KIND>(a, c));
    }
    un.zm = u.c;
    un.c = u.zp;
    u = un;
  }
}

// One column of micro-step s for heat3d27 and heat3d4th: the column's own
// cells in registers (r[h + dz]), the rest read from shared memory.
template <int KIND, bool FRAME, class T>
__device__ __forceinline__ void tap_column(const T* cur, T* nxt, int q0,
                                           int lo, int zend, int sy, int sz,
                                           bool frame_yx, int gz0,
                                           const WindowT<T>& w,
                                           const Coef& c) {
  constexpr int h = kind_halo(KIND);
  float r[2 * h + 1];
#pragma unroll
  for (int j = 0; j < 2 * h; ++j) r[j] = widen(cur[(lo - h + j) * sz + q0]);
  for (int z = lo; z < zend; ++z) {
    const int q = z * sz + q0;
    r[2 * h] = widen(cur[q + h * sz]);
    const int gz = gz0 + z;
    bool keep = false;
    if constexpr (FRAME) keep = frame_yx || gz < h || gz >= w.GZ - h;
    ColumnAcc<T, h> a{cur + q, sy, sz, {}};
#pragma unroll
    for (int j = 0; j <= 2 * h; ++j) a.r[j] = r[j];
    nxt[q] = keep ? cur[q] : narrow<T>(field_update<KIND>(a, c));
#pragma unroll
    for (int j = 0; j < 2 * h; ++j) r[j] = r[j + 1];
  }
}

// Micro-steps 1 .. k * phases, every thread walking its columns down z.
// FRAME: test each update against the global frame (the blocks whose
// window reaches a wall); without it no cell is frame.
template <int KIND, bool FRAME, class T>
__device__ __forceinline__ void micro_steps(T*& cur, T*& nxt, T*& vcur,
                                            T*& vnxt, const Geo& g,
                                            const WindowT<T>& w, int k,
                                            const Coef& c) {
  constexpr int h = kind_halo(KIND);
  constexpr bool gs = KIND == GRAYSCOTT;
  const int gz0 = w.oz + g.oz, gy0 = w.oy + g.oy;  // global window origin
  for (int s = 1; s <= k * kind_phases(KIND); ++s) {
    const int lo = s * h;
    const int RY = g.WY - 2 * lo, RX = g.WX - 2 * lo;
    const int n = RY * RX, zend = g.WZ - lo;
    Walk2 t(RX);  // (row, x) of the step's region of columns
    for (int i = threadIdx.x; i < n; i += blockDim.x, t.next()) {
      const int wy = t.row + lo, wx = t.col + lo;
      const int q0 = wy * g.sy + wx;
      const int gy = gy0 + wy, gx = g.ox + wx;
      bool frame_yx = false;
      if constexpr (FRAME)
        frame_yx = gy < h || gy >= w.GY - h || gx < h || gx >= w.GX - h;
      if constexpr (face_kind(KIND))
        face_column<KIND, FRAME>(cur, nxt, vcur, vnxt, q0, lo, zend, g.sy,
                                 g.sz, frame_yx, gz0, gy + gx, s, w, c);
      else
        tap_column<KIND, FRAME>(cur, nxt, q0, lo, zend, g.sy, g.sz,
                                frame_yx, gz0, w, c);
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if constexpr (gs) {
      tmp = vcur;
      vcur = vnxt;
      vnxt = tmp;
    }
  }
}

// One block: one (TZ, TY, TX) core tile of one member (a batched launch
// folds its members into the grid's z, the member's operands a member
// stride apart: window.cuh's s_in .. s_out).
template <int KIND, int SRC, class T>
__global__ void __launch_bounds__(MAX_THREADS)
fused_step(const WindowT<T> w, int k, int periodic, int paths, Coef c,
           int TZ, int TY, int TX) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  constexpr bool wave = KIND == WAVE7, gs = KIND == GRAYSCOTT,
                 sor = KIND == SOR7;
  Geo g;
  g.m = kind_margin(KIND, k);
  g.WZ = TZ + 2 * g.m;
  g.WY = TY + 2 * g.m;
  g.WX = TX + 2 * g.m;
  g.sy = g.WX;
  g.sz = g.WX * g.WY;
  const int W = g.sz * g.WZ;
  // the member b (a batched launch folds the members into z: member b's
  // z tiles are tiles_z b .. tiles_z (b + 1) - 1) and the local coordinate
  // of window cell (0, 0, 0)
  const int tiles_z = (w.Z + TZ - 1) / TZ;
  const int b = blockIdx.z / tiles_z;
  g.oz = (blockIdx.z - b * tiles_z) * TZ - g.m;
  g.oy = blockIdx.y * TY - g.m;
  g.ox = blockIdx.x * TX - g.m;

  T* cur = smem;  // heat, advection, Gray-Scott u: current level;
                  // wave: u; SOR: the one buffer it relaxes in place
  T* nxt = sor ? smem : smem + W;  // heat, advection, Gray-Scott u: next
                                   // level; wave: u_prev
  T* vcur = smem + 2 * W;  // Gray-Scott v: current level
  T* vnxt = smem + 3 * W;  // Gray-Scott v: next level

  // block-uniform: the load path (every window row in the operands as it
  // is, x inside the grid and 16-byte rows; the rows alone; neither)
  const bool rows = rows_direct<SRC>(w, g.oz, g.oz + g.WZ, g.oy,
                                     g.oy + g.WY);
  const bool x_in = g.ox >= 0 && g.ox + g.WX <= w.X;
  const LoadPath path = rows && x_in && (paths & VEC_LOAD) ? LOAD_VEC
                        : rows && (paths & ROW_LOAD)     ? LOAD_ROWS
                                                         : LOAD_CELLS;
  load_window<SRC, (wave || gs) ? 2 : 1>(w, cur, wave ? nxt : vcur, g, path,
                                         periodic, b);
  __syncthreads();

  // block-uniform: no cell a micro-step updates is frame (each lies at
  // least halo inside the window)
  const int gz0 = w.oz + g.oz, gy0 = w.oy + g.oy;
  const bool frame_free =
      (paths & FRAME_FREE) &&
      (periodic || (gz0 >= 0 && gz0 + g.WZ <= w.GZ && gy0 >= 0 &&
                    gy0 + g.WY <= w.GY && g.ox >= 0 && g.ox + g.WX <= w.GX));
  if (periodic || frame_free)
    micro_steps<KIND, false>(cur, nxt, vcur, vnxt, g, w, k, c);
  else
    micro_steps<KIND, true>(cur, nxt, vcur, vnxt, g, w, k, c);

  // the core, a thread per (y, x) column walking z, masked to the grid
  const long gsz = static_cast<long>(w.X) * w.Y;
  const int z0 = g.oz + g.m, nz = min(TZ, w.Z - z0);
  T* const out0 = out_ptr(w, 0, b);
  T* const out1 = wave || gs ? out_ptr(w, 1, b) : nullptr;
  Walk2 t(TX);
  for (int i = threadIdx.x; i < TY * TX; i += blockDim.x, t.next()) {
    const int gy = g.oy + g.m + t.row, gx = g.ox + g.m + t.col;
    if (gy >= w.Y || gx >= w.X) continue;
    long o = (static_cast<long>(z0) * w.Y + gy) * w.X + gx;
    int q = g.m * g.sz + (t.row + g.m) * g.sy + (t.col + g.m);
    for (int cz = 0; cz < nz; ++cz, o += gsz, q += g.sz) {
      out0[o] = cur[q];
      if constexpr (wave) out1[o] = nxt[q];  // the new u_prev: old u
      if constexpr (gs) out1[o] = vcur[q];
    }
  }
}

template <int KIND, int SRC, class T>
int launch(const WindowT<T>& w, int k, int periodic, int allowed,
           const Coef& c, int tz, int ty, int tx, int threads, int members,
           cudaStream_t s) {
  const int m = kind_margin(KIND, k);
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kind_buffers(KIND) * sizeof(T) *
                      static_cast<size_t>(tz + 2 * m) * (ty + 2 * m) *
                      (tx + 2 * m);
  cudaError_t e = cudaFuncSetAttribute(
      fused_step<KIND, SRC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte row copies need 16-byte row starts in the operands (X, and
  // the operands' addresses: the wrapper clears bit 0 of `allowed` where
  // one is off) and in the window (the tile's x origin TX * bx - m, and
  // the row length TX + 2m)
  const bool rows16 = (static_cast<long>(w.X) * sizeof(T)) % 16 == 0 &&
                      (tx * sizeof(T)) % 16 == 0 && (m * sizeof(T)) % 16 == 0;
  const int paths = rows16 ? allowed : (allowed & ~VEC_LOAD);
  // z: every member's z tiles, member after member
  const long gz = static_cast<long>((w.Z + tz - 1) / tz) * members;
  if (members < 1 || gz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w.X + tx - 1) / tx, (w.Y + ty - 1) / ty,
                  static_cast<unsigned>(gz));
  fused_step<KIND, SRC, T><<<grid, threads, smem, s>>>(w, k, periodic, paths,
                                                       c, tz, ty, tx);
  return static_cast<int>(cudaGetLastError());
}

// The tile and the launch's options, as the exports take them: the core
// (tz, ty, tx), the block's threads and the fast paths allowed (bit 0:
// 16-byte row copies, where the operands' addresses align; bit 1: no frame
// test where no update is frame; bit 2: cells from row pointers), and the
// members of a batched launch (1: unbatched).
struct Tile {
  int tz, ty, tx, threads, paths, members;
};

template <int SRC, class T>
int dispatch(int kind, const WindowT<T>& w, int k, int periodic,
             const Coef& c, const Tile& t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_LAUNCH(K)                                                    \
  launch<K, SRC>(w, k, periodic, t.paths, c, t.tz, t.ty, t.tx, t.threads, \
                 t.members, s)
  switch (kind) {
    case HEAT7:
      return FUSED_LAUNCH(HEAT7);
    case HEAT27:
      return FUSED_LAUNCH(HEAT27);
    case HEAT13:
      return FUSED_LAUNCH(HEAT13);
    case WAVE7:
      return FUSED_LAUNCH(WAVE7);
    case SOR7:
      return FUSED_LAUNCH(SOR7);
    case ADVECT:
      return FUSED_LAUNCH(ADVECT);
    case GRAYSCOTT:
      return FUSED_LAUNCH(GRAYSCOTT);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_LAUNCH
}

// The four launches below, on storage type T.
template <class T>
int fused_raw(int kind, const T* in0, const T* in1, T* out0, T* out1, int Z,
              int Y, int X, int k, int periodic, const Coef& c, const Tile& t,
              void* stream) {
  WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
               {out0, out1}, Z, Y, X, Z, Y, X, 0, 0, 0};
  set_member_strides<RAW>(w, t.members);
  return dispatch<RAW>(kind, w, k, periodic, c, t, stream);
}

template <class T>
int fused_padded(int kind, const T* in0, const T* in1, T* out0, T* out1,
                 int Z, int Y, int X, int GZ, int GY, int GX, int oz, int oy,
                 int k, int periodic, const Coef& c, const Tile& t,
                 void* stream) {
  WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
               {out0, out1}, Z, Y, X, GZ, GY, GX, oz, oy,
               kind_margin(kind, k)};
  set_member_strides<PADDED>(w, t.members);
  return dispatch<PADDED>(kind, w, k, periodic, c, t, stream);
}

template <class T>
int fused_z(int kind, const T* in0, const T* in1, const T* lo0,
            const T* lo1, const T* hi0, const T* hi1, T* out0, T* out1,
            int Z, int Y, int X, int GZ, int oz, int k, int periodic,
            const Coef& c, const Tile& t, void* stream) {
  WindowT<T> w{{in0, in1}, {lo0, lo1}, {hi0, hi1}, {out0, out1},
               Z, Y, X, GZ, Y, X, oz, 0, kind_margin(kind, k)};
  set_member_strides<ZSLAB>(w, t.members);
  return dispatch<ZSLAB>(kind, w, k, periodic, c, t, stream);
}

template <class T>
int fused_yz(int kind, const T* const* p, T* out0, T* out1, int Z, int Y,
             int X, int GZ, int GY, int GX, int oz, int oy, int k,
             int periodic, const Coef& c, const Tile& t, void* stream) {
  // p: per field, (in, zlo, zhi, ylo, yhi, ll, lh, hl, hh) in field-major
  // pairs, as the exports take them
  WindowT<T> w{{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}, {out0, out1},
               Z, Y, X, GZ, GY, GX, oz, oy, kind_margin(kind, k),
               {p[6], p[7]}, {p[8], p[9]},
               {{p[10], p[11]}, {p[12], p[13]}, {p[14], p[15]},
                {p[16], p[17]}}};
  set_member_strides<YZSLAB>(w, t.members);
  return dispatch<YZSLAB>(kind, w, k, periodic, c, t, stream);
}

}  // namespace

// One K3 launch on `stream`, one device: (out0[, out1]) = k steps of
// (in0[, in1]) on the whole (Z, Y, X) grid.  in1/out1 are used by the
// two-field kinds only (wave: u_prev; Gray-Scott: v).  Returns a cudaError_t
// code.  Each export has a _bf16 twin on bfloat16 operands.  Every export
// ends with the launch's tile: the core (tz, ty, tx), the block's threads
// and `paths`, the fast paths it may take (bit 0: 16-byte row copies, set
// only where every operand's address is 16-byte aligned; bit 1: no frame
// test where no update is frame; bit 2: cells from row pointers where the
// window's rows need no wrap or clamp).
EXPORT int fused_step_f32(int kind, const float* in0, const float* in1,
                          float* out0, float* out1, int Z, int Y, int X, int k,
                          int periodic, float a, float c0, float c1, float c2,
                          float c3, int tz, int ty, int tx,
                          int threads, int paths, int members,
                          void* stream) {
  return fused_raw(kind, in0, in1, out0, out1, Z, Y, X, k, periodic,
                   Coef{a, c0, c1, c2, c3},
                   Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

EXPORT int fused_step_bf16(int kind, const __nv_bfloat16* in0,
                           const __nv_bfloat16* in1, __nv_bfloat16* out0,
                           __nv_bfloat16* out1, int Z, int Y, int X, int k,
                           int periodic, float a, float c0, float c1,
                           float c2, float c3, int tz, int ty, int tx,
                           int threads, int paths, int members,
                          void* stream) {
  return fused_raw(kind, in0, in1, out0, out1, Z, Y, X, k, periodic,
                   Coef{a, c0, c1, c2, c3},
                   Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

// One K3 launch in its sharded mode: the inputs are a shard's z/y-padded
// (Z+2m, Y+2m, X) blocks (m = kind_margin(kind, k)), the outputs its
// (Z, Y, X) core k steps on; the core's global origin is (oz, oy, 0) in a
// (GZ, GY, GX) grid.
EXPORT int fused_step_padded_f32(int kind, const float* in0, const float* in1,
                                 float* out0, float* out1, int Z, int Y, int X,
                                 int GZ, int GY, int GX, int oz, int oy, int k,
                                 int periodic, float a, float c0, float c1,
                                 float c2, float c3, int tz, int ty, int tx,
                                 int threads, int paths, int members,
                          void* stream) {
  return fused_padded(kind, in0, in1, out0, out1, Z, Y, X, GZ, GY, GX, oz,
                      oy, k, periodic, Coef{a, c0, c1, c2, c3},
                      Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

EXPORT int fused_step_padded_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    __nv_bfloat16* out0, __nv_bfloat16* out1, int Z, int Y, int X, int GZ,
    int GY, int GX, int oz, int oy, int k, int periodic, float a, float c0,
    float c1, float c2, float c3, int tz, int ty, int tx,
    int threads, int paths, int members, void* stream) {
  return fused_padded(kind, in0, in1, out0, out1, Z, Y, X, GZ, GY, GX, oz,
                      oy, k, periodic, Coef{a, c0, c1, c2, c3},
                      Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

// One K6 launch: a z-only shard's (Z, Y, X) core plus the (m, Y, X) slabs
// below (lo) and above (hi) it, k steps on; the core's global origin is
// (oz, 0, 0) in a (GZ, Y, X) grid.
EXPORT int fused_zslab_f32(int kind, const float* in0, const float* in1,
                           const float* lo0, const float* lo1,
                           const float* hi0, const float* hi1, float* out0,
                           float* out1, int Z, int Y, int X, int GZ, int oz,
                           int k, int periodic, float a, float c0, float c1,
                           float c2, float c3, int tz, int ty, int tx,
                           int threads, int paths, int members,
                          void* stream) {
  return fused_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X, GZ,
                 oz, k, periodic, Coef{a, c0, c1, c2, c3},
                 Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

EXPORT int fused_zslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* lo0, const __nv_bfloat16* lo1,
    const __nv_bfloat16* hi0, const __nv_bfloat16* hi1, __nv_bfloat16* out0,
    __nv_bfloat16* out1, int Z, int Y, int X, int GZ, int oz, int k,
    int periodic, float a, float c0, float c1, float c2, float c3, int tz,
    int ty, int tx, int threads, int paths, int members, void* stream) {
  return fused_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X, GZ,
                 oz, k, periodic, Coef{a, c0, c1, c2, c3},
                 Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

// One K9 launch: a (z, y) shard's (Z, Y, X) core plus, per field, the
// (m, Y, X) z slabs below (zlo) and above (zhi) it, the (Z, m, X) y slabs
// before (ylo) and after (yhi) it and the four (m, m, X) corner pieces
// (ll, lh, hl, hh in (z side, y side) order), k steps on; the core's global
// origin is (oz, oy, 0) in a (GZ, GY, GX) grid.
EXPORT int fused_yzslab_f32(
    int kind, const float* in0, const float* in1, const float* zlo0,
    const float* zlo1, const float* zhi0, const float* zhi1, const float* ylo0,
    const float* ylo1, const float* yhi0, const float* yhi1, const float* cll0,
    const float* cll1, const float* clh0, const float* clh1, const float* chl0,
    const float* chl1, const float* chh0, const float* chh1, float* out0,
    float* out1, int Z, int Y, int X, int GZ, int GY, int GX, int oz, int oy,
    int k, int periodic, float a, float c0, float c1, float c2, float c3,
    int tz, int ty, int tx, int threads, int paths, int members,
    void* stream) {
  const float* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1, ylo0, ylo1, yhi0,
                        yhi1, cll0, cll1, clh0, clh1, chl0, chl1, chh0, chh1};
  return fused_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                  periodic, Coef{a, c0, c1, c2, c3},
                  Tile{tz, ty, tx, threads, paths, members},
                  stream);
}

EXPORT int fused_yzslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* zlo0, const __nv_bfloat16* zlo1,
    const __nv_bfloat16* zhi0, const __nv_bfloat16* zhi1,
    const __nv_bfloat16* ylo0, const __nv_bfloat16* ylo1,
    const __nv_bfloat16* yhi0, const __nv_bfloat16* yhi1,
    const __nv_bfloat16* cll0, const __nv_bfloat16* cll1,
    const __nv_bfloat16* clh0, const __nv_bfloat16* clh1,
    const __nv_bfloat16* chl0, const __nv_bfloat16* chl1,
    const __nv_bfloat16* chh0, const __nv_bfloat16* chh1,
    __nv_bfloat16* out0, __nv_bfloat16* out1, int Z, int Y, int X, int GZ,
    int GY, int GX, int oz, int oy, int k, int periodic, float a, float c0,
    float c1, float c2, float c3, int tz, int ty, int tx,
    int threads, int paths, int members, void* stream) {
  const __nv_bfloat16* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1,
                                ylo0, ylo1, yhi0, yhi1, cll0, cll1,
                                clh0, clh1, chl0, chl1, chh0, chh1};
  return fused_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                  periodic, Coef{a, c0, c1, c2, c3},
                  Tile{tz, ty, tx, threads, paths, members},
                  stream);
}
