// Where a temporal-blocking kernel reads one window cell from: the window
// sources shared by the overlapped-window kernels (fused.cu: K3, K6, K9) and
// the streaming kernel (streamfused.cu), so both read a cell the same way.
//
//   RAW     the whole (Z, Y, X) grid; out-of-domain cells wrap (periodic)
//           or clamp.
//   PADDED  a shard's z/y-padded block (Z+2m, Y+2m, X) from the width-m
//           halo exchange; z and y come from the pad, x wraps or clamps.
//   ZSLAB   a z-only shard's core (Z, Y, X) plus the exchanged (m, Y, X)
//           slabs below and above it as separate operands; y and x are
//           whole and wrap or clamp as in RAW.
//   YZSLAB  a (z, y) shard's core (Z, Y, X) plus eight exchanged operands:
//           the two (m, Y, X) z slabs, the two (Z, m, X) y slabs and the four
//           (m, m, X) corner pieces; x wraps or clamps.  An unsharded z or y
//           axis gets bc-fill or wrap slabs from the exchange, so one source
//           serves (z, y), y-only and z-only meshes.
//
// Coordinates are LOCAL to the core: (0, 0, 0) is the core's first cell, and
// a window reaches m cells past it on z and y (and wraps or clamps on x).
//
// cell_ptr reads any cell, wrapping or clamping each axis.  rows_direct and
// row_ptr serve the windows that need neither: rows whose z and y lie in
// the operands as they are, read a row at a time (fused.cu's fast path).
//
// A batched launch (an ensemble: N members) holds each operand's N blocks
// back to back; the launch grid carries the member b, and cell_ptr,
// row_ptr and out_ptr add b times the operand's member stride (s_in,
// s_zs, s_ys, s_cn, s_out: cells, 0 for an unbatched launch).

#pragma once

#include "stencil_taps.cuh"

enum Source { RAW = 0, PADDED = 1, ZSLAB = 2, YZSLAB = 3 };

// Where a launch's operands live and where its core block sits; T is the
// storage type (float or __nv_bfloat16).
template <class T>
struct WindowT {
  // RAW, (YZ)ZSLAB: the (Z, Y, X) core; PADDED: the padded block
  const T* in[2];
  const T* lo[2];  // (YZ)ZSLAB: the (m, Y, X) z slab just below the core
  const T* hi[2];  // (YZ)ZSLAB: the (m, Y, X) z slab just above the core
  T* out[2];       // (Z, Y, X)
  int Z, Y, X;         // core (output) extent
  int GZ, GY, GX;      // global extent: the frame
  int oz, oy;          // global index of the core's first z plane / y row
  int m;               // PADDED: pad width; (YZ)ZSLAB: slab depth
  const T* ylo[2];  // YZSLAB: the (Z, m, X) y slab just before the core
  const T* yhi[2];  // YZSLAB: the (Z, m, X) y slab just after the core
  // YZSLAB: the (m, m, X) corner pieces in (z side, y side) order: ll, lh,
  // hl, hh
  const T* corner[4][2];
  // a member's cells in each operand: in, the z slabs, the y slabs, the
  // corners, out
  long s_in, s_zs, s_ys, s_cn, s_out;
};

// Member b's block of output field f.
template <class T>
__device__ __forceinline__ T* out_ptr(const WindowT<T>& w, int f, int b) {
  return w.out[f] + b * w.s_out;
}

__device__ __forceinline__ int wrap_or_clamp(int g, int n, int periodic) {
  if (periodic) return ((g % n) + n) % n;
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}

__device__ __forceinline__ int clampi(int g, int lo, int hi) {
  return g < lo ? lo : (g > hi ? hi : g);
}

// Address of field f at local coordinate (z, y, x) of the core (a cell of
// some operand where the source has none: such cells are pinned or never
// reach the core).
template <int SRC, class T>
__device__ __forceinline__ const T* cell_ptr(const WindowT<T>& w, int f,
                                             int z, int y, int x,
                                             int periodic, int b = 0) {
  if constexpr (SRC == RAW) {
    z = wrap_or_clamp(z, w.Z, periodic);
    y = wrap_or_clamp(y, w.Y, periodic);
    x = wrap_or_clamp(x, w.X, periodic);
    return w.in[f] + b * w.s_in + (static_cast<long>(z) * w.Y + y) * w.X +
           x;
  } else if constexpr (SRC == PADDED) {
    const int PY = w.Y + 2 * w.m;
    z = clampi(z + w.m, 0, w.Z + 2 * w.m - 1);
    y = clampi(y + w.m, 0, PY - 1);
    x = wrap_or_clamp(x, w.X, periodic);
    return w.in[f] + b * w.s_in + (static_cast<long>(z) * PY + y) * w.X + x;
  } else if constexpr (SRC == ZSLAB) {
    y = wrap_or_clamp(y, w.Y, periodic);
    x = wrap_or_clamp(x, w.X, periodic);
    const long plane = static_cast<long>(w.Y) * w.X;
    const long row = static_cast<long>(y) * w.X + x;
    if (z < 0)
      return w.lo[f] + b * w.s_zs + clampi(z + w.m, 0, w.m - 1) * plane +
             row;
    if (z >= w.Z)
      return w.hi[f] + b * w.s_zs + clampi(z - w.Z, 0, w.m - 1) * plane +
             row;
    return w.in[f] + b * w.s_in + z * plane + row;
  } else {
    // region along z and along y: 0 below / before the core, 1 in it, 2
    // above / after it; the piece is the (rz, ry) cell of a 3 x 3 tiling
    x = wrap_or_clamp(x, w.X, periodic);
    const int rz = z < 0 ? 0 : (z < w.Z ? 1 : 2);
    const int ry = y < 0 ? 0 : (y < w.Y ? 1 : 2);
    if (rz != 1) z = clampi(rz == 0 ? z + w.m : z - w.Z, 0, w.m - 1);
    if (ry != 1) y = clampi(ry == 0 ? y + w.m : y - w.Y, 0, w.m - 1);
    const T* p;
    long ms;  // the piece's member stride
    if (rz == 1) {
      p = ry == 1 ? w.in[f] : (ry == 0 ? w.ylo[f] : w.yhi[f]);
      ms = ry == 1 ? w.s_in : w.s_ys;
    } else if (ry == 1) {
      p = rz == 0 ? w.lo[f] : w.hi[f];
      ms = w.s_zs;
    } else {
      // constant indices only: a runtime index into the kernel's parameter
      // struct would copy it to local memory
      const int q = (rz == 2) * 2 + (ry == 2);
      p = q == 0 ? w.corner[0][f]
                 : (q == 1 ? w.corner[1][f]
                           : (q == 2 ? w.corner[2][f] : w.corner[3][f]));
      ms = w.s_cn;
    }
    const int rows = ry == 1 ? w.Y : w.m;  // the piece's y extent
    return p + b * ms + (static_cast<long>(z) * rows + y) * w.X + x;
  }
}


// Whether window rows z in [z0, z1), y in [y0, y1) (local) all lie in the
// source's operands as they are, with no wrap or clamp: RAW's grid (m = 0),
// PADDED's pad, ZSLAB's slabs on z (y whole), YZSLAB's slabs and corners.
template <int SRC, class T>
__device__ __forceinline__ bool rows_direct(const WindowT<T>& w, int z0,
                                            int z1, int y0, int y1) {
  const int my = SRC == ZSLAB ? 0 : w.m;
  return z0 >= -w.m && z1 <= w.Z + w.m && y0 >= -my && y1 <= w.Y + my;
}

// Address of field f's row at local (z, y), x = 0, for a row that
// rows_direct admits: cell_ptr's operand choice without its wraps and
// clamps.
template <int SRC, class T>
__device__ __forceinline__ const T* row_ptr(const WindowT<T>& w, int f,
                                            int z, int y, int b = 0) {
  if constexpr (SRC == RAW) {
    return w.in[f] + b * w.s_in + (static_cast<long>(z) * w.Y + y) * w.X;
  } else if constexpr (SRC == PADDED) {
    return w.in[f] + b * w.s_in +
           (static_cast<long>(z + w.m) * (w.Y + 2 * w.m) + (y + w.m)) * w.X;
  } else if constexpr (SRC == ZSLAB) {
    const long plane = static_cast<long>(w.Y) * w.X;
    const long row = static_cast<long>(y) * w.X;
    if (z < 0) return w.lo[f] + b * w.s_zs + (z + w.m) * plane + row;
    if (z >= w.Z) return w.hi[f] + b * w.s_zs + (z - w.Z) * plane + row;
    return w.in[f] + b * w.s_in + z * plane + row;
  } else {
    const int rz = z < 0 ? 0 : (z < w.Z ? 1 : 2);
    const int ry = y < 0 ? 0 : (y < w.Y ? 1 : 2);
    if (rz != 1) z = rz == 0 ? z + w.m : z - w.Z;
    if (ry != 1) y = ry == 0 ? y + w.m : y - w.Y;
    const T* p;
    long ms;
    if (rz == 1) {
      p = ry == 1 ? w.in[f] : (ry == 0 ? w.ylo[f] : w.yhi[f]);
      ms = ry == 1 ? w.s_in : w.s_ys;
    } else if (ry == 1) {
      p = rz == 0 ? w.lo[f] : w.hi[f];
      ms = w.s_zs;
    } else {
      const int q = (rz == 2) * 2 + (ry == 2);
      p = q == 0 ? w.corner[0][f]
                 : (q == 1 ? w.corner[1][f]
                           : (q == 2 ? w.corner[2][f] : w.corner[3][f]));
      ms = w.s_cn;
    }
    const int rows = ry == 1 ? w.Y : w.m;
    return p + b * ms + (static_cast<long>(z) * rows + y) * w.X;
  }
}

// A batched launch's member strides for operands of the source's natural
// shapes: in, the (m, Y, X) z slabs, the (Z, m, X) y slabs and the
// (m, m, X) corners, and the (Z, Y, X) out; all 0 for one member.
template <int SRC, class T>
void set_member_strides(WindowT<T>& w, int members) {
  if (members <= 1) return;
  const long X = w.X, core = static_cast<long>(w.Z) * w.Y * X;
  w.s_in = SRC == PADDED
               ? static_cast<long>(w.Z + 2 * w.m) * (w.Y + 2 * w.m) * X
               : core;
  w.s_zs = static_cast<long>(w.m) * w.Y * X;
  w.s_ys = static_cast<long>(w.Z) * w.m * X;
  w.s_cn = static_cast<long>(w.m) * w.m * X;
  w.s_out = core;
}
