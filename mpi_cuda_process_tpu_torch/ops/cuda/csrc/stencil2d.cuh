// Per-cell 2D updates shared by the whole-grid compute_fn kernel
// (whole2d.cu, K7) and the 2D temporal-blocking kernel (fullgrid.cu, K8).
//
// Every update reads the cell at `p` and its neighbours at offsets of `sy`
// (one row) and 1 (one column) elements, so the same code serves a padded
// block in device memory and a window in shared memory.  Float sums go
// through __fadd_rn / __fsub_rn / __fmul_rn (stencil_taps.cuh) in the plain
// version's association order (ops/stencil.py::axis_laplacian: faces
// y-, y+, x-, x+ left-associated, centre term last), so the kernels equal
// ops/heat.py, ops/wave.py and ops/life.py bit for bit.

#pragma once

#include "stencil_taps.cuh"

// 2D stencil kinds; the Python wrappers pass the same integers.
enum Stencil2DKind { HEAT5 = 4, WAVE5 = 5, LIFE = 6 };

// Element type of a kind's fields: int32 occupancy for Life, float32 else.
template <int KIND>
struct Elem {
  using T = float;
};
template <>
struct Elem<LIFE> {
  using T = int;
};

// 5-point Laplacian: ((((y-) + (y+)) + (x-)) + (x+)) - 4 u.
__device__ __forceinline__ float lap5(const float* p, long sy) {
  float acc = p[-sy];
  acc = fadd(acc, p[sy]);
  acc = fadd(acc, p[-1]);
  acc = fadd(acc, p[1]);
  return fsub(acc, fmul(4.0f, p[0]));
}

// heat2d / mdf: u + alpha * lap5(u).
__device__ __forceinline__ float heat5(const float* p, long sy, float alpha) {
  return fadd(p[0], fmul(alpha, lap5(p, sy)));
}

// wave2d leapfrog: (2 u - u_prev) + c2dt2 * lap5(u).
__device__ __forceinline__ float wave5(const float* p, float uprev, long sy,
                                       float c2dt2) {
  return fadd(fsub(fmul(2.0f, p[0]), uprev), fmul(c2dt2, lap5(p, sy)));
}

// B3/S23: alive next when 3 neighbours are, or 2 are and the cell is (== 1).
__device__ __forceinline__ int life8(const int* p, long sy) {
  const int n = p[-sy - 1] + p[-sy] + p[-sy + 1] + p[-1] + p[1] +
                p[sy - 1] + p[sy] + p[sy + 1];
  return (n == 3 || (n == 2 && p[0] == 1)) ? 1 : 0;
}

// Wrap (periodic) or clamp a coordinate into [0, n).
__device__ __forceinline__ int wrap_or_clamp2(int g, int n, int periodic) {
  if (periodic) return ((g % n) + n) % n;
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}
