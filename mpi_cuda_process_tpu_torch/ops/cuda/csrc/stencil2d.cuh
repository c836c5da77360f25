// Per-cell 2D updates shared by the whole-grid compute_fn kernel
// (whole2d.cu, K7) and the 2D temporal-blocking kernel (fullgrid.cu, K8).
//
// Every update reads the cell at `p` and its neighbours at offsets of `sy`
// (one row) and 1 (one column) elements, so the same code serves a padded
// block in device memory and a window in shared memory.  Float sums go
// through __fadd_rn / __fsub_rn / __fmul_rn (stencil_taps.cuh) in the plain
// version's association order (ops/stencil.py::axis_laplacian: faces
// y-, y+, x-, x+ left-associated, centre term last), so the kernels equal
// ops/heat.py, ops/wave.py, ops/life.py, ops/advection.py,
// ops/reaction.py and ops/sor.py (a half-sweep: heat5 with alpha = omega /
// 4 on the cells of one colour) bit for bit.

#pragma once

#include "stencil_taps.cuh"

// 2D stencil kinds; the Python wrappers pass the same integers.
enum Stencil2DKind {
  HEAT5 = 4, WAVE5 = 5, LIFE = 6, ADVECT2D = 9, GRAYSCOTT2D = 10, SOR5 = 12
};

// Sweeps one step of a 2D kind takes (red-black SOR: two half-sweeps of
// halo 1), so k steps consume a margin of k * phases rows and columns
// (ops/stencil.py::k_step_margin; every 2D kind has halo 1).
__host__ __device__ constexpr int kind_phases2(int kind) {
  return kind == SOR5 ? 2 : 1;
}

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

// advect2d: per axis y, x in turn, c > 0 subtracts c (u - the cell before),
// c < 0 subtracts c (the cell after - u), c == 0 adds nothing.
__device__ __forceinline__ float advect5(const float* p, long sy, float cy,
                                         float cx) {
  const float u = p[0];
  float acc = u;
  if (cy > 0.0f) {
    acc = fsub(acc, fmul(cy, fsub(u, p[-sy])));
  } else if (cy < 0.0f) {
    acc = fsub(acc, fmul(cy, fsub(p[sy], u)));
  }
  if (cx > 0.0f) {
    acc = fsub(acc, fmul(cx, fsub(u, p[-1])));
  } else if (cx < 0.0f) {
    acc = fsub(acc, fmul(cx, fsub(p[1], u)));
  }
  return acc;
}

// grayscott2d, both fields read with their neighbours; c = (Du, Dv, F,
// F + kappa) in (a, c0, c1, c2), as stencil_taps.cuh::grayscott_update.
__device__ __forceinline__ void grayscott5(const float* pu, const float* pv,
                                           long sy, const Coef& c, float& nu,
                                           float& nv) {
  const float u = pu[0], v = pv[0];
  const float uvv = fmul(fmul(u, v), v);
  nu = fadd(fsub(fadd(u, fmul(c.a, lap5(pu, sy))), uvv),
            fmul(c.c1, fsub(1.0f, u)));
  nv = fsub(fadd(fadd(v, fmul(c.c0, lap5(pv, sy))), uvv), fmul(c.c2, v));
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
