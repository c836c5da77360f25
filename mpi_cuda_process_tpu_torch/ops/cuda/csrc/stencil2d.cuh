// Per-cell 2D updates shared by the whole-grid compute_fn kernel
// (whole2d.cu, K7) and the 2D temporal-blocking kernel (fullgrid.cu, K8).
//
// Every update reads the cell at `p` and its neighbours at offsets of `sy`
// (one row) and 1 (one column) elements, so the same code serves a padded
// block in device memory and a window in shared memory.  Float sums go
// through stencil_taps.cuh's fadd<T> / fsub<T> / fmul<T> in the plain
// version's association order (ops/stencil.py::axis_laplacian: faces
// y-, y+, x-, x+ left-associated, centre term last), so the kernels equal
// ops/heat.py, ops/wave.py, ops/life.py, ops/advection.py,
// ops/reaction.py and ops/sor.py (a half-sweep: heat5 with alpha = omega /
// 4 on the cells of one colour) bit for bit.
//
// Storage types: the float updates are written once over T, float or
// __nv_bfloat16, as stencil_taps.cuh's 3D updates are: loads widen T to
// float, and for bfloat16 every helper rounds its result to bfloat16
// (round to nearest even), as PyTorch's eager bfloat16 ops do.  Each
// returns a float already representable in T (narrow<T> stores it).  Life
// stays int.

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

// 5-point Laplacian: ((((y-) + (y+)) + (x-)) + (x+)) - 4 u.
template <class T>
__device__ __forceinline__ float lap5(const T* p, long sy) {
  float acc = widen(p[-sy]);
  acc = fadd<T>(acc, widen(p[sy]));
  acc = fadd<T>(acc, widen(p[-1]));
  acc = fadd<T>(acc, widen(p[1]));
  return fsub<T>(acc, fmul<T>(4.0f, widen(p[0])));
}

// heat2d / mdf: u + alpha * lap5(u).
template <class T>
__device__ __forceinline__ float heat5(const T* p, long sy, float alpha) {
  return fadd<T>(widen(p[0]), fmul<T>(alpha, lap5(p, sy)));
}

// wave2d leapfrog: (2 u - u_prev) + c2dt2 * lap5(u).
template <class T>
__device__ __forceinline__ float wave5(const T* p, float uprev, long sy,
                                       float c2dt2) {
  return fadd<T>(fsub<T>(fmul<T>(2.0f, widen(p[0])), uprev),
                 fmul<T>(c2dt2, lap5(p, sy)));
}

// advect2d: per axis y, x in turn, c > 0 subtracts c (u - the cell before),
// c < 0 subtracts c (the cell after - u), c == 0 adds nothing.
template <class T>
__device__ __forceinline__ float advect5(const T* p, long sy, float cy,
                                         float cx) {
  const float u = widen(p[0]);
  float acc = u;
  if (cy > 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cy, fsub<T>(u, widen(p[-sy]))));
  } else if (cy < 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cy, fsub<T>(widen(p[sy]), u)));
  }
  if (cx > 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cx, fsub<T>(u, widen(p[-1]))));
  } else if (cx < 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cx, fsub<T>(widen(p[1]), u)));
  }
  return acc;
}

// grayscott2d, both fields read with their neighbours; c = (Du, Dv, F,
// F + kappa) in (a, c0, c1, c2), as stencil_taps.cuh::grayscott_update.
template <class T>
__device__ __forceinline__ void grayscott5(const T* pu, const T* pv, long sy,
                                           const Coef& c, float& nu,
                                           float& nv) {
  const float u = widen(pu[0]), v = widen(pv[0]);
  const float uvv = fmul<T>(fmul<T>(u, v), v);
  nu = fadd<T>(fsub<T>(fadd<T>(u, fmul<T>(c.a, lap5(pu, sy))), uvv),
               fmul<T>(c.c1, fsub<T>(1.0f, u)));
  nv = fsub<T>(fadd<T>(fadd<T>(v, fmul<T>(c.c0, lap5(pv, sy))), uvv),
               fmul<T>(c.c2, v));
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
