// Per-cell 2D updates shared by the whole-grid compute_fn kernel
// (whole2d.cu, K7) and the 2D temporal-blocking kernels (fullgrid.cu, K8:
// its tiled kind and its streaming kind, ring.cuh).
//
// Every update reads the cell and its neighbours through an accessor
// (Strided2: offsets of `sy`, one row, and 1, one column, elements), so the
// same code serves a padded block in device memory, a window in shared
// memory and the ring of rows of the streaming kernel (ring.cuh).  Float
// sums go through stencil_taps.cuh's fadd<T> / fsub<T> / fmul<T> in the plain
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

// Neighbour access for the 2D updates: a(dy, dx) is the value dy rows and
// dx cells away from the updated cell.  Strided2 reads a block laid out in
// memory (a padded block in device memory, a window in shared memory); the
// streaming kernel (ring.cuh) reads rows that sit in a ring.  The updates
// below are written once over an accessor, so every kernel adds the same
// taps in the same order.
__device__ __forceinline__ int widen(int x) { return x; }

template <class T>
struct Strided2 {
  using value_type = T;
  const T* p;
  long sy;
  __device__ __forceinline__ auto operator()(int dy, int dx) const {
    return widen(p[dy * sy + dx]);
  }
};

// 5-point Laplacian: ((((y-) + (y+)) + (x-)) + (x+)) - 4 u.
template <class A>
__device__ __forceinline__ auto lap5(const A& a) {
  using T = typename A::value_type;
  auto acc = a(-1, 0);
  acc = fadd<T>(acc, a(1, 0));
  acc = fadd<T>(acc, a(0, -1));
  acc = fadd<T>(acc, a(0, 1));
  return fsub<T>(acc, fmul<T>(4.0f, a(0, 0)));
}

// heat2d / mdf: u + alpha * lap5(u).
template <class A>
__device__ __forceinline__ auto heat5(const A& a, float alpha) {
  using T = typename A::value_type;
  return fadd<T>(a(0, 0), fmul<T>(alpha, lap5(a)));
}

// wave2d leapfrog: (2 u - u_prev) + c2dt2 * lap5(u).
template <class A>
__device__ __forceinline__ float wave5(const A& a, float uprev, float c2dt2) {
  using T = typename A::value_type;
  return fadd<T>(fsub<T>(fmul<T>(2.0f, a(0, 0)), uprev),
                 fmul<T>(c2dt2, lap5(a)));
}

// advect2d: per axis y, x in turn, c > 0 subtracts c (u - the cell before),
// c < 0 subtracts c (the cell after - u), c == 0 adds nothing.
template <class A>
__device__ __forceinline__ float advect5(const A& a, float cy, float cx) {
  using T = typename A::value_type;
  const float u = a(0, 0);
  float acc = u;
  if (cy > 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cy, fsub<T>(u, a(-1, 0))));
  } else if (cy < 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cy, fsub<T>(a(1, 0), u)));
  }
  if (cx > 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cx, fsub<T>(u, a(0, -1))));
  } else if (cx < 0.0f) {
    acc = fsub<T>(acc, fmul<T>(cx, fsub<T>(a(0, 1), u)));
  }
  return acc;
}

// grayscott2d, both fields read with their neighbours; c = (Du, Dv, F,
// F + kappa) in (a, c0, c1, c2), as stencil_taps.cuh::grayscott_update.
template <class A>
__device__ __forceinline__ void grayscott5(const A& au, const A& av,
                                           const Coef& c, float& nu,
                                           float& nv) {
  using T = typename A::value_type;
  const float u = au(0, 0), v = av(0, 0);
  const float uvv = fmul<T>(fmul<T>(u, v), v);
  nu = fadd<T>(fsub<T>(fadd<T>(u, fmul<T>(c.a, lap5(au))), uvv),
               fmul<T>(c.c1, fsub<T>(1.0f, u)));
  nv = fsub<T>(fadd<T>(fadd<T>(v, fmul<T>(c.c0, lap5(av))), uvv),
               fmul<T>(c.c2, v));
}

// B3/S23: alive next when 3 neighbours are, or 2 are and the cell is (== 1).
template <class A>
__device__ __forceinline__ int life8(const A& a) {
  const int n = a(-1, -1) + a(-1, 0) + a(-1, 1) + a(0, -1) + a(0, 1) +
                a(1, -1) + a(1, 0) + a(1, 1);
  return (n == 3 || (n == 2 && a(0, 0) == 1)) ? 1 : 0;
}

// The same updates on a block in memory: the cell at `p`, rows `sy`
// elements apart.
template <class T>
__device__ __forceinline__ float heat5(const T* p, long sy, float alpha) {
  return heat5(Strided2<T>{p, sy}, alpha);
}

template <class T>
__device__ __forceinline__ float wave5(const T* p, float uprev, long sy,
                                       float c2dt2) {
  return wave5(Strided2<T>{p, sy}, uprev, c2dt2);
}

template <class T>
__device__ __forceinline__ float advect5(const T* p, long sy, float cy,
                                         float cx) {
  return advect5(Strided2<T>{p, sy}, cy, cx);
}

template <class T>
__device__ __forceinline__ void grayscott5(const T* pu, const T* pv, long sy,
                                           const Coef& c, float& nu,
                                           float& nv) {
  grayscott5(Strided2<T>{pu, sy}, Strided2<T>{pv, sy}, c, nu, nv);
}

__device__ __forceinline__ int life8(const int* p, long sy) {
  return life8(Strided2<int>{p, sy});
}

// Wrap (periodic) or clamp a coordinate into [0, n).
__device__ __forceinline__ int wrap_or_clamp2(int g, int n, int periodic) {
  if (periodic) return ((g % n) + n) % n;
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}
