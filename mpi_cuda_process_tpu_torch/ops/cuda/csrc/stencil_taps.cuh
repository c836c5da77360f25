// Per-cell stencil updates shared by the tiled one-step kernels (march.cuh:
// rawstep.cu, zchunk.cu) and the temporal-blocking ones (fused.cu,
// streamfused.cu).
//
// Every update reads the cell and its neighbours through an accessor, so the
// same code serves a shared-memory window, a ring of planes and a register
// queue.
//
// Rounding: all arithmetic goes through __fadd_rn / __fsub_rn / __fmul_rn.
// nvcc never contracts these intrinsics into fused multiply-adds, so each
// sum is rounded exactly as the plain PyTorch version (ops/heat.py,
// ops/wave.py) rounds it, in the same association order: the kernels agree
// with their plain versions bit for bit on the same inputs, and frame cells
// are copied verbatim.  The same holds for advection (ops/advection.py) and
// Gray-Scott (ops/reaction.py), whose compound constants arrive as one float
// each, rounded once from the plain version's own double (F + kappa), and for
// red-black SOR (ops/sor.py), whose half-sweep is heat's update with alpha =
// omega / 6 kept on the cells of one colour.
//
// Storage types: every update is written once over T, float or
// __nv_bfloat16.  Accessors load T and widen it to float, the arithmetic is
// float, and for bfloat16 each helper rounds its result to bfloat16 (round
// to nearest even) and widens it back: PyTorch's bfloat16 eager ops compute
// each elementwise op in float and round it before the next, and a Python
// scalar enters in float, as the float coefficients of Coef do.  So the
// bfloat16 kernels agree bit for bit with the plain version run on bfloat16
// tensors, as the float32 ones do on float32 tensors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

// Stencil kinds; the Python wrappers pass the same integers (4-6, 9, 10 and
// 12 are the 2D kinds of stencil2d.cuh).
enum StencilKind {
  HEAT7 = 0, HEAT27 = 1, HEAT13 = 2, WAVE7 = 3, ADVECT = 7, GRAYSCOTT = 8,
  SOR7 = 11
};

// Coefficients from the op modules (the only copy of the constants), as
// rawstep.py::coefficients orders them: `a` is alpha (heat), omega / 6 (SOR)
// or c2dt2 (wave); c0..c3 are the kind's weights (27-point: centre, face, edge,
// corner; 13-point: centre, w1, w2).  Advection: (a, c0, c1) = the Courant
// numbers (cz, cy, cx).  Gray-Scott: (a, c0, c1, c2) = (Du, Dv, F,
// F + kappa).
struct Coef {
  float a, c0, c1, c2, c3;
};

__host__ __device__ constexpr int kind_halo(int kind) {
  return kind == HEAT13 ? 2 : 1;
}

// Sweeps one step of a kind takes: red-black SOR relaxes the red cells, then
// the black ones reading the fresh red values, so each step consumes two
// halos of a k-step window (ops/stencil.py::k_step_margin).
__host__ __device__ constexpr int kind_phases(int kind) {
  return kind == SOR7 ? 2 : 1;
}

// Window margin of k steps: k * halo * phases (ops/stencil.py::k_step_margin).
__host__ __device__ constexpr int kind_margin(int kind, int k) {
  return k * kind_halo(kind) * kind_phases(kind);
}

// Whether sweep s (1-based) of a multi-phase kind leaves the cell at global
// coordinate sum g alone: sweep s relaxes colour (s - 1) % 2, the cells whose
// coordinate sum has that parity (g & 1 is the floor-mod parity of a negative
// ghost coordinate too, which a periodic wrap over even extents keeps).
__host__ __device__ constexpr bool other_colour(int g, int s) {
  return ((g ^ (s - 1)) & 1) != 0;
}

// A float result rounded to storage type T and widened back (float: as is).
template <class T>
__device__ __forceinline__ float round_to(float r) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(r));
  } else {
    return r;
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A value (already representable in T) stored as T.
template <class T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

template <class T = float>
__device__ __forceinline__ float fadd(float x, float y) {
  return round_to<T>(__fadd_rn(x, y));
}
template <class T = float>
__device__ __forceinline__ float fsub(float x, float y) {
  return round_to<T>(__fsub_rn(x, y));
}
template <class T = float>
__device__ __forceinline__ float fmul(float x, float y) {
  return round_to<T>(__fmul_rn(x, y));
}

// Two bfloat16 values in one 32-bit word (the lower address in the low
// half): the packed operand of the compute_fn kernels' paired cells
// (march.cuh).  An op on two bfloat16 operands rounds its exact result to
// bfloat16 once (add.rn / sub.rn / mul.rn .bf16x2); the float helpers above
// round it to float first and then to bfloat16, which gives the same value
// because float's 24 bits are at least 2 * 8 + 2 (double rounding is then
// innocuous for +, - and *).  A float coefficient enters a packed product
// only where it is a bfloat16 value itself; any other is multiplied in
// float on each half and rounded, as fmul<__nv_bfloat16> does.
struct bf2 {
  unsigned v;
};

template <class T>
__device__ __forceinline__ bf2 fadd(bf2 x, bf2 y) {
  bf2 d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(x.v), "r"(y.v));
  return d;
}
template <class T>
__device__ __forceinline__ bf2 fsub(bf2 x, bf2 y) {
  bf2 d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(x.v), "r"(y.v));
  return d;
}
template <class T>
__device__ __forceinline__ bf2 fmul(float c, bf2 y) {
  const unsigned cb = __float_as_uint(c);
  bf2 d;
  if ((cb & 0xffffu) == 0u) {  // c is a bfloat16 value: one packed product
    const unsigned cc = (cb >> 16) | cb;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(cc), "r"(y.v));
  } else {
    const float lo = __fmul_rn(c, __uint_as_float(y.v << 16));
    const float hi = __fmul_rn(c, __uint_as_float(y.v & 0xffff0000u));
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d.v) : "f"(hi), "f"(lo));
  }
  return d;
}

// The product of two pairs: one packed product (the exact product of two
// bfloat16 values fits a float, so one rounding is float-then-bfloat16's).
template <class T>
__device__ __forceinline__ bf2 fmul(bf2 x, bf2 y) {
  bf2 d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(x.v), "r"(y.v));
  return d;
}
// A float constant minus a pair: one packed difference where the constant
// is a bfloat16 value (1 - u), else each half in float and rounded.
template <class T>
__device__ __forceinline__ bf2 fsub(float c, bf2 y) {
  const unsigned cb = __float_as_uint(c);
  bf2 d;
  if ((cb & 0xffffu) == 0u) {
    const unsigned cc = (cb >> 16) | cb;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(cc), "r"(y.v));
  } else {
    const float lo = __fsub_rn(c, __uint_as_float(y.v << 16));
    const float hi = __fsub_rn(c, __uint_as_float(y.v & 0xffff0000u));
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d.v) : "f"(hi), "f"(lo));
  }
  return d;
}

// Neighbour access for the updates: a(dz, dy, dx) is the value dz planes,
// dy rows and dx cells away from the updated cell, read by the kernel's
// accessor (a shared-memory window, a ring of planes, a register queue).
// The sums below are written once over an accessor, so every kernel adds
// the same taps in the same order.

// 7-point Laplacian: faces summed z-, z+, y-, y+, x-, x+ (left-associated),
// then minus 6 u — ops/stencil.py::axis_laplacian.
template <class A>
__device__ __forceinline__ auto lap7(const A& a) {
  using T = typename A::value_type;
  auto acc = a(-1, 0, 0);
  acc = fadd<T>(acc, a(1, 0, 0));
  acc = fadd<T>(acc, a(0, -1, 0));
  acc = fadd<T>(acc, a(0, 1, 0));
  acc = fadd<T>(acc, a(0, 0, -1));
  acc = fadd<T>(acc, a(0, 0, 1));
  return fsub<T>(acc, fmul<T>(6.0f, a(0, 0, 0)));
}

// The neighbour s cells away along axis d (0 = z, 1 = y, 2 = x).
template <class A>
__device__ __forceinline__ auto along(const A& a, int d, int s) {
  return d == 0 ? a(s, 0, 0) : (d == 1 ? a(0, s, 0) : a(0, 0, s));
}

// New value of a single-field heat cell (not frame-pinned).
template <int KIND, class A>
__device__ __forceinline__ auto heat_update(const A& a, const Coef& c) {
  using T = typename A::value_type;
  const auto u = a(0, 0, 0);
  if (KIND == HEAT7) {
    return fadd<T>(u, fmul<T>(c.a, lap7(a)));
  } else if (KIND == HEAT27) {
    // centre first, then the 26 offsets in (dz, dy, dx) lexicographic
    // order — itertools.product((-1, 0, 1), repeat=3) in ops/heat.py.
    auto acc = fmul<T>(c.c0, u);
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int nz = (dz != 0) + (dy != 0) + (dx != 0);
          if (nz == 0) continue;
          const float w = nz == 1 ? c.c1 : (nz == 2 ? c.c2 : c.c3);
          acc = fadd<T>(acc, fmul<T>(w, a(dz, dy, dx)));
        }
      }
    }
    return fadd<T>(u, fmul<T>(c.a, acc));
  } else {  // HEAT13: axes z, y, x; distances 1, 2; sign -, +.
    auto acc = fmul<T>(c.c0, u);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int dist = 1; dist <= 2; ++dist) {
        const float w = dist == 1 ? c.c1 : c.c2;
        acc = fadd<T>(acc, fmul<T>(w, along(a, d, -dist)));
        acc = fadd<T>(acc, fmul<T>(w, along(a, d, dist)));
      }
    }
    return fadd<T>(u, fmul<T>(c.a, acc));
  }
}

// First-order upwind advection: per axis z, y, x in turn, c > 0 subtracts
// c (u - the cell before), c < 0 subtracts c (the cell after - u), and a
// zero Courant number adds nothing (the plain version skips its term).
// Over floats or bf16x2 pairs (a Courant number that is a bfloat16 value
// multiplies a pair in one packed product, any other each half in float).
template <class A>
__device__ __forceinline__ auto advect_update(const A& a, const Coef& c) {
  using T = typename A::value_type;
  const auto u = a(0, 0, 0);
  const float cs[3] = {c.a, c.c0, c.c1};
  auto acc = u;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (cs[d] > 0.0f) {
      acc = fsub<T>(acc, fmul<T>(cs[d], fsub<T>(u, along(a, d, -1))));
    } else if (cs[d] < 0.0f) {
      acc = fsub<T>(acc, fmul<T>(cs[d], fsub<T>(along(a, d, 1), u)));
    }
  }
  return acc;
}

// New value of a single-field cell: advection, a heat kind, or SOR's
// relaxation of a cell of the sweep's colour (7-point heat with alpha =
// omega / 6).
template <int KIND, class A>
__device__ __forceinline__ float field_update(const A& a, const Coef& c) {
  if constexpr (KIND == ADVECT) {
    return advect_update(a, c);
  } else if constexpr (KIND == SOR7) {
    return heat_update<HEAT7>(a, c);
  } else {
    return heat_update<KIND>(a, c);
  }
}

// Gray-Scott, both fields read with their neighbours:
//   u' = ((u + Du lap7(u)) - (u v) v) + F (1 - u)
//   v' = ((v + Dv lap7(v)) + (u v) v) - (F + kappa) v
// over floats or bf16x2 pairs (`nu`, `nv` of the accessor's value type:
// u v and (u v) v are packed products, 1 - u a packed difference; Du, Dv,
// F and F + kappa are no bfloat16 values, so each half multiplies in
// float).
template <class A, class V>
__device__ __forceinline__ void grayscott_update(const A& au, const A& av,
                                                 const Coef& c, V& nu,
                                                 V& nv) {
  using T = typename A::value_type;
  const auto u = au(0, 0, 0);
  const auto v = av(0, 0, 0);
  const auto uvv = fmul<T>(fmul<T>(u, v), v);
  nu = fadd<T>(fsub<T>(fadd<T>(u, fmul<T>(c.a, lap7(au))), uvv),
               fmul<T>(c.c1, fsub<T>(1.0f, u)));
  nv = fsub<T>(fadd<T>(fadd<T>(v, fmul<T>(c.c0, lap7(av))), uvv),
               fmul<T>(c.c2, v));
}

// Leapfrog wave update: (2 u - u_prev) + c2dt2 * lap7(u), over floats or
// bf16x2 pairs (`uprev` of the accessor's value type; 2 is a bfloat16
// value, so 2 u is one packed product).
template <class A, class V>
__device__ __forceinline__ auto wave_update(const A& a, V uprev,
                                            const Coef& c) {
  using T = typename A::value_type;
  return fadd<T>(fsub<T>(fmul<T>(2.0f, a(0, 0, 0)), uprev),
                 fmul<T>(c.a, lap7(a)));
}

EXPORT const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
