// K1 raw_step_heat<KIND>, K2 raw_step_wave and raw_step_grayscott: one
// whole guard-frame step on the raw (Z, Y, X) grid, float32 or bfloat16
// (the storage type T; the arithmetic and its rounding are
// stencil_taps.cuh's).
//
// Replaces: the TPU package's ops/pallas/rawstep.py — make_raw_step's
// _heat_kernel with the _taps7 / _taps27 / _taps13 / _taps_advect tap sets
// (K1; KIND = ADVECT is the upwind advection step), _wave_kernel (K2) and
// _grayscott_kernel (raw_step_grayscott: two fields in, both read with
// their neighbours, two out, both frame-pinned).  There the grid is cut
// into z-chunks held in VMEM with halo planes fetched by clamped BlockSpecs
// and y/x taps done as rolls.
//
// Bound on an H100: device-memory bytes.  The step must read the grid once
// and write it once (K2 also reads u_prev, Gray-Scott reads and writes two
// fields): 2 (K2: 3, Gray-Scott: 4) x 4 B per cell (2 B in bfloat16)
// against ~0.2 (7-point) to ~0.7 (27-point) flop/B, far below the card's
// ~20 flop/B float32 ridge; bfloat16 halves the bytes and doubles the
// flop/B, still far below it.
//
// All three are march.cuh's tiled kernel on the raw grid (FRAME): a block
// owns a (TY, TX) tile of the planes and marches down z through a ring of
// the grid's own planes in shared memory (16-byte cp.async of the aligned
// words that cover each row, nothing outside the grid copied), the taps
// from shared memory (heat3d, heat3d4th and wave3d may take the z taps
// from a register queue; wave3d always does, its u_prev loaded into the
// registers of each cell's thread), bfloat16 cells in pairs
// through the bf16x2 ops; Gray-Scott marches v through a second ring beside
// u and writes both.  Frame cells keep their value (Gray-Scott: both
// fields'), tested only on tiles and runs that touch a wall, all in one
// launch.  rawstep.TILES names each kind's tile.

#include "march.cuh"

namespace {

template <class T>
int heat_launch(int kind, const T* u, T* out, int Z, int Y, int X,
                const Coef& c, int build, bool zq, int tx, int ty, int zr,
                int rwb, int slots, void* stream) {
  const march::Geom g = march::make_geom(Z, Y, X, kind_halo(kind), true,
                                         false, tx, ty, zr, rwb, slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT7:
      return march::launch_build<HEAT7, T, true>(build, zq, u, nullptr, out,
                                                 g, c, s);
    case HEAT27:
      return march::launch_build<HEAT27, T, true>(build, zq, u, nullptr,
                                                  out, g, c, s);
    case HEAT13:
      return march::launch_build<HEAT13, T, true>(build, zq, u, nullptr,
                                                  out, g, c, s);
    case ADVECT:
      return march::launch_build<ADVECT, T, true>(build, zq, u, nullptr,
                                                  out, g, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int wave_launch(const T* u, const T* uprev, T* out, int Z, int Y, int X,
                float c2dt2, int build, bool zq, int tx, int ty, int zr,
                int rwb, int slots, void* stream) {
  const march::Geom g = march::make_geom(Z, Y, X, 1, true, false, tx, ty, zr,
                                         rwb, slots);
  return march::launch_build<WAVE7, T, true>(
      build, zq, u, uprev, out, g, Coef{c2dt2, 0.f, 0.f, 0.f, 0.f},
      static_cast<cudaStream_t>(stream));
}

template <class T>
int grayscott_launch(const T* u, const T* v, T* ou, T* ov, int Z, int Y,
                     int X, const Coef& c, int build, bool zq, int tx,
                     int ty, int zr, int rwb, int slots, void* stream) {
  const march::Geom g = march::make_geom(Z, Y, X, 1, true, false, tx, ty, zr,
                                         rwb, slots);
  return march::launch_build<GRAYSCOTT, T, true>(
      build, zq, u, v, ou, g, c, static_cast<cudaStream_t>(stream), ov);
}

}  // namespace

// One K1 launch on `stream` (march.cuh on the raw grid): out = step(u).
// The tile arguments are K4's (rawstep.TILES, march.march_geometry); K2
// and Gray-Scott take the same.  Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel does not take.  The
// _bf16 twins take bfloat16 grids.
EXPORT int raw_step_heat_f32(int kind, const float* u, float* out, int Z,
                             int Y, int X, float a, float c0, float c1,
                             float c2, float c3, int build, int zq, int tx,
                             int ty, int zr, int rwb, int slots,
                             void* stream) {
  return heat_launch(kind, u, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, build,
                     zq != 0, tx, ty, zr, rwb, slots, stream);
}

EXPORT int raw_step_heat_bf16(int kind, const __nv_bfloat16* u,
                              __nv_bfloat16* out, int Z, int Y, int X,
                              float a, float c0, float c1, float c2,
                              float c3, int build, int zq, int tx, int ty,
                              int zr, int rwb, int slots, void* stream) {
  return heat_launch(kind, u, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, build,
                     zq != 0, tx, ty, zr, rwb, slots, stream);
}

// One K2 launch on `stream`: out = new u (a z-queue tile).
EXPORT int raw_step_wave_f32(const float* u, const float* uprev, float* out,
                             int Z, int Y, int X, float c2dt2, int build,
                             int zq, int tx, int ty, int zr, int rwb,
                             int slots, void* stream) {
  return wave_launch(u, uprev, out, Z, Y, X, c2dt2, build, zq != 0, tx, ty,
                     zr, rwb, slots, stream);
}

EXPORT int raw_step_wave_bf16(const __nv_bfloat16* u,
                              const __nv_bfloat16* uprev, __nv_bfloat16* out,
                              int Z, int Y, int X, float c2dt2, int build,
                              int zq, int tx, int ty, int zr, int rwb,
                              int slots, void* stream) {
  return wave_launch(u, uprev, out, Z, Y, X, c2dt2, build, zq != 0, tx, ty,
                     zr, rwb, slots, stream);
}

// One Gray-Scott launch on `stream`: (ou, ov) = step(u, v); (du, dv, f, fk)
// are (Du, Dv, F, F + kappa).
EXPORT int raw_step_grayscott_f32(const float* u, const float* v, float* ou,
                                  float* ov, int Z, int Y, int X, float du,
                                  float dv, float f, float fk, int build,
                                  int zq, int tx, int ty, int zr, int rwb,
                                  int slots, void* stream) {
  return grayscott_launch(u, v, ou, ov, Z, Y, X, Coef{du, dv, f, fk, 0.f},
                          build, zq != 0, tx, ty, zr, rwb, slots, stream);
}

EXPORT int raw_step_grayscott_bf16(const __nv_bfloat16* u,
                                   const __nv_bfloat16* v,
                                   __nv_bfloat16* ou, __nv_bfloat16* ov,
                                   int Z, int Y, int X, float du, float dv,
                                   float f, float fk, int build, int zq,
                                   int tx, int ty, int zr, int rwb,
                                   int slots, void* stream) {
  return grayscott_launch(u, v, ou, ov, Z, Y, X, Coef{du, dv, f, fk, 0.f},
                          build, zq != 0, tx, ty, zr, rwb, slots, stream);
}
