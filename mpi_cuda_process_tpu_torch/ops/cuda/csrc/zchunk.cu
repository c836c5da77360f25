// K4 zchunk_heat<KIND> and K5 zchunk_wave: the compute_fn kernels, one
// update of a halo-padded block with no frame logic (the caller re-pins).
//
// Replaces: the TPU package's ops/pallas/kernels.py — _heat3d_compute's
// _zchunk_kernel with the _slab_taps_7 / _slab_taps_27 / _slab_taps_13 tap
// sets (K4) and _wave3d_compute's _zchunk_wave_kernel (K5).  There each
// program holds a z-chunk of bz padded planes plus a 2*halo tail in VMEM;
// bz must divide Z (a VMEM sizing rule).  Here any extent is accepted.
//
// Input: the padded block (Z+2h, Y+2h, X+2h) — from the halo exchange under
// --mesh, from the wrap pad under --periodic.  Output: the (Z, Y, X)
// interior, u + alpha * lap(u) for K4, 2u - u_prev + c2dt2 * lap7(u) for K5
// (u_prev unpadded, (Z, Y, X)).  Taps and their association order are those
// of stencil_taps.cuh, i.e. of the plain update in ops/heat.py and
// ops/wave.py: the 13-point sum runs axis by axis (z, y, x), distance 1
// then 2, minus side then plus — ops/heat.py's order, not the TPU kernel's
// _slab_taps_13, which adds the three axes' taps of one offset first.  So
// the kernels agree with the plain update bit for bit.
//
// Storage type T: float32 or bfloat16 (the operands and the output), with
// stencil_taps.cuh's arithmetic: float32 ops, or on pairs of bfloat16
// cells the bf16x2 ops, which round each op's exact result once to the
// value the plain version's float-then-bfloat16 gives; so the kernels are
// bit-equal to the plain version on float32 and bfloat16 tensors.
//
// Bound on an H100: device-memory bytes.  One launch must read the padded
// block once and write the interior once (K5 also reads u_prev): about
// 8 (K5: 12) B per cell in float32, half that in bfloat16, against 10-55
// flop, below the ~20 flop/B float32 ridge.
//
// Both are march.cuh's 2.5D kernel: a block owns a (TY, TX) tile of the
// planes and marches down z through a ring of padded planes in shared
// memory, filled by 16-byte cp.async of the aligned words that cover each
// row, so every cell is read from device memory about once and the taps
// come from shared memory (and, for heat3d, heat3d4th and wave3d, the z
// taps from a register queue).  K5's u_prev goes straight into registers
// of the thread that updates the cell; kernels.TILES names the tile.

#include "march.cuh"

// One K4 launch on `stream` (march.cuh): out (Z, Y, X) = update of the
// padded p.  The tile names its build (march.BUILDS), whether the z taps
// come from a register queue (zq), its cells TX, rows TY and run of ZR
// planes; the row buffer bytes and ring slots come from
// march.march_geometry and are checked here.  Returns cudaGetLastError()
// or cudaErrorInvalidValue for a geometry the kernel does not take.  Each
// export has a _bf16 twin on bfloat16 operands (their cells in pairs).
namespace {

template <class T>
int launch_heat(int kind, const T* p, T* out, int Z, int Y, int X,
                const Coef& c, int build, bool zq, int tx, int ty, int zr,
                int rwb, int slots, int members, void* stream) {
  march::Geom g = march::make_geom(Z, Y, X, kind_halo(kind), false, false,
                                   tx, ty, zr, rwb, slots);
  g.N = members;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT7:
      return march::launch_build<HEAT7, T>(build, zq, p, nullptr, out, g, c,
                                           s);
    case HEAT27:
      return march::launch_build<HEAT27, T>(build, zq, p, nullptr, out, g,
                                            c, s);
    case HEAT13:
      return march::launch_build<HEAT13, T>(build, zq, p, nullptr, out, g,
                                            c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int launch_wave(const T* p, const T* uprev, T* out, int Z, int Y, int X,
                float c2dt2, int build, bool zq, int tx, int ty, int zr,
                int rwb, int slots, int members, void* stream) {
  march::Geom g = march::make_geom(Z, Y, X, 1, false, false, tx, ty, zr,
                                   rwb, slots);
  g.N = members;
  return march::launch_build<WAVE7, T>(build, zq, p, uprev, out, g,
                                       Coef{c2dt2, 0.f, 0.f, 0.f, 0.f},
                                       static_cast<cudaStream_t>(stream));
}

}  // namespace

EXPORT int zchunk_heat_f32(int kind, const float* p, float* out, int Z,
                           int Y, int X, float a, float c0, float c1,
                           float c2, float c3, int build, int zq, int tx,
                           int ty, int zr, int rwb, int slots, int members,
                           void* stream) {
  return launch_heat(kind, p, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, build,
                     zq != 0, tx, ty, zr, rwb, slots, members, stream);
}

EXPORT int zchunk_heat_bf16(int kind, const __nv_bfloat16* p,
                            __nv_bfloat16* out, int Z, int Y, int X, float a,
                            float c0, float c1, float c2, float c3,
                            int build, int zq, int tx, int ty, int zr,
                            int rwb, int slots, int members, void* stream) {
  return launch_heat(kind, p, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, build,
                     zq != 0, tx, ty, zr, rwb, slots, members, stream);
}

// One K5 launch on `stream`: out = new u from the padded u and the
// unpadded u_prev, with K4's tile arguments (a z-queue tile).
EXPORT int zchunk_wave_f32(const float* p, const float* uprev, float* out,
                           int Z, int Y, int X, float c2dt2, int build,
                           int zq, int tx, int ty, int zr, int rwb,
                           int slots, int members, void* stream) {
  return launch_wave(p, uprev, out, Z, Y, X, c2dt2, build, zq != 0, tx, ty,
                     zr, rwb, slots, members, stream);
}

EXPORT int zchunk_wave_bf16(const __nv_bfloat16* p,
                            const __nv_bfloat16* uprev, __nv_bfloat16* out,
                            int Z, int Y, int X, float c2dt2, int build,
                            int zq, int tx, int ty, int zr, int rwb,
                            int slots, int members, void* stream) {
  return launch_wave(p, uprev, out, Z, Y, X, c2dt2, build, zq != 0, tx, ty,
                     zr, rwb, slots, members, stream);
}
