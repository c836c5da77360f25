// K7 whole2d<HEAT5|LIFE>: the 2D compute_fn kernel, one update of a
// halo-padded block with no frame logic (the caller re-pins).
//
// Replaces: the TPU package's ops/pallas/kernels.py — _whole2d_compute with
// _heat2d_kernel (heat2d / mdf, any float type) and _life_kernel (life,
// int32).  There one program holds the whole padded grid in VMEM, and
// grids above a VMEM cap quietly take the plain update instead.  Here the
// block is tiled, so any extent runs on the kernel.
//
// Input: the padded block (H+2, W+2) — from the guard-value or wrap pad of
// driver.make_step, or from the halo exchange under --mesh.  Output: the
// (H, W) interior: u + alpha * lap5(u) (float32 or bfloat16, rounded after
// every op as the plain version rounds it), or the B3/S23 rule (int32).
// Taps and their order are stencil2d.cuh's, i.e. the plain update's, so the
// kernel equals ops/heat.py / ops/life.py bit for bit.
//
// Bound on an H100: device-memory bytes.  One launch must read the padded
// block once and write the interior once, 8 B per cell (bfloat16: 4),
// against 7 flop (heat) or 8 integer adds (life).  K7 is march.cuh's
// kernel with a row for a plane: a block of TX columns marches down a run
// of ZR rows, each padded row segment landing in a ring of rows in shared
// memory by 16-byte cp.async of the aligned words that cover it (the row
// pitch W + 2 is rarely 16-byte aligned), a few rows ahead, and the
// block's threads update the row whose neighbours are in, reading the taps
// from shared memory (bfloat16: pairs of cells with the bf16x2 ops).

#include "march.cuh"

// One K7 launch on `stream`: out (H, W) = update of the padded p
// (H+2, W+2); `a` is alpha (HEAT5) and unused by LIFE.  The tile names its
// build (march.BUILDS), its columns TX and rows a run ZR; the row buffer
// bytes and ring slots come from march.march_geometry and are checked
// here.  HEAT5 on float32 and LIFE on int32 here, HEAT5 on bfloat16 (its
// cells in pairs) in the _bf16 twin.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
namespace {

march::Geom geom2d(int H, int W, int tx, int zr, int rwb, int slots,
                   int members) {
  march::Geom g =
      march::make_geom(H, 1, W, 1, false, true, tx, 1, zr, rwb, slots);
  g.N = members;
  return g;
}

}  // namespace

EXPORT int whole2d_step(int kind, const void* p, void* out, int H, int W,
                        float a, int build, int tx, int zr, int rwb,
                        int slots, int members, void* stream) {
  const march::Geom g = geom2d(H, W, tx, zr, rwb, slots, members);
  const Coef c{a, 0.f, 0.f, 0.f, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT5:
      return march::launch_build<HEAT5, float>(
          build, false, static_cast<const float*>(p), nullptr,
          static_cast<float*>(out), g, c, s);
    case LIFE:
      return march::launch_build<LIFE, int>(
          build, false, static_cast<const int*>(p), nullptr,
          static_cast<int*>(out), g, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

EXPORT int whole2d_step_bf16(int kind, const void* p, void* out, int H,
                             int W, float a, int build, int tx, int zr,
                             int rwb, int slots, int members,
                             void* stream) {
  const march::Geom g = geom2d(H, W, tx, zr, rwb, slots, members);
  const Coef c{a, 0.f, 0.f, 0.f, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind != HEAT5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return march::launch_build<HEAT5, __nv_bfloat16>(
      build, false, static_cast<const __nv_bfloat16*>(p), nullptr,
      static_cast<__nv_bfloat16*>(out), g, c, s);
}
