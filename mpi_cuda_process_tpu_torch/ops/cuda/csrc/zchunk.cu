// K4 zchunk_heat<KIND> and K5 zchunk_wave: the compute_fn kernels, one
// update of a halo-padded block with no frame logic (the caller re-pins).
//
// Replaces: the TPU package's ops/pallas/kernels.py — _heat3d_compute's
// _zchunk_kernel with the _slab_taps_7 / _slab_taps_27 / _slab_taps_13 tap
// sets (K4) and _wave3d_compute's _zchunk_wave_kernel (K5).  There each
// program holds a z-chunk of bz padded planes plus a 2*halo tail in VMEM;
// bz must divide Z (a VMEM sizing rule).  Here any extent is accepted: every
// thread owns one (y, x) column of the output and marches over a run of
// ZRUN planes, reading its taps straight from device memory.
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
// stencil_taps.cuh's arithmetic: float, rounded to bfloat16 after every op
// as the plain version rounds it, so the bfloat16 kernels are bit-equal to
// the plain version on bfloat16 tensors too.
//
// Bound on an H100: device-memory bytes.  One launch must read the padded
// block once and write the interior once (K5 also reads u_prev): about
// 8 (K5: 12) B per cell in float32, half that in bfloat16, against 10-55
// flop, below the ~20 flop/B float32 ridge.  Design against that bound: a
// warp covers 32 consecutive x cells, so loads and stores are coalesced
// lines; the z and y neighbours of a cell are the centre loads of the
// threads marching beside and behind it, served from L1/L2.  No
// shared-memory tile yet.

#include "stencil_taps.cuh"

namespace {

constexpr int BX = 32, BY = 8, ZRUN = 8;

template <int KIND, class T>
__global__ void __launch_bounds__(BX * BY)
zchunk_heat(const T* __restrict__ p, T* __restrict__ out, int Z, int Y,
            int X, Coef c) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= X || y >= Y) return;
  constexpr int h = kind_halo(KIND);
  const long sy = X + 2 * h, sz = sy * (Y + 2 * h);
  const long oy = X, oz = static_cast<long>(X) * Y;
  const int z0 = blockIdx.z * ZRUN;
  const int z1 = min(z0 + ZRUN, Z);
  for (int z = z0; z < z1; ++z) {
    const T* q = p + (z + h) * sz + (y + h) * sy + (x + h);
    out[z * oz + y * oy + x] = narrow<T>(heat_update<KIND>(q, sy, sz, c));
  }
}

template <class T>
__global__ void __launch_bounds__(BX * BY)
zchunk_wave(const T* __restrict__ p, const T* __restrict__ uprev,
            T* __restrict__ out, int Z, int Y, int X, Coef c) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= X || y >= Y) return;
  const long sy = X + 2, sz = sy * (Y + 2);
  const long oy = X, oz = static_cast<long>(X) * Y;
  const int z0 = blockIdx.z * ZRUN;
  const int z1 = min(z0 + ZRUN, Z);
  for (int z = z0; z < z1; ++z) {
    const long i = z * oz + y * oy + x;
    const T* q = p + (z + 1) * sz + (y + 1) * sy + (x + 1);
    out[i] = narrow<T>(wave_update(q, widen(uprev[i]), sy, sz, c));
  }
}

dim3 grid_for(int Z, int Y, int X) {
  return dim3((X + BX - 1) / BX, (Y + BY - 1) / BY, (Z + ZRUN - 1) / ZRUN);
}

template <class T>
int launch_heat(int kind, const T* p, T* out, int Z, int Y, int X,
                const Coef& c, void* stream) {
  const dim3 block(BX, BY, 1), grid = grid_for(Z, Y, X);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT7:
      zchunk_heat<HEAT7><<<grid, block, 0, s>>>(p, out, Z, Y, X, c);
      break;
    case HEAT27:
      zchunk_heat<HEAT27><<<grid, block, 0, s>>>(p, out, Z, Y, X, c);
      break;
    case HEAT13:
      zchunk_heat<HEAT13><<<grid, block, 0, s>>>(p, out, Z, Y, X, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_wave(const T* p, const T* uprev, T* out, int Z, int Y, int X,
                float c2dt2, void* stream) {
  const Coef c{c2dt2, 0.f, 0.f, 0.f, 0.f};
  zchunk_wave<<<grid_for(Z, Y, X), dim3(BX, BY, 1), 0,
                static_cast<cudaStream_t>(stream)>>>(p, uprev, out, Z, Y, X,
                                                     c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One K4 launch on `stream`: out (Z, Y, X) = update of the padded p.
// Returns cudaGetLastError().  Each export has a _bf16 twin on bfloat16
// operands.
EXPORT int zchunk_heat_f32(int kind, const float* p, float* out, int Z, int Y,
                           int X, float a, float c0, float c1, float c2,
                           float c3, void* stream) {
  return launch_heat(kind, p, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, stream);
}

EXPORT int zchunk_heat_bf16(int kind, const __nv_bfloat16* p,
                            __nv_bfloat16* out, int Z, int Y, int X, float a,
                            float c0, float c1, float c2, float c3,
                            void* stream) {
  return launch_heat(kind, p, out, Z, Y, X, Coef{a, c0, c1, c2, c3}, stream);
}

// One K5 launch on `stream`: out = new u from the padded u and the
// unpadded u_prev.  Returns cudaGetLastError().
EXPORT int zchunk_wave_f32(const float* p, const float* uprev, float* out,
                           int Z, int Y, int X, float c2dt2, void* stream) {
  return launch_wave(p, uprev, out, Z, Y, X, c2dt2, stream);
}

EXPORT int zchunk_wave_bf16(const __nv_bfloat16* p,
                            const __nv_bfloat16* uprev, __nv_bfloat16* out,
                            int Z, int Y, int X, float c2dt2, void* stream) {
  return launch_wave(p, uprev, out, Z, Y, X, c2dt2, stream);
}
