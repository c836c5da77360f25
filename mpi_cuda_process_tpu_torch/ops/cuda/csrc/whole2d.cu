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
// against 6 flop (heat) or 8 integer adds (life).  Design against that
// bound: each block stages a (TY+2, BX+2) tile in shared memory with
// coalesced row loads and writes its (TY, BX) core with coalesced row
// stores, so every input cell is read from device memory about
// (TY+2)(BX+2)/(TY BX) = 1.13 times.

#include "stencil2d.cuh"

namespace {

constexpr int BX = 32, BY = 8, TY = 32;

// T: float or __nv_bfloat16 for HEAT5, int for LIFE.
template <int KIND, class T>
__global__ void __launch_bounds__(BX * BY)
whole2d(const T* __restrict__ p, T* __restrict__ out, int H, int W,
        float a) {
  // raw storage: a __shared__ array may not hold a type with a constructor
  __shared__ __align__(16) unsigned char raw[sizeof(T) * (TY + 2) * (BX + 2)];
  auto tile = reinterpret_cast<T(*)[BX + 2]>(raw);
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * TY;
  const long sp = static_cast<long>(W) + 2;
  for (int ty = threadIdx.y; ty < TY + 2; ty += BY) {
    for (int tx = threadIdx.x; tx < BX + 2; tx += BX) {
      // past the ragged edge: any padded cell (those outputs are masked)
      const int py = min(y0 + ty, H + 1), px = min(x0 + tx, W + 1);
      tile[ty][tx] = p[py * sp + px];
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < TY && y0 + ty < H; ty += BY) {
    const T* c = &tile[ty + 1][threadIdx.x + 1];
    T v;
    if constexpr (KIND == LIFE) {
      v = life8(c, BX + 2);
    } else {
      v = narrow<T>(heat5(c, BX + 2, a));
    }
    out[static_cast<long>(y0 + ty) * W + x] = v;
  }
}

template <int KIND, class T>
int launch(const void* p, void* out, int H, int W, float a, void* stream) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((W + BX - 1) / BX, (H + TY - 1) / TY, 1);
  whole2d<KIND><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<T*>(out), H, W, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One K7 launch on `stream`: out (H, W) = update of the padded p
// (H+2, W+2); `a` is alpha (HEAT5, float32) and unused by LIFE (int32).
// Returns cudaGetLastError().
EXPORT int whole2d_step(int kind, const void* p, void* out, int H, int W,
                        float a, void* stream) {
  switch (kind) {
    case HEAT5:
      return launch<HEAT5, float>(p, out, H, W, a, stream);
    case LIFE:
      return launch<LIFE, int>(p, out, H, W, a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its twin on bfloat16 operands (HEAT5 only: Life is int32).
EXPORT int whole2d_step_bf16(int kind, const void* p, void* out, int H, int W,
                             float a, void* stream) {
  if (kind != HEAT5) return static_cast<int>(cudaErrorInvalidValue);
  return launch<HEAT5, __nv_bfloat16>(p, out, H, W, a, stream);
}
