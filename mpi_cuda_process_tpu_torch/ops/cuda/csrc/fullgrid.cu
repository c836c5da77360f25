// K8: k 2D steps (heat2d / mdf, wave2d, life, advect2d, grayscott2d,
// sor2d) per device-memory pass.  Two kinds:
//
//   * guard-frame launches (every launch of the main path) run ring.cuh's
//     streaming kernel with the 2D kinds: a block owns a TX-wide strip of
//     a chunk of CZ rows and marches it down the rows as a wavefront of k
//     levels (2k half-sweeps for SOR), one ring of rows a level, so no y
//     margin is recomputed (the chunk's 2m lead-in rows aside) and the x
//     margin is 2 e_s of TX + 2 e_s cells; a thread keeps its cells'
//     column values (the rows above and below) in registers and reads the
//     newest row and its x neighbours from shared memory, 3 reads an update
//     where the tiled kind reads 5 (Life: 7, not 9); interior strips copy
//     rows in 16-byte cp.async units, two rows in flight, and skip the x
//     frame test.  Its chunks give the card >= 2 waves of blocks at 16384^2.
//     Below: the exports fullgrid_ring_raw / fullgrid_ring_padded (a row
//     shard's padded block is ZSLAB's layout with Y = 1: the core rows
//     between their two m-row slabs, one operand);
//   * periodic launches, and a k whose levels outnumber a block's warps,
//     run the tiled kernel below, fullgrid_step<KIND, SRC>: overlapped
//     tiling in shared memory.
//
// The tiled kernel, fullgrid_step<KIND, SRC>:
//
// Replaces: the TPU package's ops/pallas/fullgrid.py — _build_call's
// kernel with the _micro_life micro-step and the _MICRO2D entries for
// heat2d, mdf (fused._micro_heat), wave2d (fused._micro_wave), advect2d
// (fused._micro_advect), grayscott2d (fused._micro_grayscott) and sor2d
// (fused._micro_sor).  There
// the whole grid (or a shard's whole padded block) sits in VMEM and one
// program runs the k micro-steps on it.  That does not carry over: 512^2
// float32 is 1 MiB against 227 KB of shared memory per block.  So this is
// the 2D counterpart of K3 (fused.cu): each block loads an overlapped
// window, steps it k times and writes its core.  A window-source policy
// says where each window cell is read from:
//
//   RAW     the whole (H, W) grid; out-of-domain cells wrap (periodic) or
//           clamp.  --fuse on one device.
//   PADDED  a row-split shard's padded block (Ly+2m, W) from the width-m
//           row exchange; rows come from the pad, x wraps or clamps.
//           --fuse under --mesh.
//
// The frame is pinned on GLOBAL coordinates, oy + local row, against the
// global extent (GH, W), every micro-step: a window cell past a global wall
// is frame (its value only ever feeds other pinned cells), a cell past an
// interior shard face holds the neighbour's rows and updates like any
// other.  Periodic runs pin nothing.
//
// Bound on an H100: device-memory bytes.  One pass reads each field once
// and writes it once for k steps.  What the design pays for that: each
// block of (TY, TX) core cells loads a (TY+2m, TX+2m) window (m = k; 2k
// for SOR), the overlap served mostly from L2, and recomputes the
// shrinking margin every micro-step (1.9x the useful cells in the first
// micro-step at k = 8).
//
// Per block:
//   1. load the window of every field into dynamic shared memory;
//   2. k micro-steps, micro-step s updating the cells at least s from the
//      window edge, frame re-pinned, __syncthreads() between steps.  Heat,
//      advection and Life ping-pong between two buffers; wave writes its
//      new u over u_prev in place (each cell reads u_prev only at itself)
//      and swaps roles, so the old u becomes the new u_prev for free;
//      Gray-Scott reads both fields' neighbours and ping-pongs two pairs
//      (four buffers: 96 KB at k = 16).  Red-black SOR runs 2k one-colour
//      half-sweeps (m = 2k): sweep s relaxes colour (s-1) % 2 of the
//      GLOBAL coordinate sum, oy + local row + column, with heat's 5-point
//      taps and copies the other colour, frame re-pinned after each;
//   3. write the (TY, TX) core, masked to the block.
// Threads are laid out (32, 8) over (x, y) and stride over the window by
// rows and columns, so no index division is needed.
//
// Exactness: the updates are stencil2d.cuh's, in the plain version's order,
// so k micro-steps equal k plain steps bit for bit (Life exactly, being
// integer).
//
// Storage type T: float32 or bfloat16 for the float kinds (the windows,
// the operands and the outputs), int32 for Life.  The bfloat16 arithmetic
// rounds to bfloat16 after every op as the plain version does, so every
// level of a window is exact in T and is kept in T: the windows take half
// the shared memory (Gray-Scott's four buffers at K_PER_LAUNCH = 16: 96 KB
// in float32, 48 KB in bfloat16) and the kernel stays bit-equal to the
// plain version on bfloat16 tensors.

#include "ring.cuh"

namespace {

constexpr int BX = 32, BY = 8;

// Where a launch's operands live and where its core block sits.
struct Grid2 {
  const void* in[2];  // RAW: the (H, W) grid; PADDED: the (H+2m, W) block
  void* out[2];       // (H, W)
  int H, W;           // core (output) extent; x is never split, so W is global
  int GH;             // global row count: the frame
  int oy;             // global row of the core's first row
  int m;              // PADDED: pad rows on each side
  // a batched launch's member strides in cells (the launch grid's z is
  // the member), 0 for one member
  long s_in, s_out;
};

// Field f at local core coordinate (y, x), which may lie outside the core
// (any value where the source has none: such cells are pinned or never
// reach the core).
template <int SRC, typename T>
__device__ __forceinline__ T load(const Grid2& g, int f, int y, int x,
                                  int periodic) {
  const T* in = static_cast<const T*>(g.in[f]) + blockIdx.z * g.s_in;
  x = wrap_or_clamp2(x, g.W, periodic);
  if constexpr (SRC == RAW) {
    y = wrap_or_clamp2(y, g.H, periodic);
  } else {
    y = y + g.m;
    y = y < 0 ? 0 : (y >= g.H + 2 * g.m ? g.H + 2 * g.m - 1 : y);
  }
  return in[static_cast<long>(y) * g.W + x];
}

// Window buffers a kind keeps in shared memory (fullgrid.py::smem_bytes).
__host__ __device__ constexpr int kind_buffers2(int kind) {
  return kind == GRAYSCOTT2D ? 4 : 2;
}

// One block: one (TY, TX) core tile of member blockIdx.z (1 unbatched).
template <int KIND, int SRC, class T>
__global__ void __launch_bounds__(BX * BY)
fullgrid_step(const Grid2 g, int k, int periodic, Coef c, int TY, int TX) {
  constexpr bool wave = KIND == WAVE5, gs = KIND == GRAYSCOTT2D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = k * kind_phases2(KIND);  // every 2D family has halo 1
  const int WY = TY + 2 * m, WX = TX + 2 * m;
  T* cur = reinterpret_cast<T*>(smem_raw);  // heat/life/advect/GS u: level;
                                            // wave: u
  T* nxt = cur + WY * WX;                   // next level; wave: u_prev
  T* vcur = nxt + WY * WX;                  // Gray-Scott v: level
  T* vnxt = vcur + WY * WX;                 // Gray-Scott v: next level
  // local coordinate of window cell (0, 0)
  const int oy = blockIdx.y * TY - m, ox = blockIdx.x * TX - m;

  for (int wy = threadIdx.y; wy < WY; wy += BY) {
    for (int wx = threadIdx.x; wx < WX; wx += BX) {
      cur[wy * WX + wx] = load<SRC, T>(g, 0, oy + wy, ox + wx, periodic);
      if constexpr (wave)
        nxt[wy * WX + wx] = load<SRC, T>(g, 1, oy + wy, ox + wx, periodic);
      if constexpr (gs)
        vcur[wy * WX + wx] = load<SRC, T>(g, 1, oy + wy, ox + wx, periodic);
    }
  }
  __syncthreads();

  for (int s = 1; s <= m; ++s) {
    for (int wy = s + threadIdx.y; wy < WY - s; wy += BY) {
      const int gy = g.oy + oy + wy;
      const bool frame_row = gy < 1 || gy >= g.GH - 1;
      for (int wx = s + threadIdx.x; wx < WX - s; wx += BX) {
        const int q = wy * WX + wx;
        const int gx = ox + wx;
        const bool frame = !periodic && (frame_row || gx < 1 || gx >= g.W - 1);
        if constexpr (KIND == SOR5) {
          nxt[q] = frame || other_colour(gy + gx, s)
                       ? cur[q]
                       : narrow<T>(heat5(cur + q, WX, c.a));
        } else if constexpr (KIND == WAVE5) {
          nxt[q] = frame ? cur[q]
                         : narrow<T>(wave5(cur + q, widen(nxt[q]), WX, c.a));
        } else if constexpr (KIND == LIFE) {
          nxt[q] = frame ? cur[q] : life8(cur + q, WX);
        } else if constexpr (KIND == ADVECT2D) {
          nxt[q] = frame ? cur[q] : narrow<T>(advect5(cur + q, WX, c.a, c.c0));
        } else if constexpr (gs) {
          if (frame) {
            nxt[q] = cur[q];
            vnxt[q] = vcur[q];
          } else {
            float nu, nv;
            grayscott5(cur + q, vcur + q, WX, c, nu, nv);
            nxt[q] = narrow<T>(nu);
            vnxt[q] = narrow<T>(nv);
          }
        } else {
          nxt[q] = frame ? cur[q] : narrow<T>(heat5(cur + q, WX, c.a));
        }
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if constexpr (gs) {
      tmp = vcur;
      vcur = vnxt;
      vnxt = tmp;
    }
  }

  T* out0 = static_cast<T*>(g.out[0]) + blockIdx.z * g.s_out;
  T* out1 = static_cast<T*>(g.out[1]) + blockIdx.z * g.s_out;
  for (int cy = threadIdx.y; cy < TY; cy += BY) {
    const int y = oy + m + cy;
    if (y >= g.H) break;
    for (int cx = threadIdx.x; cx < TX; cx += BX) {
      const int x = ox + m + cx;
      if (x >= g.W) break;
      const long o = static_cast<long>(y) * g.W + x;
      const int q = (cy + m) * WX + cx + m;
      out0[o] = cur[q];
      if constexpr (wave) out1[o] = nxt[q];  // the new u_prev: the previous u
      if constexpr (gs) out1[o] = vcur[q];
    }
  }
}

template <int KIND, int SRC, class T>
int launch(const Grid2& g, int k, int periodic, const Coef& c, int ty, int tx,
           int members, cudaStream_t s) {
  const int m = k * kind_phases2(KIND);
  const size_t smem = kind_buffers2(KIND) * sizeof(T) *
                      static_cast<size_t>(ty + 2 * m) * (tx + 2 * m);
  cudaError_t e = cudaFuncSetAttribute(
      fullgrid_step<KIND, SRC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (members < 1 || members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.W + tx - 1) / tx, (g.H + ty - 1) / ty, members);
  fullgrid_step<KIND, SRC, T><<<grid, dim3(BX, BY, 1), smem, s>>>(
      g, k, periodic, c, ty, tx);
  return static_cast<int>(cudaGetLastError());
}

// The float kinds on storage type T (float or __nv_bfloat16); Life (int32)
// rides with the 4-byte type.
template <int SRC, class T>
int dispatch(int kind, Grid2 g, int k, int periodic, const Coef& c, int ty,
             int tx, int members, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (members > 1) {
    g.s_in = static_cast<long>(g.H + 2 * g.m) * g.W;
    g.s_out = static_cast<long>(g.H) * g.W;
  }
  switch (kind) {
    case HEAT5:
      return launch<HEAT5, SRC, T>(g, k, periodic, c, ty, tx, members, s);
    case WAVE5:
      return launch<WAVE5, SRC, T>(g, k, periodic, c, ty, tx, members, s);
    case ADVECT2D:
      return launch<ADVECT2D, SRC, T>(g, k, periodic, c, ty, tx, members, s);
    case GRAYSCOTT2D:
      return launch<GRAYSCOTT2D, SRC, T>(g, k, periodic, c, ty, tx, members, s);
    case SOR5:
      return launch<SOR5, SRC, T>(g, k, periodic, c, ty, tx, members, s);
    case LIFE:
      if constexpr (sizeof(T) == 4) {
        return launch<LIFE, SRC, int>(g, k, periodic, c, ty, tx, members, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One K8 launch on `stream`, one device: (out0[, out1]) = k steps of
// (in0[, in1]) on the whole (H, W) grid; in1/out1 are used by the two-field
// kinds only (WAVE5: u_prev; GRAYSCOTT2D: v).  (a, c0, c1, c2, c3) are the
// kind's Coef: alpha (HEAT5), omega / 4 (SOR5), c2dt2 (WAVE5), the Courant
// numbers (cy, cx) (ADVECT2D) or (Du, Dv, F, F + kappa) (GRAYSCOTT2D).
// Float32 operands, or int32 for LIFE; the _bf16 twin takes the float kinds
// on bfloat16 operands.  Returns a cudaError_t code.
EXPORT int fullgrid_raw(int kind, const void* in0, const void* in1,
                        void* out0, void* out1, int H, int W, int k,
                        int periodic, float a, float c0, float c1, float c2,
                        float c3, int ty, int tx, int members,
                        void* stream) {
  const Grid2 g{{in0, in1}, {out0, out1}, H, W, H, 0, 0};
  return dispatch<RAW, float>(kind, g, k, periodic, Coef{a, c0, c1, c2, c3},
                              ty, tx, members, stream);
}

EXPORT int fullgrid_raw_bf16(int kind, const void* in0, const void* in1,
                             void* out0, void* out1, int H, int W, int k,
                             int periodic, float a, float c0, float c1,
                             float c2, float c3, int ty, int tx, int members,
                             void* stream) {
  const Grid2 g{{in0, in1}, {out0, out1}, H, W, H, 0, 0};
  return dispatch<RAW, __nv_bfloat16>(kind, g, k, periodic,
                                      Coef{a, c0, c1, c2, c3}, ty, tx,
                                      members, stream);
}

// One K8 launch in its sharded mode: the inputs are a row shard's padded
// (Ly+2m, W) blocks with m = k * phases (2k for SOR5, else k), the outputs
// its (Ly, W) core k steps on; the core's first row is global row oy of a
// GH-row grid.  Operand types as fullgrid_raw's; a _bf16 twin.
EXPORT int fullgrid_padded(int kind, const void* in0, const void* in1,
                           void* out0, void* out1, int Ly, int W, int GH,
                           int oy, int k, int periodic, float a, float c0,
                           float c1, float c2, float c3, int ty, int tx,
                           int members, void* stream) {
  const Grid2 g{{in0, in1}, {out0, out1}, Ly, W, GH, oy,
                k * kind_phases2(kind)};
  return dispatch<PADDED, float>(kind, g, k, periodic,
                                 Coef{a, c0, c1, c2, c3}, ty, tx, members,
                                 stream);
}

EXPORT int fullgrid_padded_bf16(int kind, const void* in0, const void* in1,
                                void* out0, void* out1, int Ly, int W, int GH,
                                int oy, int k, int periodic, float a,
                                float c0, float c1, float c2, float c3,
                                int ty, int tx, int members, void* stream) {
  const Grid2 g{{in0, in1}, {out0, out1}, Ly, W, GH, oy,
                k * kind_phases2(kind)};
  return dispatch<PADDED, __nv_bfloat16>(kind, g, k, periodic,
                                         Coef{a, c0, c1, c2, c3}, ty, tx,
                                         members, stream);
}

// The streaming kind (ring.cuh) of the guard-frame launches: the same
// operands as fullgrid_raw / fullgrid_padded, then the launch's tile: the
// strip width tx, the rows of a chunk cz, the block's threads and blocks
// an SM (1 or 2: ring.cuh's builds), the ring slots (s0: level 0, s1:
// levels 1..K-1; streamfused.py::ring_slots) and `paths` (bit 0: 16-byte
// row copies, set only where every operand's address is 16-byte aligned;
// bit 1: no x frame test where no updated cell is frame).  Float32
// operands, or int32 for LIFE; the _bf16 twins take the float kinds on
// bfloat16 operands.  Returns a cudaError_t code.
namespace {

template <int SRC, class T>
int ring_dispatch(int kind, const WindowT<T>& w, int k, const Coef& c,
                  int tx, int cz, int threads, int blocks, int s0, int s1,
                  int paths, int members, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RING2_LAUNCH(K, U)                                                   \
  ring::launch<K, SRC, U>(reinterpret_cast<const WindowT<U>&>(w), k, c, 1, \
                          tx, cz, threads, blocks, s0, s1, paths, s,        \
                          members)
  switch (kind) {
    case HEAT5:
      return RING2_LAUNCH(HEAT5, T);
    case WAVE5:
      return RING2_LAUNCH(WAVE5, T);
    case ADVECT2D:
      return RING2_LAUNCH(ADVECT2D, T);
    case GRAYSCOTT2D:
      return RING2_LAUNCH(GRAYSCOTT2D, T);
    case SOR5:
      return RING2_LAUNCH(SOR5, T);
    case LIFE:
      if constexpr (sizeof(T) == 4) return RING2_LAUNCH(LIFE, int);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RING2_LAUNCH
}

// The whole (H, W) grid: RAW with one y row.
template <class T>
int ring_raw(int kind, const void* in0, const void* in1, void* out0,
             void* out1, int H, int W, int k, const Coef& c, int tx, int cz,
             int threads, int blocks, int s0, int s1, int paths, int members,
             void* stream) {
  WindowT<T> w{{static_cast<const T*>(in0), static_cast<const T*>(in1)},
               {nullptr, nullptr}, {nullptr, nullptr},
               {static_cast<T*>(out0), static_cast<T*>(out1)},
               H, 1, W, H, 1, W, 0, 0, 0};
  set_member_strides<RAW>(w, members);
  return ring_dispatch<RAW>(kind, w, k, c, tx, cz, threads, blocks, s0, s1,
                            paths, members, stream);
}

// A row shard's padded (Ly + 2m, W) block: ZSLAB with one y row, the m
// rows above and below the core as its two slabs.
template <class T>
int ring_padded(int kind, const void* in0, const void* in1, void* out0,
                void* out1, int Ly, int W, int GH, int oy, int k,
                const Coef& c, int tx, int cz, int threads, int blocks,
                int s0, int s1, int paths, int members, void* stream) {
  const int m = k * kind_phases2(kind);
  const T* p0 = static_cast<const T*>(in0);
  const T* p1 = static_cast<const T*>(in1);
  const long rows = static_cast<long>(m) * W, core = static_cast<long>(Ly) * W;
  WindowT<T> w{{p0 + rows, p1 ? p1 + rows : nullptr},
               {p0, p1},
               {p0 + rows + core, p1 ? p1 + rows + core : nullptr},
               {static_cast<T*>(out0), static_cast<T*>(out1)},
               Ly, 1, W, GH, 1, W, oy, 0, m};
  if (members > 1) {
    // the core and both slabs are rows of one padded block a member
    w.s_in = w.s_zs = core + 2 * rows;
    w.s_out = core;
  }
  return ring_dispatch<ZSLAB>(kind, w, k, c, tx, cz, threads, blocks, s0, s1,
                              paths, members, stream);
}

}  // namespace

EXPORT int fullgrid_ring_raw(int kind, const void* in0, const void* in1,
                             void* out0, void* out1, int H, int W, int k,
                             float a, float c0, float c1, float c2, float c3,
                             int tx, int cz, int threads, int blocks, int s0,
                             int s1, int paths, int members, void* stream) {
  return ring_raw<float>(kind, in0, in1, out0, out1, H, W, k,
                         Coef{a, c0, c1, c2, c3}, tx, cz, threads, blocks,
                         s0, s1, paths, members, stream);
}

EXPORT int fullgrid_ring_raw_bf16(int kind, const void* in0, const void* in1,
                                  void* out0, void* out1, int H, int W, int k,
                                  float a, float c0, float c1, float c2,
                                  float c3, int tx, int cz, int threads,
                                  int blocks, int s0, int s1, int paths,
                                  int members, void* stream) {
  return ring_raw<__nv_bfloat16>(kind, in0, in1, out0, out1, H, W, k,
                                 Coef{a, c0, c1, c2, c3}, tx, cz, threads,
                                 blocks, s0, s1, paths, members, stream);
}

EXPORT int fullgrid_ring_padded(int kind, const void* in0, const void* in1,
                                void* out0, void* out1, int Ly, int W, int GH,
                                int oy, int k, float a, float c0, float c1,
                                float c2, float c3, int tx, int cz,
                                int threads, int blocks, int s0, int s1,
                                int paths, int members, void* stream) {
  return ring_padded<float>(kind, in0, in1, out0, out1, Ly, W, GH, oy, k,
                            Coef{a, c0, c1, c2, c3}, tx, cz, threads, blocks,
                            s0, s1, paths, members, stream);
}

EXPORT int fullgrid_ring_padded_bf16(int kind, const void* in0,
                                     const void* in1, void* out0, void* out1,
                                     int Ly, int W, int GH, int oy, int k,
                                     float a, float c0, float c1, float c2,
                                     float c3, int tx, int cz, int threads,
                                     int blocks, int s0, int s1, int paths,
                                     int members, void* stream) {
  return ring_padded<__nv_bfloat16>(kind, in0, in1, out0, out1, Ly, W, GH,
                                    oy, k, Coef{a, c0, c1, c2, c3}, tx, cz,
                                    threads, blocks, s0, s1, paths, members,
                                    stream);
}
