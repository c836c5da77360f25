// K3 fused_step<KIND, SRC>, K6 (the same template, SRC = ZSLAB) and K9
// (SRC = YZSLAB): k guard-frame (or periodic) steps per device-memory pass,
// by overlapped tiling in shared memory.
//
// Replaces: the TPU package's ops/pallas/fused.py — build_fused_call's
// _fused_kernel (padded 4-block windows, unsharded and sharded_global mode)
// and _fused_raw_kernel (pad-free 9-block windows), build_zslab_padfree_call's
// _fused_zslab_kernel (K6), build_yzslab_padfree_call's _fused_yzslab_kernel
// with _assemble_yz_window and _yzslab_specs (K9), their _run_micros /
// _window_frame, and the
// micro-steps _micro_heat, _micro_heat3d27, _micro_heat3d4th, _micro_wave,
// _micro_sor, _micro_advect and _micro_grayscott, every one for every window
// source.  On the TPU the
// kernels differ in how a VMEM window is assembled from aligned BlockSpecs;
// here one kernel computes its own
// window from local coordinates, and a window-source policy (window.cuh)
// says where each window cell is read from: RAW for --fuse on one device
// (auto, tiled and padfree), PADDED for --fuse under --mesh (the
// sharded_global mode), ZSLAB for --fuse --fuse-kind padfree under a z-only
// --mesh and YZSLAB under a --mesh that shards y (the exchanged slabs and,
// for YZSLAB, the two-pass composed corner pieces as separate operands, so
// no padded copy of the block exists).
//
// Where a window cell is read from is decided once per window cell, in the
// load; the micro-steps are the same code for every source, so K9 stays
// bit-equal to its plain version as K3 and K6 are.
//
// The frame is pinned on GLOBAL coordinates, (oz, oy) + local, against the
// global extent (GZ, GY, GX): a window cell past a global wall is frame
// (pinned every micro-step; its value only ever feeds other pinned cells),
// while a cell past an interior shard face holds real neighbour data and is
// updated like any other.  RAW passes origin 0 and the grid's own extent.
//
// Bound on an H100: device-memory bytes.  One pass reads each field once
// and writes it once for k steps, so the bytes per step fall k-fold against
// the one-step kernels (K1/K2, K4/K5).  What the design pays for that: each
// block of (TZ, TY, TX) core cells loads a (TZ+2m, TY+2m, TX+2m) window
// (m = k*halo) — neighbouring windows overlap, and the overlap is served
// mostly from L2 — and recomputes the shrinking margin in every micro-step
// (about 2x the useful flops at core (8, 8, 32), k = 4), which the float32
// units have the headroom for at 7 to 27 points.
//
// Per block:
//   1. load the window of every field into dynamic shared memory from its
//      source;
//   2. apply k micro-steps in shared memory, micro-step s updating the
//      cells at least s*halo from the window edge, re-pinning the global
//      guard frame (ghost cells included), __syncthreads() between steps.
//      Red-black SOR runs 2k one-colour half-sweeps of halo 1 instead
//      (m = 2k): sweep j relaxes colour (j-1) % 2 of the GLOBAL coordinate
//      sum with heat's 7-point taps and leaves the other colour, frame
//      re-pinned after each, as _micro_sor does.  It relaxes in place in
//      one buffer: a half-sweep writes only cells of its colour and reads
//      only the cell itself and its face neighbours, all of the other
//      colour, which it leaves — so the window may be twice as large;
//      Heat and advection ping-pong between two buffers.  Wave writes the
//      new u into u_prev's buffer in place (each cell reads u_prev only at
//      itself) and then swaps roles, so the old u becomes the new u_prev
//      for free.  Gray-Scott reads both fields' neighbours, so neither can
//      be overwritten in place: it ping-pongs two pairs, four buffers;
//   3. write the (TZ, TY, TX) core (the cells at least m from the window
//      edge, all valid after k micro-steps), masked to the block.
//
// Storage type T: float32, or bfloat16 (the windows, the operands and the
// outputs).  The arithmetic is stencil_taps.cuh's, rounded to bfloat16
// after every op as the plain version rounds it, so every level of a
// window is exact in T and is kept in T: the bfloat16 kernels stay bit-equal
// to the plain version on bfloat16 tensors, and their windows take half the
// shared memory.  Cells are read with plain loads (window.cuh::cell_ptr),
// so a clamped 2-byte row needs no 4-byte alignment.
//
// Shared memory is 2 buffers (Gray-Scott: 4; SOR: 1) x window x sizeof(T):
// 80 KB (160 KB) for core (8, 8, 32) at m = 4 in float32; in bfloat16 the
// window alignment (2m a multiple of 16, fused.py::margin_of) asks for
// m = 8, where Gray-Scott's four buffers take 221,184 B (SOR at k = 4,
// m = 8, one buffer of its core, fused.py::core_of: at most 196 KB in
// float32), one block per SM, so the launch raises the kernel's dynamic
// shared-memory limit above the 48 KB default first (cudaFuncSetAttribute).


#include "window.cuh"

namespace {

constexpr int THREADS = 256;

// Window buffers a kind keeps in shared memory (fused.py::buffers).
__host__ __device__ constexpr int kind_buffers(int kind) {
  return kind == GRAYSCOTT ? 4 : (kind == SOR7 ? 1 : 2);
}

template <int KIND, int SRC, class T>
__global__ void __launch_bounds__(THREADS)
fused_step(const WindowT<T> w, int k, int periodic, Coef c, int TZ, int TY,
           int TX) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  constexpr int h = kind_halo(KIND);
  constexpr bool wave = KIND == WAVE7, gs = KIND == GRAYSCOTT,
                 sor = KIND == SOR7;
  const int m = kind_margin(KIND, k);
  const int WZ = TZ + 2 * m, WY = TY + 2 * m, WX = TX + 2 * m;
  const int W = WZ * WY * WX;
  const long sy = WX, sz = static_cast<long>(WX) * WY;
  // local coordinate of window cell (0, 0, 0)
  const int oz = blockIdx.z * TZ - m, oy = blockIdx.y * TY - m,
            ox = blockIdx.x * TX - m;

  T* cur = smem;  // heat, advection, Gray-Scott u: current level;
                  // wave: u; SOR: the one buffer it relaxes in place
  T* nxt = sor ? smem : smem + W;  // heat, advection, Gray-Scott u: next
                                   // level; wave: u_prev
  T* vcur = smem + 2 * W;  // Gray-Scott v: current level
  T* vnxt = smem + 3 * W;  // Gray-Scott v: next level

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int wx = i % WX, t = i / WX, wy = t % WY, wz = t / WY;
    const int z = oz + wz, y = oy + wy, x = ox + wx;
    cur[i] = *cell_ptr<SRC>(w, 0, z, y, x, periodic);
    if constexpr (wave) nxt[i] = *cell_ptr<SRC>(w, 1, z, y, x, periodic);
    if constexpr (gs) vcur[i] = *cell_ptr<SRC>(w, 1, z, y, x, periodic);
  }
  __syncthreads();

  for (int s = 1; s <= k * kind_phases(KIND); ++s) {
    const int lo = s * h;
    const int RZ = WZ - 2 * lo, RY = WY - 2 * lo, RX = WX - 2 * lo;
    const int R = RZ * RY * RX;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      const int rx = i % RX, t = i / RX, ry = t % RY, rz = t / RY;
      const int wz = rz + lo, wy = ry + lo, wx = rx + lo;
      const long q = wz * sz + wy * sy + wx;
      const int gz = w.oz + oz + wz, gy = w.oy + oy + wy, gx = ox + wx;
      // keep: the cell copies its previous level (a frame cell, or one of
      // the colour SOR's sweep s leaves)
      bool keep = !periodic && in_frame(gz, gy, gx, w.GZ, w.GY, w.GX, h);
      if constexpr (sor) keep = keep || other_colour(gz + gy + gx, s);
      if constexpr (wave) {
        nxt[q] = keep ? cur[q]
                      : narrow<T>(wave_update(cur + q, widen(nxt[q]), sy, sz,
                                              c));
      } else if constexpr (gs) {
        if (keep) {
          nxt[q] = cur[q];
          vnxt[q] = vcur[q];
        } else {
          float nu, nv;
          grayscott_update(cur + q, vcur + q, sy, sz, c, nu, nv);
          nxt[q] = narrow<T>(nu);
          vnxt[q] = narrow<T>(nv);
        }
      } else if constexpr (sor) {
        if (!keep) cur[q] = narrow<T>(field_update<KIND>(cur + q, sy, sz, c));
      } else {
        nxt[q] = keep ? cur[q]
                      : narrow<T>(field_update<KIND>(cur + q, sy, sz, c));
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

  const int C = TZ * TY * TX;
  const long gsy = w.X, gsz = static_cast<long>(w.X) * w.Y;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int cx = i % TX, t = i / TX, cy = t % TY, cz = t / TY;
    const int gz = oz + m + cz, gy = oy + m + cy, gx = ox + m + cx;
    if (gz >= w.Z || gy >= w.Y || gx >= w.X) continue;
    const long g = gz * gsz + gy * gsy + gx;
    const long q = (cz + m) * sz + (cy + m) * sy + (cx + m);
    w.out[0][g] = cur[q];
    if constexpr (wave) w.out[1][g] = nxt[q];  // the new u_prev: the previous u
    if constexpr (gs) w.out[1][g] = vcur[q];
  }
}

template <int KIND, int SRC, class T>
int launch(const WindowT<T>& w, int k, int periodic, const Coef& c, int tz,
           int ty, int tx, cudaStream_t s) {
  const int m = kind_margin(KIND, k);
  const size_t smem = kind_buffers(KIND) * sizeof(T) *
                      static_cast<size_t>(tz + 2 * m) * (ty + 2 * m) *
                      (tx + 2 * m);
  cudaError_t e = cudaFuncSetAttribute(
      fused_step<KIND, SRC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w.X + tx - 1) / tx, (w.Y + ty - 1) / ty,
                  (w.Z + tz - 1) / tz);
  fused_step<KIND, SRC, T><<<grid, THREADS, smem, s>>>(w, k, periodic, c, tz,
                                                       ty, tx);
  return static_cast<int>(cudaGetLastError());
}

template <int SRC, class T>
int dispatch(int kind, const WindowT<T>& w, int k, int periodic,
             const Coef& c, int tz, int ty, int tx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT7:
      return launch<HEAT7, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case HEAT27:
      return launch<HEAT27, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case HEAT13:
      return launch<HEAT13, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case WAVE7:
      return launch<WAVE7, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case SOR7:
      return launch<SOR7, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case ADVECT:
      return launch<ADVECT, SRC>(w, k, periodic, c, tz, ty, tx, s);
    case GRAYSCOTT:
      return launch<GRAYSCOTT, SRC>(w, k, periodic, c, tz, ty, tx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The four launches below, on storage type T.
template <class T>
int fused_raw(int kind, const T* in0, const T* in1, T* out0, T* out1, int Z,
              int Y, int X, int k, int periodic, const Coef& c, int tz,
              int ty, int tx, void* stream) {
  const WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
                     {out0, out1}, Z, Y, X, Z, Y, X, 0, 0, 0};
  return dispatch<RAW>(kind, w, k, periodic, c, tz, ty, tx, stream);
}

template <class T>
int fused_padded(int kind, const T* in0, const T* in1, T* out0, T* out1,
                 int Z, int Y, int X, int GZ, int GY, int GX, int oz, int oy,
                 int k, int periodic, const Coef& c, int tz, int ty, int tx,
                 void* stream) {
  const WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
                     {out0, out1}, Z, Y, X, GZ, GY, GX, oz, oy,
                     kind_margin(kind, k)};
  return dispatch<PADDED>(kind, w, k, periodic, c, tz, ty, tx, stream);
}

template <class T>
int fused_z(int kind, const T* in0, const T* in1, const T* lo0,
            const T* lo1, const T* hi0, const T* hi1, T* out0, T* out1,
            int Z, int Y, int X, int GZ, int oz, int k, int periodic,
            const Coef& c, int tz, int ty, int tx, void* stream) {
  const WindowT<T> w{{in0, in1}, {lo0, lo1}, {hi0, hi1}, {out0, out1},
                     Z, Y, X, GZ, Y, X, oz, 0, kind_margin(kind, k)};
  return dispatch<ZSLAB>(kind, w, k, periodic, c, tz, ty, tx, stream);
}

template <class T>
int fused_yz(int kind, const T* const* p, T* out0, T* out1, int Z, int Y,
             int X, int GZ, int GY, int GX, int oz, int oy, int k,
             int periodic, const Coef& c, int tz, int ty, int tx,
             void* stream) {
  // p: per field, (in, zlo, zhi, ylo, yhi, ll, lh, hl, hh) in field-major
  // pairs, as the exports take them
  const WindowT<T> w{{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}, {out0, out1},
                     Z, Y, X, GZ, GY, GX, oz, oy, kind_margin(kind, k),
                     {p[6], p[7]}, {p[8], p[9]},
                     {{p[10], p[11]}, {p[12], p[13]}, {p[14], p[15]},
                      {p[16], p[17]}}};
  return dispatch<YZSLAB>(kind, w, k, periodic, c, tz, ty, tx, stream);
}

}  // namespace

// One K3 launch on `stream`, one device: (out0[, out1]) = k steps of
// (in0[, in1]) on the whole (Z, Y, X) grid.  in1/out1 are used by the
// two-field kinds only (wave: u_prev; Gray-Scott: v).  Returns a cudaError_t
// code.  Each export has a _bf16 twin on bfloat16 operands.
EXPORT int fused_step_f32(int kind, const float* in0, const float* in1,
                          float* out0, float* out1, int Z, int Y, int X, int k,
                          int periodic, float a, float c0, float c1, float c2,
                          float c3, int tz, int ty, int tx, void* stream) {
  return fused_raw(kind, in0, in1, out0, out1, Z, Y, X, k, periodic,
                   Coef{a, c0, c1, c2, c3}, tz, ty, tx, stream);
}

EXPORT int fused_step_bf16(int kind, const __nv_bfloat16* in0,
                           const __nv_bfloat16* in1, __nv_bfloat16* out0,
                           __nv_bfloat16* out1, int Z, int Y, int X, int k,
                           int periodic, float a, float c0, float c1,
                           float c2, float c3, int tz, int ty, int tx,
                           void* stream) {
  return fused_raw(kind, in0, in1, out0, out1, Z, Y, X, k, periodic,
                   Coef{a, c0, c1, c2, c3}, tz, ty, tx, stream);
}

// One K3 launch in its sharded mode: the inputs are a shard's z/y-padded
// (Z+2m, Y+2m, X) blocks (m = kind_margin(kind, k)), the outputs its
// (Z, Y, X) core k steps on; the core's global origin is (oz, oy, 0) in a
// (GZ, GY, GX) grid.
EXPORT int fused_step_padded_f32(int kind, const float* in0, const float* in1,
                                 float* out0, float* out1, int Z, int Y, int X,
                                 int GZ, int GY, int GX, int oz, int oy, int k,
                                 int periodic, float a, float c0, float c1,
                                 float c2, float c3, int tz, int ty, int tx,
                                 void* stream) {
  return fused_padded(kind, in0, in1, out0, out1, Z, Y, X, GZ, GY, GX, oz,
                      oy, k, periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx,
                      stream);
}

EXPORT int fused_step_padded_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    __nv_bfloat16* out0, __nv_bfloat16* out1, int Z, int Y, int X, int GZ,
    int GY, int GX, int oz, int oy, int k, int periodic, float a, float c0,
    float c1, float c2, float c3, int tz, int ty, int tx, void* stream) {
  return fused_padded(kind, in0, in1, out0, out1, Z, Y, X, GZ, GY, GX, oz,
                      oy, k, periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx,
                      stream);
}

// One K6 launch: a z-only shard's (Z, Y, X) core plus the (m, Y, X) slabs
// below (lo) and above (hi) it, k steps on; the core's global origin is
// (oz, 0, 0) in a (GZ, Y, X) grid.
EXPORT int fused_zslab_f32(int kind, const float* in0, const float* in1,
                           const float* lo0, const float* lo1,
                           const float* hi0, const float* hi1, float* out0,
                           float* out1, int Z, int Y, int X, int GZ, int oz,
                           int k, int periodic, float a, float c0, float c1,
                           float c2, float c3, int tz, int ty, int tx,
                           void* stream) {
  return fused_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X, GZ,
                 oz, k, periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx,
                 stream);
}

EXPORT int fused_zslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* lo0, const __nv_bfloat16* lo1,
    const __nv_bfloat16* hi0, const __nv_bfloat16* hi1, __nv_bfloat16* out0,
    __nv_bfloat16* out1, int Z, int Y, int X, int GZ, int oz, int k,
    int periodic, float a, float c0, float c1, float c2, float c3, int tz,
    int ty, int tx, void* stream) {
  return fused_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X, GZ,
                 oz, k, periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx,
                 stream);
}

// One K9 launch: a (z, y) shard's (Z, Y, X) core plus, per field, the
// (m, Y, X) z slabs below (zlo) and above (zhi) it, the (Z, m, X) y slabs
// before (ylo) and after (yhi) it and the four (m, m, X) corner pieces
// (ll, lh, hl, hh in (z side, y side) order), k steps on; the core's global
// origin is (oz, oy, 0) in a (GZ, GY, GX) grid.
EXPORT int fused_yzslab_f32(
    int kind, const float* in0, const float* in1, const float* zlo0,
    const float* zlo1, const float* zhi0, const float* zhi1, const float* ylo0,
    const float* ylo1, const float* yhi0, const float* yhi1, const float* cll0,
    const float* cll1, const float* clh0, const float* clh1, const float* chl0,
    const float* chl1, const float* chh0, const float* chh1, float* out0,
    float* out1, int Z, int Y, int X, int GZ, int GY, int GX, int oz, int oy,
    int k, int periodic, float a, float c0, float c1, float c2, float c3,
    int tz, int ty, int tx, void* stream) {
  const float* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1, ylo0, ylo1, yhi0,
                        yhi1, cll0, cll1, clh0, clh1, chl0, chl1, chh0, chh1};
  return fused_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                  periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx, stream);
}

EXPORT int fused_yzslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* zlo0, const __nv_bfloat16* zlo1,
    const __nv_bfloat16* zhi0, const __nv_bfloat16* zhi1,
    const __nv_bfloat16* ylo0, const __nv_bfloat16* ylo1,
    const __nv_bfloat16* yhi0, const __nv_bfloat16* yhi1,
    const __nv_bfloat16* cll0, const __nv_bfloat16* cll1,
    const __nv_bfloat16* clh0, const __nv_bfloat16* clh1,
    const __nv_bfloat16* chl0, const __nv_bfloat16* chl1,
    const __nv_bfloat16* chh0, const __nv_bfloat16* chh1,
    __nv_bfloat16* out0, __nv_bfloat16* out1, int Z, int Y, int X, int GZ,
    int GY, int GX, int oz, int oy, int k, int periodic, float a, float c0,
    float c1, float c2, float c3, int tz, int ty, int tx, void* stream) {
  const __nv_bfloat16* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1,
                                ylo0, ylo1, yhi0, yhi1, cll0, cll1,
                                clh0, clh1, chl0, chl1, chh0, chh1};
  return fused_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                  periodic, Coef{a, c0, c1, c2, c3}, tz, ty, tx, stream);
}
