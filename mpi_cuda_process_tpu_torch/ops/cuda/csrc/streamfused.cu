// K10 stream_step<KIND, SRC>: k guard-frame steps per device-memory pass by
// a temporal wavefront that marches down z, reading each input plane of a
// block's window once per pass.
//
// Replaces: the TPU package's ops/pallas/streamfused.py — _stream_body and
// its three wrappers, make_stream_fused_step's _stream_kernel (SRC = RAW,
// the whole grid), build_stream_sharded_call's _stream_sharded_kernel
// (SRC = ZSLAB: a z-only shard's core plus its exchanged z slabs) and
// build_stream_2axis_call's _stream_2axis_kernel (SRC = YZSLAB: the core,
// z and y slabs and the four corner pieces of halo.exchange_slabs_2axis, at
// their natural widths).  The window sources are fused.cu's (window.cuh),
// so a window cell is read exactly as K3, K6 and K9 read it.
//
// The TPU kernel walks whole-X strips of y rows down z in bz-plane chunks
// through a 4-slot VMEM ring and runs k micro-steps per chunk.  A whole-X
// strip with a plane ring does not fit one block's 227 KB of shared memory
// at X = 1024, so here each block owns a (TY, TX) column of the core and
// marches it down z as a wavefront in time: level s = 1..k keeps a ring of
// 2*halo + 1 planes of its region, (TY + 2(k-s)halo, TX + 2(k-s)halo), in
// dynamic shared memory, and level 0 a ring of the loaded planes of the
// window, (TY + 2m, TX + 2m) with m = k*halo.  Each new plane of level 0
// lets every level advance by one plane (level s computes plane p - s*halo
// once level 0 holds plane p), and level k writes one output plane.  Every
// plane of the window is read from device memory once per pass; the y/x
// margin of a column is re-read by its neighbours, a read amplification of
// (1 + 2m/TY)(1 + 2m/TX) (1.69 at (16, 64), m = 4).
//
// Loads run ahead by one plane: plane p+1 is copied into level 0's ring
// with cp.async (__pipeline_memcpy_async, one slot beyond the 2*halo + 1 the
// levels read) while the levels compute on plane p.  TMA bulk copies with a
// producer warp are the later form.
//
// Storage type T: float32, or bfloat16 (the rings, the operands and the
// outputs; the arithmetic is stencil_taps.cuh's, rounded to bfloat16 after
// every op as the plain version rounds it, so a level's values are exact in
// T and its ring holds them in half the shared memory).  cp.async copies 4,
// 8 or 16 bytes, and the 2-byte cells of a bfloat16 window row are not
// 4-byte aligned where it clamps at a wall, so the bfloat16 kind copies
// plane p+1 with plain loads and stores before it computes plane p (the
// same slot, the same barrier; no overlap of the load with the compute).
//
// Red-black SOR marches 2k levels of halo 1 (m = 2k): level s relaxes the
// cells of colour (s-1) % 2 of the GLOBAL coordinate sum and copies the
// others, so the levels are SOR's one-colour half-sweeps in order, each
// re-pinning the frame, as _micro_sor does.  At the (16, 64) column and
// k = 4 the eight level rings take 183 KB of shared memory.
//
// Advection (ADVECT) is heat-shaped: halo 1, one field, the upwind taps of
// advect_update chosen by the signs of (cz, cy, cx).  Gray-Scott
// (GRAYSCOTT) reads the neighbours of both fields, so every level keeps a
// ring for u and one for v (a second set of rings after the first, 153 KB
// at the (16, 64) column and k = 4: one block per SM; 77 KB in bfloat16);
// a cell's new (u, v) is grayscott_update over the two rings.
//
// Every cell is computed by field_update<KIND> / wave_update /
// grayscott_update of stencil_taps.cuh through a ring accessor, in the
// same rounding order as the plain PyTorch version, so the kernel is
// bit-equal to it.  The frame
// is pinned on GLOBAL coordinates, (oz, oy) + local, as in fused.cu: a cell
// past a global wall is frame and copies its previous level; a cell past an
// interior shard face holds the neighbour's data and is updated.  Wave
// keeps no u_prev ring of its own past level 0: level s's u_prev is level
// s-2's u at the same cell (the loaded u_prev for s = 1), which that ring
// still holds, and the output u_prev is level k-1's u.
//
// Bound on an H100: device-memory bytes, one read and one write of each
// field per k steps, as for K3; the design removes K3's z re-reads (its
// (TZ + 2m)/TZ) and keeps the y/x margins.

#include <cuda_pipeline.h>

#include "window.cuh"

namespace {

constexpr int TXT = 32;  // threads of a block along x (one warp per row)
constexpr int TYT = 8;   // threads along y
constexpr int THREADS = TXT * TYT;

// Neighbour access into a ring of planes: the cell's address in each of
// the planes z - H .. z + H, and the row length.
template <class T, int H>
struct Ring {
  using value_type = T;
  const T* plane[2 * H + 1];
  long sy;
  __device__ __forceinline__ float operator()(int dz, int dy, int dx) const {
    return widen(plane[dz + H][dy * sy + dx]);
  }
};

// Shared memory of one block: per level s = 0..k-1 a ring of planes of the
// level's region, level 0's with one slot more for the plane in flight;
// after them, for wave a ring of loaded u_prev planes shaped as level 0's,
// for Gray-Scott a second set of every level's rings (v).
struct Layout {
  int k, h, TY, TX;  // k: the levels (the steps; SOR: its 2k half-sweeps)
  __host__ __device__ int ry(int s) const { return TY + 2 * (k - s) * h; }
  __host__ __device__ int rx(int s) const { return TX + 2 * (k - s) * h; }
  __host__ __device__ int slots(int s) const {
    return s == 0 ? 2 * h + 2 : 2 * h + 1;
  }
  __host__ __device__ long plane(int s) const {
    return static_cast<long>(ry(s)) * rx(s);
  }
  // offset of level s's ring; base(k) is the u_prev ring's (wave) or the
  // offset of the v rings (Gray-Scott: v's level s at base(k) + base(s))
  __host__ __device__ long base(int s) const {
    long b = 0;
    for (int t = 0; t < s; ++t) b += slots(t) * plane(t);
    return b;
  }
  // cells of T the block's rings hold
  __host__ __device__ long cells(int kind) const {
    if (kind == WAVE7) return base(k) + slots(0) * plane(0);
    return kind == GRAYSCOTT ? 2 * base(k) : base(k);
  }
};

// Plane z (local; z >= -m) of the ring at `base` with `slots` planes.
template <class T>
__device__ __forceinline__ T* ring_plane(T* smem, const Layout& L, int s,
                                         long base, int z) {
  const int m = L.k * L.h;
  return smem + base + ((z + m) % L.slots(s)) * L.plane(s);
}

// One cell of window plane p into level 0's ring: cp.async for float, a
// plain load and store for bfloat16 (see the note above).
template <class T>
__device__ __forceinline__ void copy_cell(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    __pipeline_memcpy_async(dst, src, 4);
  } else {
    *dst = *src;
  }
}

template <int KIND, int SRC, class T>
__global__ void __launch_bounds__(THREADS)
stream_step(const WindowT<T> w, int k, Coef c, int TY, int TX) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  constexpr int h = kind_halo(KIND);
  constexpr bool two = KIND == WAVE7, gs = KIND == GRAYSCOTT;
  // levels: one per step, one per half-sweep for SOR
  const int K = k * kind_phases(KIND);
  const Layout L{K, h, TY, TX};
  const int m = kind_margin(KIND, k);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // the core column
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long gsy = w.X, gsz = static_cast<long>(w.X) * w.Y;
  // wave: the u_prev ring; Gray-Scott: the v rings (level s at + base(s))
  const long prev_base = L.base(K);

  // Issue the copies of window plane p into level 0's ring (and wave's
  // u_prev ring, or Gray-Scott's level-0 v ring): one cp.async group.
  auto load_plane = [&](int p) {
    const int RY = L.ry(0), RX = L.rx(0);
    T* d0 = ring_plane(smem, L, 0, 0, p);
    T* d1 = ring_plane(smem, L, 0, prev_base, p);
    for (int iy = ty; iy < RY; iy += TYT) {
      for (int ix = tx; ix < RX; ix += TXT) {
        const int y = y0 - m + iy, x = x0 - m + ix;
        copy_cell(d0 + iy * RX + ix, cell_ptr<SRC>(w, 0, p, y, x, 0));
        if constexpr (two || gs) {
          copy_cell(d1 + iy * RX + ix, cell_ptr<SRC>(w, 1, p, y, x, 0));
        }
      }
    }
    __pipeline_commit();
  };

  load_plane(-m);
  for (int p = -m; p < w.Z + m; ++p) {
    // plane p has landed for every thread, and every read of the previous
    // iteration is done (so its slots may be overwritten)
    __pipeline_wait_prior(0);
    __syncthreads();
    if (p + 1 < w.Z + m) load_plane(p + 1);
    for (int s = 1; s <= K; ++s) {
      const int e = (K - s) * h;  // level s reaches e cells past the core
      const int z = p - s * h;
      if (z < -e) break;  // no plane of this level (or a deeper one) yet
      const int RY = L.ry(s), RX = L.rx(s), PX = L.rx(s - 1);
      const long src_base = L.base(s - 1);
      const T* planes[2 * h + 1];
      const T* vplanes[2 * h + 1];  // Gray-Scott's v
#pragma unroll
      for (int j = 0; j <= 2 * h; ++j) {
        planes[j] = ring_plane(smem, L, s - 1, src_base, z - h + j);
        if constexpr (gs)
          vplanes[j] =
              ring_plane(smem, L, s - 1, prev_base + src_base, z - h + j);
      }
      // wave: level s-1's u_prev at plane z, in the coordinates of the
      // ring it lives in (the loaded u_prev for s = 1, else level s-2)
      const T* up = nullptr;
      int ux = 0, uoff = 0;
      if constexpr (two) {
        if (s == 1) {
          up = ring_plane(smem, L, 0, prev_base, z);
          ux = L.rx(0);
          uoff = h;
        } else {
          up = ring_plane(smem, L, s - 2, L.base(s - 2), z);
          ux = L.rx(s - 2);
          uoff = 2 * h;
        }
      }
      T* dst = s < K ? ring_plane(smem, L, s, L.base(s), z) : nullptr;
      T* vdst = gs && s < K
                    ? ring_plane(smem, L, s, prev_base + L.base(s), z)
                    : nullptr;
      for (int iy = ty; iy < RY; iy += TYT) {
        const int y = y0 - e + iy;
        for (int ix = tx; ix < RX; ix += TXT) {
          const int x = x0 - e + ix;
          const long off = static_cast<long>(iy + h) * PX + (ix + h);
          Ring<T, h> a;
#pragma unroll
          for (int j = 0; j <= 2 * h; ++j) a.plane[j] = planes[j] + off;
          a.sy = PX;
          const float u = a(0, 0, 0);
          // keep: the cell copies its previous level (a frame cell, or one
          // of the colour SOR's level s leaves)
          bool keep = in_frame(w.oz + z, w.oy + y, x, w.GZ, w.GY, w.GX, h);
          if constexpr (KIND == SOR7)
            keep = keep || other_colour(w.oz + z + w.oy + y + x, s);
          float v, v1 = 0.0f;  // the new u; Gray-Scott's new v
          if constexpr (two) {
            const float uprev =
                widen(up[static_cast<long>(iy + uoff) * ux + (ix + uoff)]);
            v = keep ? u : wave_update(a, uprev, c);
          } else if constexpr (gs) {
            Ring<T, h> b;
#pragma unroll
            for (int j = 0; j <= 2 * h; ++j) b.plane[j] = vplanes[j] + off;
            b.sy = PX;
            if (keep) {
              v = u;
              v1 = b(0, 0, 0);
            } else {
              grayscott_update(a, b, c, v, v1);
            }
          } else {
            v = keep ? u : field_update<KIND>(a, c);
          }
          if (s < K) {
            dst[iy * RX + ix] = narrow<T>(v);
            if constexpr (gs) vdst[iy * RX + ix] = narrow<T>(v1);
          } else if (y < w.Y && x < w.X) {
            const long g = z * gsz + y * gsy + x;
            w.out[0][g] = narrow<T>(v);
            // new u_prev: level k-1's u
            if constexpr (two) w.out[1][g] = narrow<T>(u);
            if constexpr (gs) w.out[1][g] = narrow<T>(v1);
          }
        }
      }
      if (s < K) __syncthreads();
    }
  }
}

template <int KIND, int SRC, class T>
int launch(const WindowT<T>& w, int k, const Coef& c, int ty, int tx,
           cudaStream_t s) {
  const Layout L{k * kind_phases(KIND), kind_halo(KIND), ty, tx};
  const size_t smem = sizeof(T) * L.cells(KIND);
  cudaError_t e = cudaFuncSetAttribute(
      stream_step<KIND, SRC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w.X + tx - 1) / tx, (w.Y + ty - 1) / ty);
  stream_step<KIND, SRC, T><<<grid, dim3(TXT, TYT), smem, s>>>(w, k, c, ty,
                                                                tx);
  return static_cast<int>(cudaGetLastError());
}

template <int SRC, class T>
int dispatch(int kind, const WindowT<T>& w, int k, const Coef& c, int ty,
             int tx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case HEAT7:
      return launch<HEAT7, SRC, T>(w, k, c, ty, tx, s);
    case HEAT27:
      return launch<HEAT27, SRC, T>(w, k, c, ty, tx, s);
    case HEAT13:
      return launch<HEAT13, SRC, T>(w, k, c, ty, tx, s);
    case WAVE7:
      return launch<WAVE7, SRC, T>(w, k, c, ty, tx, s);
    case SOR7:
      return launch<SOR7, SRC, T>(w, k, c, ty, tx, s);
    case ADVECT:
      return launch<ADVECT, SRC, T>(w, k, c, ty, tx, s);
    case GRAYSCOTT:
      return launch<GRAYSCOTT, SRC, T>(w, k, c, ty, tx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The three launches below, on storage type T.
template <class T>
int stream_raw(int kind, const T* in0, const T* in1, T* out0, T* out1, int Z,
               int Y, int X, int k, const Coef& c, int ty, int tx,
               void* stream) {
  const WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
                     {out0, out1}, Z, Y, X, Z, Y, X, 0, 0, 0};
  return dispatch<RAW>(kind, w, k, c, ty, tx, stream);
}

template <class T>
int stream_z(int kind, const T* in0, const T* in1, const T* lo0,
             const T* lo1, const T* hi0, const T* hi1, T* out0, T* out1,
             int Z, int Y, int X, int GZ, int oz, int k, const Coef& c,
             int ty, int tx, void* stream) {
  const WindowT<T> w{{in0, in1}, {lo0, lo1}, {hi0, hi1}, {out0, out1},
                     Z, Y, X, GZ, Y, X, oz, 0, kind_margin(kind, k)};
  return dispatch<ZSLAB>(kind, w, k, c, ty, tx, stream);
}

template <class T>
int stream_yz(int kind, const T* const* p, T* out0, T* out1, int Z, int Y,
              int X, int GZ, int GY, int GX, int oz, int oy, int k,
              const Coef& c, int ty, int tx, void* stream) {
  // p: per field, (in, zlo, zhi, ylo, yhi, ll, lh, hl, hh) in field-major
  // pairs, as the exports take them
  const WindowT<T> w{{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}, {out0, out1},
                     Z, Y, X, GZ, GY, GX, oz, oy, kind_margin(kind, k),
                     {p[6], p[7]}, {p[8], p[9]},
                     {{p[10], p[11]}, {p[12], p[13]}, {p[14], p[15]},
                      {p[16], p[17]}}};
  return dispatch<YZSLAB>(kind, w, k, c, ty, tx, stream);
}

}  // namespace

// One launch on `stream`, one device: (out0[, out1]) = k guard-frame steps
// of (in0[, in1]) on the whole (Z, Y, X) grid.  in1/out1 are used by the
// two-field kinds only (wave: u_prev; Gray-Scott: v).  Returns a
// cudaError_t code.  Each export has a _bf16 twin on bfloat16 operands.
EXPORT int stream_step_f32(int kind, const float* in0, const float* in1,
                           float* out0, float* out1, int Z, int Y, int X,
                           int k, float a, float c0, float c1, float c2,
                           float c3, int ty, int tx, void* stream) {
  return stream_raw(kind, in0, in1, out0, out1, Z, Y, X, k,
                    Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}

EXPORT int stream_step_bf16(int kind, const __nv_bfloat16* in0,
                            const __nv_bfloat16* in1, __nv_bfloat16* out0,
                            __nv_bfloat16* out1, int Z, int Y, int X, int k,
                            float a, float c0, float c1, float c2, float c3,
                            int ty, int tx, void* stream) {
  return stream_raw(kind, in0, in1, out0, out1, Z, Y, X, k,
                    Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}

// One launch over a z-only shard: its (Z, Y, X) core plus the (m, Y, X)
// slabs below (lo) and above (hi) it, k steps on; the core's global origin
// is (oz, 0, 0) in a (GZ, Y, X) grid.
EXPORT int stream_zslab_f32(int kind, const float* in0, const float* in1,
                            const float* lo0, const float* lo1,
                            const float* hi0, const float* hi1, float* out0,
                            float* out1, int Z, int Y, int X, int GZ, int oz,
                            int k, float a, float c0, float c1, float c2,
                            float c3, int ty, int tx, void* stream) {
  return stream_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X,
                  GZ, oz, k, Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}

EXPORT int stream_zslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* lo0, const __nv_bfloat16* lo1,
    const __nv_bfloat16* hi0, const __nv_bfloat16* hi1, __nv_bfloat16* out0,
    __nv_bfloat16* out1, int Z, int Y, int X, int GZ, int oz, int k, float a,
    float c0, float c1, float c2, float c3, int ty, int tx, void* stream) {
  return stream_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X,
                  GZ, oz, k, Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}

// One launch over a shard of a mesh that shards y: its (Z, Y, X) core plus,
// per field, the (m, Y, X) z slabs below (zlo) and above (zhi) it, the
// (Z, m, X) y slabs before (ylo) and after (yhi) it and the four (m, m, X)
// corner pieces (ll, lh, hl, hh in (z side, y side) order), k steps on; the
// core's global origin is (oz, oy, 0) in a (GZ, GY, GX) grid.
EXPORT int stream_yzslab_f32(
    int kind, const float* in0, const float* in1, const float* zlo0,
    const float* zlo1, const float* zhi0, const float* zhi1, const float* ylo0,
    const float* ylo1, const float* yhi0, const float* yhi1, const float* cll0,
    const float* cll1, const float* clh0, const float* clh1, const float* chl0,
    const float* chl1, const float* chh0, const float* chh1, float* out0,
    float* out1, int Z, int Y, int X, int GZ, int GY, int GX, int oz, int oy,
    int k, float a, float c0, float c1, float c2, float c3, int ty, int tx,
    void* stream) {
  const float* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1, ylo0, ylo1, yhi0,
                        yhi1, cll0, cll1, clh0, clh1, chl0, chl1, chh0, chh1};
  return stream_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                   Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}

EXPORT int stream_yzslab_bf16(
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
    int GY, int GX, int oz, int oy, int k, float a, float c0, float c1,
    float c2, float c3, int ty, int tx, void* stream) {
  const __nv_bfloat16* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1,
                                ylo0, ylo1, yhi0, yhi1, cll0, cll1,
                                clh0, clh1, chl0, chl1, chh0, chh1};
  return stream_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                   Coef{a, c0, c1, c2, c3}, ty, tx, stream);
}
