// K10 stream_step<KIND, RAW|ZSLAB|YZSLAB>: k guard-frame steps per
// device-memory pass by a temporal wavefront that marches down z, reading
// each input plane of a block's window once per pass.
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
// marches it down z as a wavefront in time: ring.cuh's kernel, redesigned
// for Hopper (one barrier a plane by a skewed schedule, 16-byte cp.async
// rows with two planes in flight, warps that own levels, column values
// kept in registers, block-uniform fast paths; ring.cuh says how).  Every
// plane of the window is read from device memory once per pass; the y/x
// margin of a column is re-read by its neighbours from L2.
//
// Red-black SOR marches 2k levels of halo 1 (m = 2k): level s relaxes the
// cells of colour (s-1) % 2 of the GLOBAL coordinate sum and copies the
// others, as _micro_sor does.  Gray-Scott keeps a ring for u and one for v
// at every level.  Wave keeps no u_prev ring past level 0: level s's u_prev
// is level s-2's u at the same cell, and the output u_prev is level k-1's
// u.  Storage type T: float32, or bfloat16 (rings, operands and outputs in
// bfloat16, every op rounded as the plain version rounds it).
//
// Bound on an H100: device-memory bytes, one read and one write of each
// field per k steps, as for K3; the design removes K3's z re-reads (its
// (TZ + 2m)/TZ) and its margin recompute along z.

#include "ring.cuh"

namespace {

// The launch's tile and ring: core column (ty, tx), the block's threads
// and blocks an SM, the ring slots (s0, s1), the fast paths allowed and
// the members of a batched launch (1: unbatched; the launch grid's z takes
// one column's march per member, each priming its own rings).
struct Tile {
  int ty, tx, threads, blocks, s0, s1, paths, members;
};

template <int SRC, class T>
int dispatch(int kind, const WindowT<T>& w, int k, const Coef& c,
             const Tile& t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STREAM_LAUNCH(K)                                                   \
  ring::launch<K, SRC, T>(w, k, c, t.ty, t.tx, w.Z, t.threads, t.blocks, \
                          t.s0, t.s1, t.paths, s, t.members)
  switch (kind) {
    case HEAT7:
      return STREAM_LAUNCH(HEAT7);
    case HEAT27:
      return STREAM_LAUNCH(HEAT27);
    case HEAT13:
      return STREAM_LAUNCH(HEAT13);
    case WAVE7:
      return STREAM_LAUNCH(WAVE7);
    case SOR7:
      return STREAM_LAUNCH(SOR7);
    case ADVECT:
      return STREAM_LAUNCH(ADVECT);
    case GRAYSCOTT:
      return STREAM_LAUNCH(GRAYSCOTT);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STREAM_LAUNCH
}

template <class T>
int stream_raw(int kind, const T* in0, const T* in1, T* out0, T* out1, int Z,
               int Y, int X, int k, const Coef& c, const Tile& t,
               void* stream) {
  WindowT<T> w{{in0, in1}, {nullptr, nullptr}, {nullptr, nullptr},
               {out0, out1}, Z, Y, X, Z, Y, X, 0, 0, 0};
  set_member_strides<RAW>(w, t.members);
  return dispatch<RAW>(kind, w, k, c, t, stream);
}

template <class T>
int stream_z(int kind, const T* in0, const T* in1, const T* lo0,
             const T* lo1, const T* hi0, const T* hi1, T* out0, T* out1,
             int Z, int Y, int X, int GZ, int oz, int k, const Coef& c,
             const Tile& t, void* stream) {
  WindowT<T> w{{in0, in1}, {lo0, lo1}, {hi0, hi1}, {out0, out1},
               Z, Y, X, GZ, Y, X, oz, 0, kind_margin(kind, k)};
  set_member_strides<ZSLAB>(w, t.members);
  return dispatch<ZSLAB>(kind, w, k, c, t, stream);
}

template <class T>
int stream_yz(int kind, const T* const* p, T* out0, T* out1, int Z, int Y,
              int X, int GZ, int GY, int GX, int oz, int oy, int k,
              const Coef& c, const Tile& t, void* stream) {
  // p: per field, (in, zlo, zhi, ylo, yhi, ll, lh, hl, hh) in field-major
  // pairs, as the exports take them
  WindowT<T> w{{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}, {out0, out1},
               Z, Y, X, GZ, GY, GX, oz, oy, kind_margin(kind, k),
               {p[6], p[7]}, {p[8], p[9]},
               {{p[10], p[11]}, {p[12], p[13]}, {p[14], p[15]},
                {p[16], p[17]}}};
  set_member_strides<YZSLAB>(w, t.members);
  return dispatch<YZSLAB>(kind, w, k, c, t, stream);
}

}  // namespace

// One launch on `stream`, one device: (out0[, out1]) = k guard-frame steps
// of (in0[, in1]) on the whole (Z, Y, X) grid.  in1/out1 are used by the
// two-field kinds only (wave: u_prev; Gray-Scott: v).  Returns a
// cudaError_t code.  Each export has a _bf16 twin on bfloat16 operands.
// Every export ends with the launch's tile: the core column (ty, tx), the
// block's threads and blocks an SM (1 or 2: ring.cuh's builds), the ring
// slots (s0: level 0, s1: levels 1..K-1;
// streamfused.py::ring_slots) and `paths`, the fast paths it may take (bit
// 0: 16-byte row copies, set only where every operand's address is 16-byte
// aligned; bit 1: no y/x frame test where no updated cell is frame), then
// `members`: N > 1 runs N members in one launch, every operand holding N
// blocks of its shape back to back.
EXPORT int stream_step_f32(int kind, const float* in0, const float* in1,
                           float* out0, float* out1, int Z, int Y, int X,
                           int k, float a, float c0, float c1, float c2,
                           float c3, int ty, int tx, int threads, int blocks,
                           int s0, int s1, int paths, int members,
                           void* stream) {
  return stream_raw(kind, in0, in1, out0, out1, Z, Y, X, k,
                    Coef{a, c0, c1, c2, c3},
                    Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
}

EXPORT int stream_step_bf16(int kind, const __nv_bfloat16* in0,
                            const __nv_bfloat16* in1, __nv_bfloat16* out0,
                            __nv_bfloat16* out1, int Z, int Y, int X, int k,
                            float a, float c0, float c1, float c2, float c3,
                            int ty, int tx, int threads, int blocks, int s0,
                            int s1, int paths, int members, void* stream) {
  return stream_raw(kind, in0, in1, out0, out1, Z, Y, X, k,
                    Coef{a, c0, c1, c2, c3},
                    Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
}

// One launch over a z-only shard: its (Z, Y, X) core plus the (m, Y, X)
// slabs below (lo) and above (hi) it, k steps on; the core's global origin
// is (oz, 0, 0) in a (GZ, Y, X) grid.
EXPORT int stream_zslab_f32(int kind, const float* in0, const float* in1,
                            const float* lo0, const float* lo1,
                            const float* hi0, const float* hi1, float* out0,
                            float* out1, int Z, int Y, int X, int GZ, int oz,
                            int k, float a, float c0, float c1, float c2,
                            float c3, int ty, int tx, int threads, int blocks,
                            int s0, int s1, int paths, int members,
                           void* stream) {
  return stream_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X,
                  GZ, oz, k, Coef{a, c0, c1, c2, c3},
                  Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
}

EXPORT int stream_zslab_bf16(
    int kind, const __nv_bfloat16* in0, const __nv_bfloat16* in1,
    const __nv_bfloat16* lo0, const __nv_bfloat16* lo1,
    const __nv_bfloat16* hi0, const __nv_bfloat16* hi1, __nv_bfloat16* out0,
    __nv_bfloat16* out1, int Z, int Y, int X, int GZ, int oz, int k, float a,
    float c0, float c1, float c2, float c3, int ty, int tx, int threads,
    int blocks, int s0, int s1, int paths, int members,
    void* stream) {
  return stream_z(kind, in0, in1, lo0, lo1, hi0, hi1, out0, out1, Z, Y, X,
                  GZ, oz, k, Coef{a, c0, c1, c2, c3},
                  Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
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
    int threads, int blocks, int s0, int s1, int paths, int members,
    void* stream) {
  const float* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1, ylo0, ylo1, yhi0,
                        yhi1, cll0, cll1, clh0, clh1, chl0, chl1, chh0, chh1};
  return stream_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                   Coef{a, c0, c1, c2, c3},
                   Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
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
    float c2, float c3, int ty, int tx, int threads, int blocks, int s0,
    int s1, int paths, int members, void* stream) {
  const __nv_bfloat16* p[18] = {in0,  in1,  zlo0, zlo1, zhi0, zhi1,
                                ylo0, ylo1, yhi0, yhi1, cll0, cll1,
                                clh0, clh1, chl0, chl1, chh0, chh1};
  return stream_yz(kind, p, out0, out1, Z, Y, X, GZ, GY, GX, oz, oy, k,
                   Coef{a, c0, c1, c2, c3},
                   Tile{ty, tx, threads, blocks, s0, s1, paths, members},
                    stream);
}
