// Band primitives of the online-time-warping recurrence, shared by the
// K-insert kernel (otw_insert.cu) and the whole-pair set_live kernel
// (otw_set_live.cu): one copy of the band math keeps the two bit-equal.
//
// Counterpart of the TPU kernels' shared primitives in
// real_time_audio_sync_tpu/ops/pallas_otw.py: _build_ops (:125) —
// row_update, col_update, best_point, append_point, set_direction —
// _minplus_doubling (:87) and _first_min (:111).
//
// Layout: a (c+1)^2 band-relative window W[a, b] = acc[t-c+a, j-c+b] in
// shared memory (or, for bands too wide for it, in a global-memory
// workspace of one window per block; see otw_band_workspace_floats), addressed through
// ring offsets (advancing t or j moves an
// offset instead of rolling the window).  Feature rows sit in device memory
// with c leading zero rows: ref row c+j is reference frame j, live row c+t
// is live frame t.  Every function is called by all threads of the block;
// thread `tid` owns band position tid (tid <= c), and the scalar state is
// computed identically by every thread from the same reduced values.
//
// Numerics: costs are sequential float32 sums over f with explicit
// round-to-nearest intrinsics (no contraction to FMA; the library is also
// built with --fmad=false); the min-plus scan runs _minplus_doubling's
// stages in order; argmins keep the first minimum among valid cells.  IEEE
// infinities are the LiveNote sentinels, so no fast-math.

#pragma once

#include <cuda_runtime.h>

namespace otw_band {

constexpr int ROW = 0, COL = 1, BOTH = 2;
constexpr int MAX_WARPS = 32;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ float cost_of(const float* rows, const float* fixed, int f, bool euclidean) {
  float s = 0.0f;
  if (euclidean) {
    for (int i = 0; i < f; ++i) {
      float d = __fsub_rn(rows[i], fixed[i]);
      s = __fadd_rn(s, __fmul_rn(d, d));
    }
    return __fsqrt_rn(s);
  }
  for (int i = 0; i < f; ++i) s = __fadd_rn(s, __fmul_rn(rows[i], fixed[i]));
  return __fsub_rn(1.0f, s);
}

// (value, index) lexicographic minimum: the first minimum wins.
__device__ __forceinline__ void take_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Threads of one block of a band kernel: one per band position, in whole warps.
inline int band_threads(int c) { return ((c + 1 + 31) / 32) * 32; }

// Dynamic shared memory of one block of a band kernel with nt threads:
// the window (unless it lives in a global workspace) and the scan and
// argmin scratch.  otw_band_workspace_floats below chooses the window's
// route from it.
inline size_t window_bytes(int c) { return sizeof(float) * (size_t)(c + 1) * (c + 1); }
inline size_t shared_bytes(int c, int nt, bool window_in_shared) {
  return (window_in_shared ? window_bytes(c) : 0) + sizeof(float) * (4 * (size_t)nt + 4 * MAX_WARPS);
}

// Launch a band kernel of `blocks` blocks of nt threads with `smem` bytes of
// dynamic shared memory, opting in above the default 48 KB; returns the
// CUDA error code (0 on success).  The kernels take the window's memory
// space as a template parameter (kSharedWindow), not as a runtime choice of
// pointer: a pointer that may point to either space makes every window
// access a generic one, and the shared route pays for it.
template <typename Params>
inline int launch_band(void (*kernel)(Params), int blocks, int nt, size_t smem, cudaStream_t stream,
                       const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0) {
    void* args[] = {const_cast<Params*>(&p)};
    cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(nt), args, smem,
                                     stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

struct Ring {
  int L, ro, co;
  __device__ __forceinline__ int at(int a, int b) const {
    int pa = a + ro;
    if (pa >= L) pa -= L;
    int pb = b + co;
    if (pb >= L) pb -= L;
    return pa * L + pb;
  }
};

// One band over positions 0..c: bvec = min(prev + cost, diag + 2 cost) with
// the diagonal masked at 0 and at no_diag_at, band [lo, c], first-cell
// neighbour `init`, then the min-plus scan.  Returns this thread's new cell
// (valid for tid <= c).  Ends after a barrier.
__device__ inline float band_step(float cost, float prev, float diag, int lo, float init,
                                  float sentinel, int c, float* rbuf, float* cbuf, int nt) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  if (tid <= c) {
    bool band = tid >= lo;
    float bvec = fminf(__fadd_rn(prev, cost), __fadd_rn(diag, __fmul_rn(2.0f, cost)));
    float bm = band ? bvec : inf;
    float cm = band ? cost : inf;
    if (tid == lo) bm = fminf(bm, __fadd_rn(init, cm));
    rbuf[tid] = bm;
    cbuf[tid] = cm;
  }
  __syncthreads();
  int src = 0;
  for (int shift = 1; shift <= c; shift <<= 1) {
    if (tid <= c) {
      float rv = rbuf[src * nt + tid];
      float cv = cbuf[src * nt + tid];
      if (tid >= shift) {
        rv = fminf(rv, __fadd_rn(rbuf[src * nt + tid - shift], cv));
        cv = __fadd_rn(cbuf[src * nt + tid - shift], cv);
      }
      rbuf[(src ^ 1) * nt + tid] = rv;
      cbuf[(src ^ 1) * nt + tid] = cv;
    }
    __syncthreads();
    src ^= 1;
  }
  float out = sentinel;
  if (tid <= c && tid >= lo) out = rbuf[src * nt + tid];
  return out;
}

// Advance one live row to frame t and evaluate its band against ref frames
// j-c..j: `live_row` is frame t's features, `ref` the padded reference rows.
// The new logical row c reuses the old row 0's storage.  Ends after a
// barrier.
__device__ inline void row_update(float* W, Ring& ring, const float* ref, const float* live_row, int j,
                                  int c, int f, bool eu, float sentinel, float* rbuf, float* cbuf,
                                  int nt) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  ring.ro = (ring.ro + 1 == c + 1) ? 0 : ring.ro + 1;
  float cost = 0.0f, up = 0.0f, diag = inf;
  if (tid <= c) {
    cost = cost_of(ref + (size_t)(j + tid) * f, live_row, f, eu);
    up = W[ring.at(c - 1, tid)];
    if (tid > 0 && tid != c - j) diag = W[ring.at(c - 1, tid - 1)];
  }
  float v = band_step(cost, up, diag, max(c - j, 1), j >= c ? sentinel : inf, sentinel,
                      c, rbuf, cbuf, nt);
  if (tid <= c) W[ring.at(c, tid)] = v;
  __syncthreads();
}

// Advance one ref column to frame j and evaluate its band against live
// frames t-c..t: `ref_row` is frame j's features, `live` the padded live
// rows.  The new logical column c reuses the old column 0.  Ends after a
// barrier.
__device__ inline void col_update(float* W, Ring& ring, const float* live, const float* ref_row, int t,
                                  int c, int f, bool eu, float sentinel, float* rbuf, float* cbuf,
                                  int nt) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  ring.co = (ring.co + 1 == c + 1) ? 0 : ring.co + 1;
  float cost = 0.0f, left = 0.0f, diag = inf;
  if (tid <= c) {
    cost = cost_of(live + (size_t)(t + tid) * f, ref_row, f, eu);
    left = W[ring.at(tid, c - 1)];
    if (tid > 0 && tid != c - t) diag = W[ring.at(tid - 1, c - 1)];
  }
  float v = band_step(cost, left, diag, max(c - t, 1), t >= c ? sentinel : inf,
                      sentinel, c, rbuf, cbuf, nt);
  if (tid <= c) W[ring.at(tid, c)] = v;
  __syncthreads();
}

// The scalar state of one alignment walk, identical in every thread.
struct Walk {
  int rc, prev, plen, lastx, lasty;
};

// best point: first minimum of window row c over lanes [b0, c] and of
// window column c over sublanes [a0, c]; then append it to the path (thread
// 0 stores; the monotone guard of LiveNoteV2) and return the next direction
// (startup, forced or free), updating the run count and previous direction.
// The point committed at path index plen goes to slot plen - path_base of
// path_x/path_y (p_len slots): path_base 0 for a whole-path buffer, the
// launch's starting plen for a per-launch delta.  A point outside the slots
// is counted but not stored.  red_v/red_i hold 2 * MAX_WARPS slots each.
// Ends after a barrier.
__device__ inline int set_direction(const float* W, const Ring& ring, int t, int j, int c, Walk& w,
                                    int* path_x, int* path_y, int p_len, int path_base,
                                    bool monotone, int max_run_count, float* red_v, int* red_i) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  const int b0 = max(c - j, 1), a0 = max(c - t, 1);
  float rv = inf, cv = inf;
  int ri = NO_INDEX, ci = NO_INDEX;
  if (tid <= c && tid >= b0) { rv = W[ring.at(c, tid)]; ri = tid; }
  if (tid <= c && tid >= a0) { cv = W[ring.at(tid, c)]; ci = tid; }
  for (int off = 16; off > 0; off >>= 1) {
    take_min(rv, ri, __shfl_down_sync(0xffffffffu, rv, off), __shfl_down_sync(0xffffffffu, ri, off));
    take_min(cv, ci, __shfl_down_sync(0xffffffffu, cv, off), __shfl_down_sync(0xffffffffu, ci, off));
  }
  if (lane == 0) {
    red_v[warp] = rv; red_i[warp] = ri;
    red_v[MAX_WARPS + warp] = cv; red_i[MAX_WARPS + warp] = ci;
  }
  __syncthreads();
  float cost_j = red_v[0], cost_t = red_v[MAX_WARPS];
  int bj = red_i[0], ak = red_i[MAX_WARPS];
  for (int wi = 1; wi < nwarps; ++wi) {
    take_min(cost_j, bj, red_v[wi], red_i[wi]);
    take_min(cost_t, ak, red_v[MAX_WARPS + wi], red_i[MAX_WARPS + wi]);
  }
  __syncthreads();  // the slots are rewritten by the next call

  const bool use_row = cost_j < cost_t;
  const int x = use_row ? t : t - c + ak;
  const int y = use_row ? j - c + bj : j;
  if (!monotone || w.plen == 0 || (x > w.lastx && y >= w.lasty)) {
    const int slot = w.plen - path_base;
    if (tid == 0 && slot >= 0 && slot < p_len) {
      path_x[slot] = x;
      path_y[slot] = y;
    }
    ++w.plen;
    w.lastx = x;
    w.lasty = y;
  }
  int d;
  if (t < c) {
    d = BOTH;
  } else if (w.rc >= max_run_count) {
    d = w.prev == ROW ? COL : ROW;
  } else {
    d = x < t ? COL : (y < j ? ROW : BOTH);
  }
  w.rc = d == w.prev ? w.rc + 1 : 1;
  if (d != BOTH) w.prev = d;
  return d;
}

}  // namespace otw_band

// Floats of global-memory window workspace one block of a band-c kernel
// needs on `device`: 0 when the window and the scratch fit the most dynamic
// shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// else (c+1)^2; -1 when the limit cannot be read.  The wrappers allocate
// what it returns and pass no workspace for 0, so the route is decided here
// alone.
extern "C" int otw_band_workspace_floats(int c, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  if (otw_band::shared_bytes(c, otw_band::band_threads(c), true) <= (size_t)limit) return 0;
  return (c + 1) * (c + 1);
}
