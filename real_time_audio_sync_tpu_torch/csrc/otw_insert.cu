// K streaming online-time-warping inserts per launch, one thread block per
// stream, for sm_90a.
//
// Replaces the TPU kernel real_time_audio_sync_tpu/ops/pallas_otw.py:
// _pallas_insert_block (:803), body _insert_block_body (:644), band
// primitives _build_ops (:125), _minplus_doubling (:87), _first_min (:111).
// The Python wrapper and the plain PyTorch version of the same algorithm are
// in ops/otw_insert.py; the two agree bit for bit.
//
// Bound: latency.  A launch is a serial chain of about K * loop_iters band
// steps over a few KB of state, each step a (c+1)-wide cost, a min-plus
// scan and two argmins between block barriers.  So the (c+1)^2 window lives
// in shared memory for the whole launch, advanced by ring offsets instead of
// the TPU's physical rolls (a band step touches O(c) cells); the scalar
// state machine lives in registers, computed identically by every thread
// from the same reduced values; device memory sees only the feature rows
// (F floats each), the path points and the window's load and store.
//
// Numerics (see ops/otw_insert.py): costs are sequential float32 sums over
// f with explicit round-to-nearest intrinsics (no contraction to FMA, also
// built with --fmad=false); the min-plus scan runs _minplus_doubling's
// stages in order; argmins keep the first minimum among valid cells.
// IEEE infinities are the LiveNote sentinels, so no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int ROW = 0, COL = 1, BOTH = 2;
constexpr int S_T = 0, S_J = 1, S_RC = 2, S_PREV = 3, S_PLEN = 4, S_LASTX = 5,
              S_LASTY = 6, S_FIRST = 7, S_STOPPED = 8, S_DIR = 9, S_OVERFLOW = 10;
constexpr int MAX_WARPS = 32;
constexpr int NO_INDEX = 0x7fffffff;

struct Params {
  float* w;            // (L, L) window, canonical layout, L = c + 1
  const float* ref;    // (c + ref_len, f), c leading zero rows
  float* live;         // (c + live_cap, f)
  int* path_x;         // (p_len,)
  int* path_y;
  int* scalars;        // int32[16]
  int* status;         // int32[8]
  const float* cols;   // (n_valid, f) rows to insert
  int c, f, p_len, live_cap, ref_len, n_valid;
  float sentinel;
  int max_run_count, monotone, euclidean, loop_iters;
};

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
__device__ float band_step(float cost, float prev, float diag, int lo, float init,
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

__global__ void otw_insert_kernel(Params p) {
  extern __shared__ float smem[];
  const int c = p.c, L = c + 1, f = p.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const bool eu = p.euclidean != 0;
  const float inf = __int_as_float(0x7f800000);
  const float sentinel = p.sentinel;

  float* W = smem;                       // L * L
  float* rbuf = W + L * L;               // 2 * nt (ping-pong)
  float* cbuf = rbuf + 2 * nt;           // 2 * nt
  float* red_v = cbuf + 2 * nt;          // 2 * MAX_WARPS
  int* red_i = reinterpret_cast<int*>(red_v + 2 * MAX_WARPS);  // 2 * MAX_WARPS

  for (int i = tid; i < L * L; i += nt) W[i] = p.w[i];
  Ring ring{L, 0, 0};

  int t = p.scalars[S_T], j = p.scalars[S_J], rc = p.scalars[S_RC];
  int prev = p.scalars[S_PREV], plen = p.scalars[S_PLEN];
  int lastx = p.scalars[S_LASTX], lasty = p.scalars[S_LASTY];
  bool first = p.scalars[S_FIRST] != 0, stopped = p.scalars[S_STOPPED] != 0;
  int direction = p.scalars[S_DIR];
  bool overflow = p.scalars[S_OVERFLOW] != 0;
  __syncthreads();

  for (int k = 0; k < p.n_valid && !stopped; ++k) {
    const float* col = p.cols + (size_t)k * f;
    int t_new = t;
    bool do_row = false;
    if (first) {
      // first insert: live row 0 <- col, acc[0,0] = cost(0,0) at cell (c,c)
      for (int i = tid; i < f; i += nt) p.live[(size_t)c * f + i] = col[i];
      __syncthreads();
      if (tid <= c) {
        float v = sentinel;
        if (tid == c) v = cost_of(p.live + (size_t)c * f, p.ref + (size_t)c * f, f, eu);
        W[ring.at(c, tid)] = v;
      }
      __syncthreads();
      first = false;
    } else {
      t_new = t + 1;
      do_row = t_new < p.live_cap;  // else "ran out of room": t advances only
      if (do_row) {
        for (int i = tid; i < f; i += nt) p.live[(size_t)(t_new + c) * f + i] = col[i];
        __syncthreads();
        // advance one live row: logical row c-1 is the old row c, the new
        // row c reuses the old row 0's storage
        ring.ro = (ring.ro + 1 == L) ? 0 : ring.ro + 1;
        float cost = 0.0f, up = 0.0f, diag = inf;
        if (tid <= c) {
          cost = cost_of(p.ref + (size_t)(j + tid) * f, p.live + (size_t)(t_new + c) * f, f, eu);
          up = W[ring.at(c - 1, tid)];
          if (tid > 0 && tid != c - j) diag = W[ring.at(c - 1, tid - 1)];
        }
        float v = band_step(cost, up, diag, max(c - j, 1), j >= c ? sentinel : inf, sentinel,
                            c, rbuf, cbuf, nt);
        if (tid <= c) W[ring.at(c, tid)] = v;
        __syncthreads();
      }
    }

    // column phase: at most loop_iters (column step, direction) rounds
    bool active = do_row;
    int d = direction;
    for (int it = 0; it < p.loop_iters && active; ++it) {
      if (d != ROW) {
        ++j;
        if (j >= p.ref_len) {  // past the end of the reference: stop, frozen
          stopped = true;
          active = false;
          break;
        }
        // advance one ref column: the new column c reuses the old column 0
        ring.co = (ring.co + 1 == L) ? 0 : ring.co + 1;
        float cost = 0.0f, left = 0.0f, diag = inf;
        if (tid <= c) {
          cost = cost_of(p.live + (size_t)(t_new + tid) * f, p.ref + (size_t)(j + c) * f, f, eu);
          left = W[ring.at(tid, c - 1)];
          if (tid > 0 && tid != c - t_new) diag = W[ring.at(tid - 1, c - 1)];
        }
        float v = band_step(cost, left, diag, max(c - t_new, 1), t_new >= c ? sentinel : inf,
                            sentinel, c, rbuf, cbuf, nt);
        if (tid <= c) W[ring.at(tid, c)] = v;
        __syncthreads();
      }

      // best point: first minimum of window row c over lanes [b0, c] and of
      // window column c over sublanes [a0, c]
      const int b0 = max(c - j, 1), a0 = max(c - t_new, 1);
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
      __syncthreads();  // the slots are rewritten by the next round

      const bool use_row = cost_j < cost_t;
      const int x = use_row ? t_new : t_new - c + ak;
      const int y = use_row ? j - c + bj : j;
      if (!p.monotone || plen == 0 || (x > lastx && y >= lasty)) {
        if (tid == 0 && plen < p.p_len) {
          p.path_x[plen] = x;
          p.path_y[plen] = y;
        }
        ++plen;
        lastx = x;
        lasty = y;
      }
      if (t_new < c) {
        d = BOTH;
      } else if (rc >= p.max_run_count) {
        d = prev == ROW ? COL : ROW;
      } else {
        d = x < t_new ? COL : (y < j ? ROW : BOTH);
      }
      rc = d == prev ? rc + 1 : 1;
      if (d != BOTH) prev = d;
      active = d == COL;
    }
    direction = d;
    overflow = overflow || active;  // loop bound violated (never, by design)
    t = t_new;
  }

  __syncthreads();
  for (int i = tid; i < L * L; i += nt) p.w[i] = W[ring.at(i / L, i % L)];
  if (tid == 0) {
    p.scalars[S_T] = t; p.scalars[S_J] = j; p.scalars[S_RC] = rc; p.scalars[S_PREV] = prev;
    p.scalars[S_PLEN] = plen; p.scalars[S_LASTX] = lastx; p.scalars[S_LASTY] = lasty;
    p.scalars[S_FIRST] = first ? 1 : 0; p.scalars[S_STOPPED] = stopped ? 1 : 0;
    p.scalars[S_DIR] = direction; p.scalars[S_OVERFLOW] = overflow ? 1 : 0;
    p.status[0] = (stopped ? 1 : 0) | (overflow ? 2 : 0);
    p.status[1] = plen; p.status[2] = lastx; p.status[3] = lasty;
    p.status[4] = 0; p.status[5] = 0; p.status[6] = 0; p.status[7] = 0;
  }
}

}  // namespace

extern "C" int otw_insert_block(void* w, void* ref, void* live, void* path_x, void* path_y,
                                void* scalars, void* status, void* cols, int c, int f,
                                int p_len, int live_cap, int ref_len, int n_valid,
                                float sentinel, int max_run_count, int monotone,
                                int euclidean, int loop_iters, void* stream) {
  Params p{static_cast<float*>(w), static_cast<const float*>(ref), static_cast<float*>(live),
           static_cast<int*>(path_x), static_cast<int*>(path_y), static_cast<int*>(scalars),
           static_cast<int*>(status), static_cast<const float*>(cols),
           c, f, p_len, live_cap, ref_len, n_valid, sentinel, max_run_count, monotone,
           euclidean, loop_iters};
  const int L = c + 1;
  const int nt = ((L + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)L * L + 4 * nt + 4 * MAX_WARPS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(otw_insert_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  otw_insert_kernel<<<1, nt, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* otw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
