// Whole-pair online-time-warping alignment (set_live) for a batch of B
// pairs in one launch, one thread block per pair, for sm_90a.
//
// Replaces the TPU kernels real_time_audio_sync_tpu/ops/pallas_otw.py:
// _pallas_set_live (:387) and _pallas_batched_set_live (:505), both driven
// by _make_set_live_kernel (:296) over the band primitives _build_ops
// (:125).  A solo pair is B = 1.  The Python wrapper and the plain PyTorch
// version of the same algorithm are in ops/otw_set_live.py; the two agree
// bit for bit, and the band primitives are those of the K-insert kernel
// (otw_band.cuh).
//
// Per pair (set_live, otw_eran.py:91-142): live_cap = 2 ref_len; the window
// starts at the sentinel with acc[0,0] = cost(live 0, ref 0) at cell (c,c);
// then, until done: best point + append + direction; a row step unless the
// direction is COL (done when t+1 reaches live_len or live_cap, which also
// skips the column step); a column step unless it is ROW (done when j+1
// reaches ref_len).  Out: plen, t, j, stopped = j >= ref_len.
//
// Bound: latency.  A pair is a serial chain of about t + j band steps over a
// few KB of state, each a (c+1)-wide cost, a min-plus scan and an argmin
// between block barriers; its bytes (the feature rows, read once, and the
// path) and operations take well under a microsecond of the card.  So, as
// in the K-insert kernel, the (c+1)^2 window lives in shared memory with
// ring offsets and the scalar state machine in registers; pairs are
// independent blocks, each running its own t_i + n_i steps and leaving on
// its own `done` (a ragged batch needs no grid-wide barrier).  A shared
// reference is one copy in device memory that every block reads.  A band
// too wide for shared memory keeps each block's window in its slice of a
// global-memory workspace (w_work), as the K-insert kernel does.

#include "otw_band.cuh"

namespace {

using namespace otw_band;

constexpr int PREV_NONE = -1;
constexpr int N_OUT = 8;  // per-pair scalars: plen, t, j, stopped, 0, 0, 0, 0

struct Params {
  const float* ref;    // (R, ref_rows, f), R = 1 (shared) or B; row c+j is ref frame j
  const float* live;   // (B, live_rows, f); row c+t is live frame t
  const int* lens;     // (B, 2): live_len, ref_len
  int* path_x;         // (B, p_len)
  int* path_y;
  int* out;            // (B, N_OUT)
  float* w_work;       // (B, L, L) global workspace (kSharedWindow false)
  int c, f, p_len, ref_rows, live_rows, shared_ref;
  float sentinel;
  int max_run_count, run_count_init, monotone, euclidean;
};

template <bool kSharedWindow>
__global__ void otw_set_live_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int c = p.c, L = c + 1, f = p.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool eu = p.euclidean != 0;
  const float sentinel = p.sentinel;

  float* W = kSharedWindow ? smem : p.w_work + (size_t)b * L * L;  // L * L
  float* rbuf = kSharedWindow ? smem + L * L : smem;              // 2 * nt (ping-pong)
  float* cbuf = rbuf + 2 * nt;           // 2 * nt
  float* red_v = cbuf + 2 * nt;          // 2 * MAX_WARPS
  int* red_i = reinterpret_cast<int*>(red_v + 2 * MAX_WARPS);  // 2 * MAX_WARPS

  const float* ref = p.ref + (p.shared_ref ? 0 : (size_t)b * p.ref_rows * f);
  const float* live = p.live + (size_t)b * p.live_rows * f;
  int* path_x = p.path_x + (size_t)b * p.p_len;
  int* path_y = p.path_y + (size_t)b * p.p_len;
  const int live_len = p.lens[2 * b], ref_len = p.lens[2 * b + 1];
  const int live_cap = 2 * ref_len;  // pre-allocated live capacity (otw_eran.py:14)

  // the origin: acc[0,0] = cost(0,0) at cell (c,c), every other cell the sentinel
  for (int i = tid; i < L * L; i += nt) W[i] = sentinel;
  __syncthreads();
  if (tid == 0) W[c * L + c] = cost_of(live + (size_t)c * f, ref + (size_t)c * f, f, eu);
  __syncthreads();
  Ring ring{L, 0, 0};

  int t = 0, j = 0;
  Walk w{p.run_count_init, PREV_NONE, 0, -1, -1};
  bool done = false;
  const int n_steps = live_len + ref_len;  // every step advances t or j
  for (int s = 0; s < n_steps && !done; ++s) {
    const int d = set_direction(W, ring, t, j, c, w, path_x, path_y, p.p_len, 0, p.monotone != 0,
                                p.max_run_count, red_v, red_i);
    if (d != COL) {
      ++t;
      if (t >= live_len || t >= live_cap) {
        done = true;  // and no column step in this iteration
      } else {
        row_update(W, ring, ref, live + (size_t)(t + c) * f, j, c, f, eu, sentinel, rbuf, cbuf, nt);
      }
    }
    if (d != ROW && !done) {
      ++j;
      if (j >= ref_len) {
        done = true;
      } else {
        col_update(W, ring, live, ref + (size_t)(j + c) * f, t, c, f, eu, sentinel, rbuf, cbuf, nt);
      }
    }
  }

  if (tid == 0) {
    int* out = p.out + (size_t)b * N_OUT;
    out[0] = w.plen;
    out[1] = t;
    out[2] = j;
    out[3] = j >= ref_len ? 1 : 0;
    for (int i = 4; i < N_OUT; ++i) out[i] = 0;
  }
}

}  // namespace

extern "C" int otw_set_live(void* ref, void* live, void* lens, void* path_x, void* path_y, void* out,
                            void* w_work, int batch, int c, int f, int p_len, int ref_rows,
                            int live_rows, int shared_ref, float sentinel, int max_run_count,
                            int run_count_init, int monotone, int euclidean, void* stream) {
  Params p{static_cast<const float*>(ref), static_cast<const float*>(live),
           static_cast<const int*>(lens), static_cast<int*>(path_x), static_cast<int*>(path_y),
           static_cast<int*>(out), static_cast<float*>(w_work), c, f, p_len, ref_rows, live_rows,
           shared_ref, sentinel, max_run_count, run_count_init, monotone, euclidean};
  const int nt = band_threads(c);
  const bool in_shared = w_work == nullptr;
  return launch_band(in_shared ? otw_set_live_kernel<true> : otw_set_live_kernel<false>, batch, nt,
                     shared_bytes(c, nt, in_shared), static_cast<cudaStream_t>(stream), p);
}

extern "C" const char* otw_set_live_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
