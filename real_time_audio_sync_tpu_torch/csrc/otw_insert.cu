// K streaming online-time-warping inserts per launch, one thread block per
// stream, for sm_90a.
//
// Replaces two TPU kernels of real_time_audio_sync_tpu/ops/pallas_otw.py,
// as the two modes of one kernel:
// - whole path: _pallas_insert_block (:803), body _insert_block_body
//   (:644), band primitives _build_ops (:125), _minplus_doubling (:87),
//   _first_min (:111); committed points go to a whole-path buffer;
// - delta: _pallas_insert_block_long (:959, kernel
//   _make_insert_kernel_long :878); the point committed at path index plen
//   goes to slot plen - plen0 of this launch's dx/dy rows (plen0: the
//   launch's starting plen), and the path lives on the host.  The TPU
//   kernel's sliding live window and reference DMA window only fit VMEM;
//   here the reference and the whole live history stay in device memory in
//   both modes, so the delta mode differs only in where points are stored.
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
// A band too wide for shared memory keeps its window in a global-memory
// workspace (w_work, one window per block, resident in L2 at these sizes):
// the same code over another pointer, the memory space a template
// parameter (see launch_band in otw_band.cuh).
//
// The band primitives and their numerics are in otw_band.cuh, shared with
// the whole-pair set_live kernel (otw_set_live.cu).

#include "otw_band.cuh"

namespace {

using namespace otw_band;

constexpr int S_T = 0, S_J = 1, S_RC = 2, S_PREV = 3, S_PLEN = 4, S_LASTX = 5,
              S_LASTY = 6, S_FIRST = 7, S_STOPPED = 8, S_DIR = 9, S_OVERFLOW = 10;

struct Params {
  float* w;            // (L, L) window, canonical layout, L = c + 1
  float* w_work;       // (L, L) global workspace (kSharedWindow false)
  const float* ref;    // (c + ref_len, f), c leading zero rows
  float* live;         // (c + live_cap, f)
  int* path_x;         // whole path: (p_len,) slots by path index; delta: this launch's dx
  int* path_y;
  int* scalars;        // int32[16]
  int* status;         // int32[8]
  const float* cols;   // (n_valid, f) rows to insert
  int c, f, p_len, live_cap, ref_len, n_valid;
  float sentinel;
  int max_run_count, monotone, euclidean, loop_iters;
  int delta;           // 1: path_x/path_y are per-launch delta rows of p_len slots
};

template <bool kSharedWindow>
__global__ void otw_insert_kernel(Params p) {
  extern __shared__ float smem[];
  const int c = p.c, L = c + 1, f = p.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool eu = p.euclidean != 0;
  const float sentinel = p.sentinel;

  float* W = kSharedWindow ? smem : p.w_work;           // L * L
  float* rbuf = kSharedWindow ? smem + L * L : smem;    // 2 * nt (ping-pong)
  float* cbuf = rbuf + 2 * nt;           // 2 * nt
  float* red_v = cbuf + 2 * nt;          // 2 * MAX_WARPS
  int* red_i = reinterpret_cast<int*>(red_v + 2 * MAX_WARPS);  // 2 * MAX_WARPS

  for (int i = tid; i < L * L; i += nt) W[i] = p.w[i];
  Ring ring{L, 0, 0};

  int t = p.scalars[S_T], j = p.scalars[S_J];
  Walk w{p.scalars[S_RC], p.scalars[S_PREV], p.scalars[S_PLEN], p.scalars[S_LASTX],
         p.scalars[S_LASTY]};
  bool first = p.scalars[S_FIRST] != 0, stopped = p.scalars[S_STOPPED] != 0;
  int direction = p.scalars[S_DIR];
  bool overflow = p.scalars[S_OVERFLOW] != 0;
  const int plen0 = w.plen;
  const int path_base = p.delta ? plen0 : 0;
  if (p.delta) {  // a fresh delta row: slots past this launch's points read 0
    for (int i = tid; i < p.p_len; i += nt) {
      p.path_x[i] = 0;
      p.path_y[i] = 0;
    }
  }
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
        row_update(W, ring, p.ref, p.live + (size_t)(t_new + c) * f, j, c, f, eu, sentinel,
                   rbuf, cbuf, nt);
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
        col_update(W, ring, p.live, p.ref + (size_t)(j + c) * f, t_new, c, f, eu, sentinel,
                   rbuf, cbuf, nt);
      }
      d = set_direction(W, ring, t_new, j, c, w, p.path_x, p.path_y, p.p_len, path_base,
                        p.monotone != 0, p.max_run_count, red_v, red_i);
      active = d == COL;
    }
    direction = d;
    overflow = overflow || active;  // loop bound violated (never, by design)
    t = t_new;
  }

  // a delta row holds at most p_len points: more would be lost, so they
  // raise the sticky overflow flag instead (never, by design)
  if (p.delta && w.plen - plen0 > p.p_len) overflow = true;

  __syncthreads();
  for (int i = tid; i < L * L; i += nt) p.w[i] = W[ring.at(i / L, i % L)];
  if (tid == 0) {
    p.scalars[S_T] = t; p.scalars[S_J] = j; p.scalars[S_RC] = w.rc; p.scalars[S_PREV] = w.prev;
    p.scalars[S_PLEN] = w.plen; p.scalars[S_LASTX] = w.lastx; p.scalars[S_LASTY] = w.lasty;
    p.scalars[S_FIRST] = first ? 1 : 0; p.scalars[S_STOPPED] = stopped ? 1 : 0;
    p.scalars[S_DIR] = direction; p.scalars[S_OVERFLOW] = overflow ? 1 : 0;
    p.status[0] = (stopped ? 1 : 0) | (overflow ? 2 : 0);
    p.status[1] = w.plen; p.status[2] = w.lastx; p.status[3] = w.lasty;
    p.status[4] = 0; p.status[5] = 0; p.status[6] = 0; p.status[7] = 0;
  }
}

}  // namespace

extern "C" int otw_insert_block(void* w, void* w_work, void* ref, void* live, void* path_x,
                                void* path_y, void* scalars, void* status, void* cols, int c,
                                int f, int p_len, int live_cap, int ref_len, int n_valid,
                                float sentinel, int max_run_count, int monotone, int euclidean,
                                int loop_iters, int delta, void* stream) {
  Params p{static_cast<float*>(w), static_cast<float*>(w_work), static_cast<const float*>(ref),
           static_cast<float*>(live), static_cast<int*>(path_x), static_cast<int*>(path_y),
           static_cast<int*>(scalars), static_cast<int*>(status), static_cast<const float*>(cols),
           c, f, p_len, live_cap, ref_len, n_valid, sentinel, max_run_count, monotone,
           euclidean, loop_iters, delta};
  const int nt = band_threads(c);
  const bool in_shared = w_work == nullptr;
  return launch_band(in_shared ? otw_insert_kernel<true> : otw_insert_kernel<false>, 1, nt,
                     shared_bytes(c, nt, in_shared), static_cast<cudaStream_t>(stream), p);
}

extern "C" const char* otw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
