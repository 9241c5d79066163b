// K streaming online-time-warping inserts per launch, one thread block per
// stream, for sm_90a.
//
// Replaces four TPU kernels of real_time_audio_sync_tpu/ops/pallas_otw.py,
// as one kernel over a grid of B streams in two modes:
// - whole path: _pallas_insert_block (:803, B = 1), body _insert_block_body
//   (:644), band primitives _build_ops (:125), _minplus_doubling (:87),
//   _first_min (:111), and _pallas_multi_insert_block (:1080, B streams);
//   committed points go to a whole-path buffer;
// - delta: _pallas_insert_block_long (:959, kernel
//   _make_insert_kernel_long :878; B = 1) and
//   _pallas_multi_insert_block_long (:1002, B streams); the point committed
//   at path index plen goes to slot plen - plen0 of this launch's dx/dy
//   rows (plen0: the launch's starting plen), and the path lives on the
//   host.  The TPU kernel's sliding live window and reference DMA window
//   only fit VMEM; here the reference and the whole live history stay in
//   device memory in both modes, so the delta mode differs only in where
//   points are stored.
// Block b is stream b and finds its state through per-stream strides; a
// shared reference has stride 0, so every block reads the one copy.  A solo
// launch is B = 1 with its lengths passed by value; a batched launch reads
// each stream's live capacity, reference length and insert count from
// device arrays, and a stream with count 0 runs no insert but still writes
// its status (and, in delta mode, a zeroed row with plen unchanged).
// The Python wrapper and the plain PyTorch version of the same algorithm are
// in ops/otw_insert.py; the two agree bit for bit.
//
// Bound: latency.  A launch is a serial chain of about K * loop_iters band
// steps over a few KB of state per stream, each step a (c+1)-wide cost, a
// min-plus scan and two argmins between block barriers.  So the (c+1)^2
// window lives in shared memory for the whole launch, advanced by ring
// offsets instead of the TPU's physical rolls (a band step touches O(c)
// cells); the scalar state machine lives in registers, computed identically
// by every thread from the same reduced values; device memory sees only the
// feature rows (F floats each), the path points and the window's load and
// store.  Streams are independent blocks, so a batch costs one launch and
// runs in waves of blocks over the SMs.
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
constexpr size_t N_SCALARS = 16;  // int32 scalar slots per stream

struct Params {
  float* w;            // (B, L, L) windows, canonical layout, L = c + 1
  float* w_work;       // (B, L, L) global workspace (kSharedWindow false)
  const float* ref;    // (R, c + n_max, f), c leading zero rows; R = 1 (stride 0) or B
  float* live;         // (B, c + live rows, f)
  int* path_x;         // whole path: (B, p_len) slots by path index; delta: this launch's dx
  int* path_y;
  int* scalars;        // (B, 16) int32
  int* status;         // (B, 8) int32, or inside each stream's delta row
  const float* cols;   // (B, cols_rows, f) rows to insert
  const int* lens;     // (B, 2): live_cap, ref_len; null for a solo launch (the values below)
  const int* ks;       // (B,): rows of cols to insert; null for a solo launch
  int c, f, p_len, live_cap, ref_len, n_valid;
  float sentinel;
  int max_run_count, monotone, euclidean, loop_iters;
  int delta;           // 1: path_x/path_y are per-launch delta rows of p_len slots
  // per-stream strides, in elements
  size_t ref_stride, live_stride, path_stride, status_stride, cols_stride;
  int cols_rows;
};

template <bool kSharedWindow>
__global__ void otw_insert_kernel(Params p) {
  extern __shared__ float smem[];
  const int c = p.c, L = c + 1, f = p.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool eu = p.euclidean != 0;
  const float sentinel = p.sentinel;

  // stream b's state
  const size_t b = blockIdx.x;
  float* win = p.w + b * L * L;
  float* W = kSharedWindow ? smem : p.w_work + b * L * L;  // L * L
  float* rbuf = kSharedWindow ? smem + L * L : smem;      // 2 * nt (ping-pong)
  float* cbuf = rbuf + 2 * nt;           // 2 * nt
  float* red_v = cbuf + 2 * nt;          // 2 * MAX_WARPS
  int* red_i = reinterpret_cast<int*>(red_v + 2 * MAX_WARPS);  // 2 * MAX_WARPS
  const float* ref = p.ref + b * p.ref_stride;
  float* live = p.live + b * p.live_stride;
  int* path_x = p.path_x + b * p.path_stride;
  int* path_y = p.path_y + b * p.path_stride;
  int* scalars = p.scalars + b * N_SCALARS;
  int* status = p.status + b * p.status_stride;
  const float* cols = p.cols + b * p.cols_stride;
  int live_cap = p.live_cap, ref_len = p.ref_len, n_valid = p.n_valid;
  if (p.lens != nullptr) {
    live_cap = p.lens[2 * b];
    ref_len = p.lens[2 * b + 1];
    n_valid = min(p.ks[b], p.cols_rows);
  }

  for (int i = tid; i < L * L; i += nt) W[i] = win[i];
  Ring ring{L, 0, 0};

  int t = scalars[S_T], j = scalars[S_J];
  Walk w{scalars[S_RC], scalars[S_PREV], scalars[S_PLEN], scalars[S_LASTX], scalars[S_LASTY]};
  bool first = scalars[S_FIRST] != 0, stopped = scalars[S_STOPPED] != 0;
  int direction = scalars[S_DIR];
  bool overflow = scalars[S_OVERFLOW] != 0;
  const int plen0 = w.plen;
  const int path_base = p.delta ? plen0 : 0;
  if (p.delta) {  // a fresh delta row: slots past this launch's points read 0
    for (int i = tid; i < p.p_len; i += nt) {
      path_x[i] = 0;
      path_y[i] = 0;
    }
  }
  __syncthreads();

  for (int k = 0; k < n_valid && !stopped; ++k) {
    const float* col = cols + (size_t)k * f;
    int t_new = t;
    bool do_row = false;
    if (first) {
      // first insert: live row 0 <- col, acc[0,0] = cost(0,0) at cell (c,c)
      for (int i = tid; i < f; i += nt) live[(size_t)c * f + i] = col[i];
      __syncthreads();
      if (tid <= c) {
        float v = sentinel;
        if (tid == c) v = cost_of(live + (size_t)c * f, ref + (size_t)c * f, f, eu);
        W[ring.at(c, tid)] = v;
      }
      __syncthreads();
      first = false;
    } else {
      t_new = t + 1;
      do_row = t_new < live_cap;  // else "ran out of room": t advances only
      if (do_row) {
        for (int i = tid; i < f; i += nt) live[(size_t)(t_new + c) * f + i] = col[i];
        __syncthreads();
        row_update(W, ring, ref, live + (size_t)(t_new + c) * f, j, c, f, eu, sentinel, rbuf, cbuf,
                   nt);
      }
    }

    // column phase: at most loop_iters (column step, direction) rounds
    bool active = do_row;
    int d = direction;
    for (int it = 0; it < p.loop_iters && active; ++it) {
      if (d != ROW) {
        ++j;
        if (j >= ref_len) {  // past the end of the reference: stop, frozen
          stopped = true;
          active = false;
          break;
        }
        col_update(W, ring, live, ref + (size_t)(j + c) * f, t_new, c, f, eu, sentinel, rbuf, cbuf,
                   nt);
      }
      d = set_direction(W, ring, t_new, j, c, w, path_x, path_y, p.p_len, path_base,
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
  for (int i = tid; i < L * L; i += nt) win[i] = W[ring.at(i / L, i % L)];
  if (tid == 0) {
    scalars[S_T] = t; scalars[S_J] = j; scalars[S_RC] = w.rc; scalars[S_PREV] = w.prev;
    scalars[S_PLEN] = w.plen; scalars[S_LASTX] = w.lastx; scalars[S_LASTY] = w.lasty;
    scalars[S_FIRST] = first ? 1 : 0; scalars[S_STOPPED] = stopped ? 1 : 0;
    scalars[S_DIR] = direction; scalars[S_OVERFLOW] = overflow ? 1 : 0;
    status[0] = (stopped ? 1 : 0) | (overflow ? 2 : 0);
    status[1] = w.plen; status[2] = w.lastx; status[3] = w.lasty;
    status[4] = 0; status[5] = 0; status[6] = 0; status[7] = 0;
  }
}

int launch(const Params& p, int batch, void* stream) {
  const int nt = band_threads(p.c);
  const bool in_shared = p.w_work == nullptr;
  return launch_band(in_shared ? otw_insert_kernel<true> : otw_insert_kernel<false>, batch, nt,
                     shared_bytes(p.c, nt, in_shared), static_cast<cudaStream_t>(stream), p);
}

}  // namespace

// One stream (kernels #1 and #4): lengths by value, B = 1.
extern "C" int otw_insert_block(void* w, void* w_work, void* ref, void* live, void* path_x,
                                void* path_y, void* scalars, void* status, void* cols, int c,
                                int f, int p_len, int live_cap, int ref_len, int n_valid,
                                float sentinel, int max_run_count, int monotone, int euclidean,
                                int loop_iters, int delta, void* stream) {
  Params p{static_cast<float*>(w), static_cast<float*>(w_work), static_cast<const float*>(ref),
           static_cast<float*>(live), static_cast<int*>(path_x), static_cast<int*>(path_y),
           static_cast<int*>(scalars), static_cast<int*>(status), static_cast<const float*>(cols),
           nullptr, nullptr, c, f, p_len, live_cap, ref_len, n_valid, sentinel, max_run_count,
           monotone, euclidean, loop_iters, delta, 0, 0, 0, 0, 0, n_valid};
  return launch(p, 1, stream);
}

// B streams (kernels #5 and #6): lens (B, 2) and ks (B,) on the device;
// strides in elements between one stream's rows and the next's (ref_stride
// 0 for a shared reference).
extern "C" int otw_multi_insert_block(void* w, void* w_work, void* ref, void* live, void* path_x,
                                      void* path_y, void* scalars, void* status, void* cols,
                                      void* lens, void* ks, int batch, int c, int f, int p_len,
                                      float sentinel, int max_run_count, int monotone,
                                      int euclidean, int loop_iters, int delta,
                                      long long ref_stride, long long live_stride,
                                      long long path_stride, long long status_stride,
                                      int cols_rows, void* stream) {
  Params p{static_cast<float*>(w), static_cast<float*>(w_work), static_cast<const float*>(ref),
           static_cast<float*>(live), static_cast<int*>(path_x), static_cast<int*>(path_y),
           static_cast<int*>(scalars), static_cast<int*>(status), static_cast<const float*>(cols),
           static_cast<const int*>(lens), static_cast<const int*>(ks), c, f, p_len, 0, 0, 0,
           sentinel, max_run_count, monotone, euclidean, loop_iters, delta, (size_t)ref_stride,
           (size_t)live_stride, (size_t)path_stride, (size_t)status_stride,
           (size_t)cols_rows * f, cols_rows};
  return launch(p, batch, stream);
}

extern "C" const char* otw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
