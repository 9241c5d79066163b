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
// updates over a few KB of state per stream, each a (c+1)-wide cost, a
// min-plus scan and two argmins that need the last update's window; its
// bytes (the window in and out, the feature rows, the points) and
// operations take well under a microsecond of the card.  So the (c+1)^2
// window lives in shared memory for the whole launch, advanced by ring
// offsets instead of the TPU's physical rolls (a band update touches O(c)
// cells), and the scalar state machine lives in registers.  A band too wide
// for shared memory (c >= 238 on an H100) keeps its window in a
// global-memory workspace (w_work, one window per block, resident in L2 at
// these sizes): the same code over another pointer, the memory space a
// template parameter (see launch_band in otw_band.cuh).
//
// Two kernels, chosen by band and feature width (plan() below):
// - otw_insert_kernel_warp, wherever the band has at most 8 registers a
//   lane (c <= 255) and the features are chroma (width 12).  One warp runs
//   the stream's chain of inserts on the warp primitives of
//   otw_band_warp.cuh, shared with the set_live kernel: band position
//   32k + lane in register k, the scan and the argmins as shuffles, no
//   block barrier inside the chain.  The band's feature rows sit in two
//   shared-memory rings (reference frames j-c..j and live frames t-c..t),
//   filled at the launch's start, read as 16-byte vectors; the entering
//   reference row is fetched a step ahead, and the entering live row is
//   the inserted column itself (loaded an insert ahead), which also goes
//   to `live` in device memory for later launches.  Where the rings do not
//   fit beside a shared window (c = 229..237 on an H100) the rows are read
//   from device memory as 16-byte vectors, the entering reference row
//   prefetched into L1, if every stream's rows start on a 16-byte
//   boundary (else the block kernel runs).  Each kernel is compiled for
//   one cost kind and one home of the rows, and the row and column updates
//   share one call site, so the step loop stays small (one warp alone on
//   its SM waits on every instruction fetch).  The launch's O(c^2) part,
//   the window's copy in (cp.async into a shared window) and out, the ring
//   fill and the delta row's zeroing, is shared by the block's other
//   warps: they meet warp 0 at one barrier, wait at a second while it runs
//   the chain, and copy out.  Measured on an H100 at c = 50, k_block 8:
//   ~0.018 ms a launch against ~0.029 for the block kernel, and faster at
//   every band up to 255 (PERF.md).
// - otw_insert_kernel, one thread per band position over the block
//   primitives of otw_band.cuh (a block barrier between the cells, at each
//   scan stage and around each argmin), for everything else: c >= 256,
//   where one warp's issue rate at 16 or 32 registers a lane is slower
//   than the block's warps side by side, and any feature width other than
//   12.
// The band primitives and their numerics are in otw_band.cuh and
// otw_band_warp.cuh, shared with the whole-pair set_live kernel
// (otw_set_live.cu), so every kernel computes every cell alike.

#include <cuda_pipeline.h>

#include "otw_band_warp.cuh"

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

// ---------------------------------------------------------------------------
// c <= 255: one warp runs the chain (see the note at the top)
// ---------------------------------------------------------------------------

// Threads of a warp kernel's block: warp 0 runs the chain, and every warp
// shares the window's copy in and out; one per band position, as the block
// kernel has (one warp copying the window alone was slower: PERF.md).  The
// kernel's launch bound names one block an SM: without it, ptxas held the
// P = 8 kernels to 128 registers, and they spilled.
constexpr int WARP_KERNEL_MAX_THREADS = 256;  // band_threads(255)

// Copy rows of the window between device memory and the kernel's window,
// one row a warp at a time, each lane with its (at most 8: c <= 255)
// positions' loads in flight before it stores: the loads of a row do not
// wait on its stores (the two windows may not alias as far as the compiler
// knows).  Row a of dst is row (a + ro) mod L of src, position q is
// (q + co) mod L: the ring offsets of the copy out, 0 for the copy in.
__device__ __forceinline__ void copy_window(float* dst, const float* src, int L, int ro, int co, int lane,
                                            int warp, int nwarps) {
  for (int a = warp; a < L; a += nwarps) {
    const int pa = a + ro < L ? a + ro : a + ro - L;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = lane + 32 * u, pb = q + co < L ? q + co : q + co - L;
      if (q < L) v[u] = src[pa * L + pb];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = lane + 32 * u;
      if (q < L) dst[a * L + q] = v[u];
    }
  }
}

// Shared floats of a warp kernel's block before the handoff slots (two ints:
// the window's ring offsets, from warp 0 to the copy out): the window when
// it is shared, rounded to 16 bytes, then the two rings when the rows are
// kept there.
constexpr int HANDOFF_FLOATS = 4;
__host__ __device__ inline int warp_smem_floats(int c, bool shared_window, bool ring) {
  const int L = c + 1;
  return ring_start(shared_window ? L * L : 0) + (ring ? 2 * L * RING_WIDTH : 0);
}

// kCost: COST_DOT12 or COST_EU12 (rows of 12 floats).  kRing: the band's
// rows in the shared-memory rings; else read from device memory as 16-byte
// vectors (the launch checks the bases and strides allow it).
template <int P, bool kSharedWindow, int kCost, bool kRing>
__global__ void __launch_bounds__(WARP_KERNEL_MAX_THREADS, 1) otw_insert_kernel_warp(Params p) {
  extern __shared__ float smem[];
  const int c = p.c, L = c + 1, f = RING_WIDTH;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const bool eu = kCost == COST_EU12;
  const float sentinel = p.sentinel;

  // stream b's state
  const size_t b = blockIdx.x;
  float* win = p.w + b * L * L;
  float* W = kSharedWindow ? smem : p.w_work + b * L * L;  // L * L
  float* rings = smem + ring_start(kSharedWindow ? L * L : 0);  // 2 * L * RING_WIDTH (kRing)
  int* handoff = reinterpret_cast<int*>(smem + warp_smem_floats(c, kSharedWindow, kRing));
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
  const int t0 = scalars[S_T], j0 = scalars[S_J];
  const bool updates = n_valid > 0 && scalars[S_STOPPED] == 0;  // a band update may follow
  BandRows<kRing> refs{ref, 0, f, L, j0, 0, 0.0f};                // frames j-c..j
  BandRows<kRing> lives{live, L * RING_WIDTH, f, L, t0, 0, 0.0f};  // frames t-c..t

  // every warp: the window in, the rings, a fresh delta row, the copies
  // into shared memory asynchronous (no register holds a float on its
  // way).  The rings take rows base..base+c, which exist only while an
  // update can follow: the reference's while j < ref_len (the stream has
  // not stopped), the live history's while t + 1 < live_cap (else each
  // insert only counts a hop, and no update follows)
  if (kSharedWindow) {
    for (int i = tid; i < L * L; i += nt) __pipeline_memcpy_async(W + i, win + i, sizeof(float));
  } else {
    copy_window(W, win, L, 0, 0, lane, warp, nwarps);
  }
  if (kRing && updates) {
    const float* src = ref + (size_t)j0 * f;
    for (int i = tid; i < L * f; i += nt) __pipeline_memcpy_async(rings + refs.off + i, src + i, sizeof(float));
  }
  if (kRing && updates && t0 + 1 < live_cap) {
    const float* src = live + (size_t)t0 * f;
    for (int i = tid; i < L * f; i += nt) __pipeline_memcpy_async(rings + lives.off + i, src + i, sizeof(float));
  }
  __pipeline_commit();
  if (p.delta) {  // slots past this launch's points read 0
    for (int i = tid; i < p.p_len; i += nt) {
      path_x[i] = 0;
      path_y[i] = 0;
    }
  }
  // warp 0's first operands, in flight across the barrier: the first
  // inserted column (element `lane` in lanes < 12; then an insert ahead)
  // and the row the first column update brings in (then an update ahead)
  float col_next = 0.0f;
  if (warp == 0 && lane < f && n_valid > 0) col_next = cols[lane];
  if (warp == 0 && updates && j0 + 1 < ref_len) refs.fetch(lane);
  __pipeline_wait_prior(0);
  __syncthreads();

  if (warp == 0) {  // the chain; the other warps wait at the barrier below
    Ring ring{L, 0, 0};
    int t = t0, j = j0;
    Walk w{scalars[S_RC], scalars[S_PREV], scalars[S_PLEN], scalars[S_LASTX], scalars[S_LASTY]};
    bool first = scalars[S_FIRST] != 0, stopped = scalars[S_STOPPED] != 0;
    int direction = scalars[S_DIR];
    bool overflow = scalars[S_OVERFLOW] != 0;
    const int plen0 = w.plen;
    const int path_base = p.delta ? plen0 : 0;

    for (int k = 0; k < n_valid && !stopped; ++k) {
      const float* col = cols + (size_t)k * f;
      const float colv = col_next;
      if (lane < f && k + 1 < n_valid) col_next = col[f + lane];
      int t_new = t;
      bool row = false;
      if (first) {
        // first insert: live row 0 <- col, acc[0,0] = cost(0,0) at cell
        // (c,c); it comes before any advance, so live row c is ring slot c
        if (lane < f) {
          live[(size_t)c * f + lane] = colv;
          if (kRing) rings[lives.off + c * RING_WIDTH + lane] = colv;
        }
        for (int q = lane; q <= c; q += 32)
          W[ring.at(c, q)] = q == c ? cost_of(col, ref + (size_t)c * f, f, eu) : sentinel;
        __syncwarp();
        first = false;
      } else {
        t_new = t + 1;
        row = t_new < live_cap;  // else "ran out of room": t advances only
      }

      // the row update, then at most loop_iters (column step, direction)
      // rounds; one call site of the band update, so its code is in the
      // kernel once
      bool active = row;
      int d = direction;
      int it = 0;
#pragma unroll 1
      while (active) {
        if (!row && it == p.loop_iters) break;
        if (row || d != ROW) {
          if (row) {  // the inserted column enters the live ring, and the history
            if (lane < f) live[(size_t)(t_new + c) * f + lane] = colv;
            lives.next = colv;
            lives.advance(rings, lane);
          } else {
            ++j;
            if (j >= ref_len) {  // past the end of the reference: stop, frozen
              stopped = true;
              active = false;
              break;
            }
            refs.advance(rings, lane);
          }
          __syncwarp();
          if (!row && j + 1 < ref_len) refs.fetch(lane);
          warp_band_update<P, kCost, kRing>(W, ring, row, rings, row ? refs : lives, row ? lives : refs,
                                           row ? j : t_new, c, f, eu, sentinel);
        }
        if (row) {
          row = false;
          continue;
        }
        d = warp_set_direction<P>(W, ring, t_new, j, c, w, path_x, path_y, p.p_len, path_base, p.monotone != 0,
                                  p.max_run_count);
        active = d == COL;
        ++it;
      }
      direction = d;
      overflow = overflow || active;  // loop bound violated (never, by design)
      t = t_new;
    }

    // a delta row holds at most p_len points: more would be lost, so they
    // raise the sticky overflow flag instead (never, by design)
    if (p.delta && w.plen - plen0 > p.p_len) overflow = true;
    if (lane == 0) {
      handoff[0] = ring.ro;
      handoff[1] = ring.co;
      scalars[S_T] = t; scalars[S_J] = j; scalars[S_RC] = w.rc; scalars[S_PREV] = w.prev;
      scalars[S_PLEN] = w.plen; scalars[S_LASTX] = w.lastx; scalars[S_LASTY] = w.lasty;
      scalars[S_FIRST] = first ? 1 : 0; scalars[S_STOPPED] = stopped ? 1 : 0;
      scalars[S_DIR] = direction; scalars[S_OVERFLOW] = overflow ? 1 : 0;
      status[0] = (stopped ? 1 : 0) | (overflow ? 2 : 0);
      status[1] = w.plen; status[2] = w.lastx; status[3] = w.lasty;
      status[4] = 0; status[5] = 0; status[6] = 0; status[7] = 0;
    }
  }
  __syncthreads();

  // every warp: the window out, in canonical order
  copy_window(win, W, L, handoff[0], handoff[1], lane, warp, nwarps);
}

using Kernel = void (*)(Params);

// Routes of a launch (otw_insert_plan reports them).
constexpr int ROUTE_BLOCK = 0, ROUTE_WARP = 1, ROUTE_WARP_DEVICE_ROWS = 2;

// The warp kernel of a cost kind: a shared window up to c = 237 on an H100
// (P = 1, 2, 4, 8; P = 8 with the rows in device memory where the rings do
// not fit beside it), a global one from c = 238 (P = 8).
template <int kCost>
Kernel warp_kernel_for(int regs, bool shared_window, bool ring) {
  if (!shared_window) return otw_insert_kernel_warp<8, false, kCost, true>;
  if (!ring) return otw_insert_kernel_warp<8, true, kCost, false>;
  switch (regs) {
    case 1: return otw_insert_kernel_warp<1, true, kCost, true>;
    case 2: return otw_insert_kernel_warp<2, true, kCost, true>;
    case 4: return otw_insert_kernel_warp<4, true, kCost, true>;
    default: return otw_insert_kernel_warp<8, true, kCost, true>;
  }
}

struct Plan {
  Kernel kernel;
  int threads;
  size_t smem;
  int route;
};

// The kernel a launch at band c, feature width f and cost kind runs, its
// threads a block and dynamic shared bytes; the window's route is the
// caller's (a workspace or none, as otw_band_workspace_floats decided).
// The warp kernel at most 8 band registers a lane (c <= 255) and the
// chroma width 12: its rows in rings where they fit beside the window (on
// an H100 up to c = 228 beside a shared window, and beside every global
// one), else from device memory where the rows allow 16-byte loads
// (`aligned`).  Everything else runs the block kernel.
int plan(int c, int f, bool euclidean, bool shared_window, bool aligned, Plan* out) {
  const int regs = warp_band_regs(c);
  auto warp_smem = [&](bool ring) {
    return sizeof(float) * (warp_smem_floats(c, shared_window, ring) + HANDOFF_FLOATS);
  };
  bool warp = regs != 0 && regs <= 8 && f == RING_WIDTH, ring = true;
  if (warp) {
    int device = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return (int)e;
    ring = warp_smem(true) <= (size_t)limit;
    warp = ring || (aligned && warp_smem(false) <= (size_t)limit);
  }
  if (!warp) {
    const int nt = band_threads(c);
    *out = {shared_window ? otw_insert_kernel<true> : otw_insert_kernel<false>, nt,
            shared_bytes(c, nt, shared_window), ROUTE_BLOCK};
    return 0;
  }
  const Kernel k = euclidean ? warp_kernel_for<COST_EU12>(regs, shared_window, ring)
                             : warp_kernel_for<COST_DOT12>(regs, shared_window, ring);
  *out = {k, band_threads(c), warp_smem(ring), ring ? ROUTE_WARP : ROUTE_WARP_DEVICE_ROWS};
  return 0;
}

int launch(const Params& p, int batch, void* stream) {
  // the rows of every stream start on a 16-byte boundary (rows of 12
  // floats then keep it), as reading them from device memory as vectors
  // needs
  const bool aligned = ((reinterpret_cast<uintptr_t>(p.ref) | reinterpret_cast<uintptr_t>(p.live)) & 15) == 0 &&
                       (p.ref_stride % 4 | p.live_stride % 4) == 0;
  Plan pl;
  const int err = plan(p.c, p.f, p.euclidean != 0, p.w_work == nullptr, aligned, &pl);
  if (err != 0) return err;
  return launch_band(pl.kernel, batch, pl.threads, pl.smem, static_cast<cudaStream_t>(stream), p);
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

// The route a launch at band c and feature width f takes on the current
// device, its window where otw_band_workspace_floats puts it: out =
// {route (0: the block kernel, 1: the warp kernel), threads a block,
// dynamic shared bytes, blocks an SM (the occupancy calculator)}.  Returns a
// CUDA error code (0 on success).
extern "C" int otw_insert_plan(int c, int f, int euclidean, int* out) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  const int floats = otw_band_workspace_floats(c, device);
  if (floats < 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = plan(c, f, euclidean != 0, floats == 0, true, &pl);
  if (err != 0) return err;
  if (pl.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pl.kernel, pl.threads, pl.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = pl.route;
  out[1] = pl.threads;
  out[2] = (int)pl.smem;
  out[3] = blocks;
  return 0;
}

extern "C" const char* otw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
