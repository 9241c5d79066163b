// Whole-pair online-time-warping alignment (set_live) for a batch of B
// pairs in one launch, one warp per pair, for sm_90a.
//
// Replaces the TPU kernels real_time_audio_sync_tpu/ops/pallas_otw.py:
// _pallas_set_live (:387) and _pallas_batched_set_live (:505), both driven
// by _make_set_live_kernel (:296) over the band primitives _build_ops
// (:125).  A solo pair is B = 1.  The Python wrapper and the plain PyTorch
// version of the same algorithm are in ops/otw_set_live.py; the two agree
// bit for bit.  The band primitives are the warp-level ones of
// otw_band_warp.cuh over the per-cell numerics of otw_band.cuh, which the
// K-insert kernel shares.
//
// Per pair (set_live, otw_eran.py:91-142): live_cap = 2 ref_len; the window
// starts at the sentinel with acc[0,0] = cost(live 0, ref 0) at cell (c,c);
// then, until done: best point + append + direction; a row step unless the
// direction is COL (done when t+1 reaches live_len or live_cap, which also
// skips the column step); a column step unless it is ROW (done when j+1
// reaches ref_len).  Out: plen, t, j, stopped = j >= ref_len.
//
// Bound: neither bytes nor operations but the chain of dependent steps.  A
// pair is t + j band updates in a row, each needing the last one's window
// and argmin; its bytes (the feature rows, read once, and the path) and
// operations take well under a microsecond of the card, so what counts is
// the latency of one update.  The design takes off that chain what does
// not have to be on it:
// - one warp per pair (a block of 32 threads): band position p = 32k +
//   lane in register k (P registers, a template parameter), the min-plus
//   scan's ceil(log2(c+1)) stages as register shuffles and the two argmins
//   as an in-lane pass and 5 shuffle rounds, with no block barrier
//   anywhere; a __syncwarp after each shared-memory write is the only
//   ordering;
// - the (c+1)^2 window in shared memory with ring offsets (or, for a band
//   too wide for it, c >= 238 on an H100, in a global-memory workspace
//   slice, w_work), as in the K-insert kernel;
// - the band's feature rows in two rings in shared memory, read as
//   16-byte vectors, where a warp reads 32 positions' rows without a bank
//   conflict (from device memory the same read touches 32 sectors), the
//   entering row loaded into a register a step ahead; where the rings do
//   not fit beside the window (c = 229..237 on an H100) the rows are read
//   from device memory, the entering row prefetched into L1 a step ahead;
// - one cost kind and one home of the rows compiled into each kernel, and
//   one call site of the band update, so the step loop is about 600
//   instructions at P = 2: one warp alone on its SM pays for every
//   instruction it issues and every fetch that misses.
// Estimated latency at c = 50 (P = 2), in cycles at 1.98 GHz, from what
// one warp pays on this card (a shuffle ~26 cycles to its result and one
// issued every ~4; a scan stage of 2 registers ~48; a take_min round ~56):
// a band update ~650 (the advance, the costs from the rings and the cells
// ~350, 6 scan stages ~250, the write-back ~50) and a step's argmins and
// direction ~450, about 0.5 us an update against the block-level kernel's
// ~1.5 us (18 block barriers a two-update step).  The scan grows as ~29
// cycles a register a stage, so from P = 16 one warp's issue rate, not
// barriers, sets the time.  Pairs are independent blocks, each leaving on
// its own `done` (a ragged batch needs no grid-wide barrier); a shared
// reference is one copy in device memory that every block reads.

#include <cstdint>

#include "otw_band_warp.cuh"

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

template <int P, bool kSharedWindow, int kCost, bool kRing>
__global__ void __launch_bounds__(32) otw_set_live_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int c = p.c, L = c + 1, f = p.f;
  const int lane = threadIdx.x;
  const bool eu = p.euclidean != 0;
  const float sentinel = p.sentinel;

  float* W = kSharedWindow ? smem : p.w_work + (size_t)b * L * L;  // L * L
  float* rings = smem + (kSharedWindow ? ring_start(L * L) : 0);    // ring_floats(c) (kRing)

  const float* ref = p.ref + (p.shared_ref ? 0 : (size_t)b * p.ref_rows * f);
  const float* live = p.live + (size_t)b * p.live_rows * f;
  int* path_x = p.path_x + (size_t)b * p.p_len;
  int* path_y = p.path_y + (size_t)b * p.p_len;
  const int live_len = p.lens[2 * b], ref_len = p.lens[2 * b + 1];
  const int live_cap = 2 * ref_len;  // pre-allocated live capacity (otw_eran.py:14)
  const int live_end = min(live_len, live_cap);

  // the origin: acc[0,0] = cost(0,0) at cell (c,c), every other cell the sentinel
  for (int i = lane; i < L * L; i += 32) W[i] = sentinel;
  __syncwarp();
  if (lane == 0) W[c * L + c] = cost_of(live + (size_t)c * f, ref + (size_t)c * f, f, eu);
  BandRows<kRing> refs{ref, 0, f, L, 0, 0, 0.0f};
  BandRows<kRing> lives{live, L * RING_WIDTH, f, L, 0, 0, 0.0f};
  refs.fill(rings, lane);
  lives.fill(rings, lane);
  if (1 < ref_len) refs.fetch(lane);
  if (1 < live_end) lives.fetch(lane);
  __syncwarp();
  Ring ring{L, 0, 0};

  int t = 0, j = 0;
  Walk w{p.run_count_init, PREV_NONE, 0, -1, -1};
  bool done = false;
  const int n_steps = live_len + ref_len;  // every step advances t or j
  for (int s = 0; s < n_steps && !done; ++s) {
    const int d = warp_set_direction<P>(W, ring, t, j, c, w, path_x, path_y, p.p_len, 0, p.monotone != 0,
                                        p.max_run_count);
    // a row update unless d is COL, then a column update unless d is ROW;
    // one call site of the update, so its code is in the kernel once
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const bool row = u == 0;
      if (row ? d == COL : d == ROW) continue;
      if (row) {
        ++t;
        if (t >= live_len || t >= live_cap) {
          done = true;  // and no column step in this iteration
          break;
        }
        lives.advance(rings, lane);
      } else {
        ++j;
        if (j >= ref_len) {
          done = true;
          break;
        }
        refs.advance(rings, lane);
      }
      __syncwarp();
      if (row && t + 1 < live_end) lives.fetch(lane);
      if (!row && j + 1 < ref_len) refs.fetch(lane);
      warp_band_update<P, kCost, kRing>(W, ring, row, rings, row ? refs : lives, row ? lives : refs, row ? j : t,
                                        c, f, eu, sentinel);
    }
  }

  if (lane == 0) {
    int* out = p.out + (size_t)b * N_OUT;
    out[0] = w.plen;
    out[1] = t;
    out[2] = j;
    out[3] = j >= ref_len ? 1 : 0;
    for (int i = 4; i < N_OUT; ++i) out[i] = 0;
  }
}

using Kernel = void (*)(Params);

// A shared window exists up to c = 237 on an H100 (P <= 8), a global one
// from c = 238 (P >= 8); the rings fit beside a global window at every
// band and beside a shared one up to c = 228.  Each cost kind at width 12
// is compiled for those cases, a larger P than the band needs being as
// exact (its positions above c are never read); the fallback for any
// feature width reads its rows from device memory at the widest P of each
// route.
template <int kCost>
Kernel kernel_for(int regs, bool shared_window, bool ring) {
  if (shared_window) {
    if (!ring) return regs <= 8 ? otw_set_live_kernel<8, true, kCost, false> : nullptr;
    switch (regs) {
      case 1: return otw_set_live_kernel<1, true, kCost, true>;
      case 2: return otw_set_live_kernel<2, true, kCost, true>;
      case 4: return otw_set_live_kernel<4, true, kCost, true>;
      case 8: return otw_set_live_kernel<8, true, kCost, true>;
      default: return nullptr;
    }
  }
  if (!ring) return nullptr;
  switch (regs) {
    case 1: case 2: case 4: case 8: return otw_set_live_kernel<8, false, kCost, true>;
    case 16: return otw_set_live_kernel<16, false, kCost, true>;
    default: return otw_set_live_kernel<32, false, kCost, true>;
  }
}

// The kernel a launch at band c, feature width f and cost kind runs, and
// its dynamic shared bytes.  The window's route is the caller's (a
// workspace or none, as otw_band_workspace_floats decided).
int plan(int c, int f, bool euclidean, bool shared_window, bool aligned, Kernel* kernel, size_t* smem) {
  const int regs = warp_band_regs(c);
  if (regs == 0 || f < 1) return (int)cudaErrorInvalidValue;
  int device = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  // the width-12 kernels read rows as 16-byte vectors: their base must allow it
  const int cost = f != 12 || !aligned ? COST_ANY : euclidean ? COST_EU12 : COST_DOT12;
  const int window = shared_window ? (c + 1) * (c + 1) : 0;  // floats
  const size_t ring_bytes = sizeof(float) * (ring_start(window) + ring_floats(c));
  const bool ring = cost != COST_ANY && ring_bytes <= (size_t)limit;
  Kernel k = nullptr;
  if (cost == COST_ANY) {
    k = shared_window ? otw_set_live_kernel<8, true, COST_ANY, false> : otw_set_live_kernel<32, false, COST_ANY, false>;
  } else {
    k = cost == COST_DOT12 ? kernel_for<COST_DOT12>(regs, shared_window, ring)
                           : kernel_for<COST_EU12>(regs, shared_window, ring);
  }
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  *kernel = k;
  *smem = ring ? ring_bytes : sizeof(float) * window;
  return 0;
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
  Kernel kernel = nullptr;
  size_t smem = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(live)) & 15) == 0;
  const int err = plan(c, f, euclidean != 0, w_work == nullptr, aligned, &kernel, &smem);
  if (err != 0) return err;
  return launch_band(kernel, batch, 32, smem, static_cast<cudaStream_t>(stream), p);
}

extern "C" const char* otw_set_live_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
