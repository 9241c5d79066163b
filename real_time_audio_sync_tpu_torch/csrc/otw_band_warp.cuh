// Warp-level band primitives of the online-time-warping recurrence: one
// warp runs one alignment, with the band's positions in registers, the
// min-plus scan and the argmins as register shuffles, and no block barrier.
// The whole-pair set_live kernel (otw_set_live.cu) runs on them, and so
// does the K-insert kernel (otw_insert.cu) up to c = 255; above it keeps
// the block-level primitives of otw_band.cuh.  The per-cell numerics
// (cost_of, take_min), the window's ring offsets (Ring), the walk's scalar
// state (Walk) and the launch helper stay one copy there, so every kernel
// computes every cell alike.
//
// Counterpart of the TPU kernels' shared primitives in
// real_time_audio_sync_tpu/ops/pallas_otw.py: _build_ops (:125) —
// row_update, col_update, best_point, append_point, set_direction —
// _minplus_doubling (:87) and _first_min (:111).
//
// Layout: band position p = k*32 + lane sits in register k of lane `lane`,
// for k < P, the number of 32-position groups of the band c+1 rounded up to
// a power of two (warp_band_regs; P <= 32, so c <= 1023).  Positions above
// c hold values that no position <= c ever reads; their loads read
// position c instead, so every load is in bounds and the code has no
// branch per position.  Every lane runs the same scalar state machine from
// the same broadcast values; __syncwarp orders a lane's shared-memory
// writes before another lane reads them.
//
// The scan keeps _minplus_doubling's stages: at shift s every position
// p >= s combines with p - s, with the same operands in the same order as
// band_step.  For s < 32 the source is register k of lane (lane - s) mod 32
// when lane >= s and register k-1 of that lane otherwise, one __shfl_sync of
// each register; for s = 32q it is register k - q of the same lane.  So
// every cell is bit-identical to the block-level kernel's and the plain
// version's.
//
// One warp alone on its SM waits on every instruction, so the step loop is
// kept small and free of branches per position: each kernel is compiled
// for one cost kind (kCost) and one home of the feature rows (kRing), the
// row and column updates share one body, and the registers are indexed by
// constants (static_for).

#pragma once

#include <type_traits>
#include <utility>

#include "otw_band.cuh"

namespace otw_band {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_WARP_REGS = 32;

// The cost kinds a kernel is compiled for: the dot and the Euclidean cost
// at the chroma width 12 (the feature width of every engine here), and
// either cost at any width.
constexpr int COST_DOT12 = 0, COST_EU12 = 1, COST_ANY = 2;

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// f(std::integral_constant<int, K>{}) for K = 0..N-1: the band registers are
// indexed by constants by construction, so they stay registers at every P
// (a loop the compiler declines to unroll would index them at run time and
// move them to local memory).
template <typename F, int... K>
__device__ __forceinline__ void static_for_impl(F& f, std::integer_sequence<int, K...>) {
  (f(std::integral_constant<int, K>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// Registers a lane holds for band c (P above), or 0 when the band is wider
// than one warp's 32 x 32 positions.
inline int warp_band_regs(int c) {
  const int groups = (c + 1 + 31) / 32;
  int p = 1;
  while (p < groups) p <<= 1;
  return p <= MAX_WARP_REGS ? p : 0;
}

// The feature rings are kept for the chroma width 12: rows of 48 bytes,
// read as three 16-byte loads each (a warp's 8-lane phases of such loads at
// a 48-byte stride hit distinct banks).  Shared-memory floats of the two
// rings of band c, and where they start after a shared window of `window`
// floats (16-byte aligned).
constexpr int RING_WIDTH = 12;
inline size_t ring_floats(int c) { return 2 * (size_t)(c + 1) * RING_WIDTH; }
__host__ __device__ inline int ring_start(int window) { return (window + 3) & ~3; }

// The feature rows of one band, padded rows base..base+c (reference frames
// j-c..j, or live frames t-c..t).  kRing (f = RING_WIDTH): a ring of c+1
// rows in shared memory, `off` floats into the kernel's rings (`rings`),
// row base+k in slot (head + k) mod (c+1); the row the next advance brings
// in is loaded into a register (lane i < f holds element i) right after
// the previous advance, so its device-memory latency is off the chain of
// dependent steps.  Otherwise the rows are read where they lie in device
// memory, and the entering row is prefetched into L1 at that point.  The
// ring is named by an offset, not a pointer, so that a row's address stays
// a shared-memory one when the update picks one band or the other.
template <bool kRing>
struct BandRows {
  const float* rows;  // padded rows in device memory, f floats each
  int off, f, L, base, head;
  float next;

  // The row of band position k (0 <= k <= c).
  __device__ __forceinline__ const float* row(const float* rings, int k) const {
    if (kRing) {
      int s = head + k;
      if (s >= L) s -= L;
      return rings + off + s * RING_WIDTH;
    }
    return rows + (size_t)(base + k) * f;
  }

  // Load rows 0..c into the ring (base 0).
  __device__ __forceinline__ void fill(float* rings, int lane) {
    if (kRing) {
      for (int i = lane; i < L * RING_WIDTH; i += 32) rings[off + i] = rows[i];
    }
  }

  // Fetch row base+c+1, the one the next advance brings in; the caller
  // asks only when that advance can happen (the row then exists).
  __device__ __forceinline__ void fetch(int lane) {
    const float* src = rows + (size_t)(base + L) * f;
    if (kRing) {
      if (lane < f) next = src[lane];
    } else {
      for (int i = lane; i < f; i += 32) asm volatile("prefetch.global.L1 [%0];" ::"l"(src + i));
    }
  }

  // Move the band one row on: row base+c+1 takes the slot of row base.
  // The caller __syncwarp()s before any lane reads the new row.
  __device__ __forceinline__ void advance(float* rings, int lane) {
    if (kRing) {
      if (lane < RING_WIDTH) rings[off + head * RING_WIDTH + lane] = next;
      head = head + 1 == L ? 0 : head + 1;
    }
    ++base;
  }
};

// The 12 floats at src (16-byte aligned: a ring row, or a row of padded
// rows whose base is, as the launch checks) into registers, as three
// 16-byte loads.
__device__ __forceinline__ void load12(const float* src, float (&x)[12]) {
  const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 a = v[i];
    x[4 * i] = a.x;
    x[4 * i + 1] = a.y;
    x[4 * i + 2] = a.z;
    x[4 * i + 3] = a.w;
  }
}

// cost_of for a kernel compiled for one cost kind, against the new frame's
// row held in registers (fx, at width 12) or in memory (fixed, any width).
template <int kCost>
__device__ __forceinline__ float band_cost(const float* row, const float (&fx)[12], const float* fixed, int f,
                                           bool euclidean) {
  if (kCost == COST_ANY) return cost_of(row, fixed, f, euclidean);
  float x[12];
  load12(row, x);
  return cost_of(x, fx, 12, kCost == COST_EU12);
}

// One cell of band_step before the scan: (bm, cm) at position p.
__device__ __forceinline__ void band_cell(float cost, float prev, float diag, int p, int lo, float init,
                                          float& bm, float& cm) {
  const float inf = __int_as_float(0x7f800000);
  const bool band = p >= lo;
  const float bvec = fminf(__fadd_rn(prev, cost), __fadd_rn(diag, __fmul_rn(2.0f, cost)));
  bm = band ? bvec : inf;
  cm = band ? cost : inf;
  if (p == lo) bm = fminf(bm, __fadd_rn(init, cm));
}

// The min-plus scan of band_step over the warp's registers (the stages
// above), in place on r (values) and cv (cost sums).
template <int P>
__device__ __forceinline__ void warp_minplus_scan(float (&r)[P], float (&cv)[P], int c) {
  const int lane = threadIdx.x & 31;
  // Every stage runs: one with a shift s > c changes only positions >= s,
  // all above c, so the stages that matter are _minplus_doubling's.
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int s = 1 << e;
    const int src = (lane - s) & 31;
    const bool same = lane >= s;  // p - s is register k of lane src; else register k-1 of it
    float r_lo = 0.0f, c_lo = 0.0f;
    static_for<P>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      const float r_sh = __shfl_sync(FULL_MASK, r[k], src);
      const float c_sh = __shfl_sync(FULL_MASK, cv[k], src);
      if (same || k > 0) {  // position p - s >= 0
        r[k] = fminf(r[k], __fadd_rn(same ? r_sh : r_lo, cv[k]));
        cv[k] = __fadd_rn(same ? c_sh : c_lo, cv[k]);
      }
      r_lo = r_sh;
      c_lo = c_sh;
    });
  }
  static_for<log2_of(P)>([&](auto ec) {
    constexpr int q = 1 << decltype(ec)::value;
    // descending: register k - q is still the last stage's
    static_for<P - q>([&](auto ic) {
      constexpr int k = P - 1 - decltype(ic)::value;
      r[k] = fminf(r[k], __fadd_rn(r[k - q], cv[k]));
      cv[k] = __fadd_rn(cv[k - q], cv[k]);
    });
  });
}

// One band update after the moving band has advanced: a row (row_update:
// live frame t against reference frames j-c..j; `band` the reference rows,
// `moved` the live rows, `other` = j) or a column (col_update: reference
// frame j against live frames t-c..t; `band` the live rows, `moved` the
// reference rows, `other` = t).  Advances the window's ring offset,
// evaluates the band from window line c-1, scans it and writes it as line
// c.  Ends after a __syncwarp.
template <int P, int kCost, bool kRing>
__device__ inline void warp_band_update(float* W, Ring& ring, bool row, const float* rings,
                                        const BandRows<kRing> band, const BandRows<kRing> moved, int other,
                                        int c, int f, bool eu, float sentinel) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const int L = c + 1;
  if (row) {
    ring.ro = (ring.ro + 1 == L) ? 0 : ring.ro + 1;
  } else {
    ring.co = (ring.co + 1 == L) ? 0 : ring.co + 1;
  }
  // window lines c-1 and c (rows, or columns): position p at q(p) * step,
  // q(p) = (p + off) mod L, as Ring::at
  const int off = row ? ring.co : ring.ro;
  int a_prev = (row ? ring.ro : ring.co) + c - 1;
  if (a_prev >= L) a_prev -= L;
  const int a_new = a_prev + 1 == L ? 0 : a_prev + 1;
  const int step = row ? 1 : L, across = row ? L : 1;
  const float* prev_line = W + a_prev * across;
  float* new_line = W + a_new * across;
  const int lo = max(c - other, 1), no_diag = c - other;
  const float init = other >= c ? sentinel : inf;

  const float* fixed = moved.row(rings, c);  // the new frame's row
  float fx[12];
  if (kCost != COST_ANY) load12(fixed, fx);
  float r[P], cv[P];
  static_for<P>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    const int p = k * 32 + lane;
    const int pc = min(p, c);  // positions above c read position c
    int q = pc + off;
    if (q >= L) q -= L;
    const float cost = band_cost<kCost>(band.row(rings, pc), fx, fixed, f, eu);
    const float prev = prev_line[q * step];
    // the diagonal, or inf where it is masked; a max with -inf keeps it,
    // so its load stays unconditional (no branch splits this loop's code)
    const float diag = fmaxf(prev_line[(q == 0 ? c : q - 1) * step], (p > 0 && p != no_diag) ? -inf : inf);
    band_cell(cost, prev, diag, p, lo, init, r[k], cv[k]);
  });
  warp_minplus_scan<P>(r, cv, c);
  static_for<P>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    const int p = k * 32 + lane;
    int q = p + off;
    if (q >= L) q -= L;
    if (p <= c) new_line[q * step] = p >= lo ? r[k] : sentinel;
  });
  __syncwarp();
}

// First minimum over the warp: the (value, index) order of take_min is
// total on non-NaN values, so any combining order finds the first minimum;
// lane 0's result is broadcast, so every lane leaves with the same pair.
__device__ __forceinline__ void warp_first_min(float& v, int& i) {
#pragma unroll
  for (int e = 4; e >= 0; --e)
    take_min(v, i, __shfl_down_sync(FULL_MASK, v, 1 << e), __shfl_down_sync(FULL_MASK, i, 1 << e));
  v = __shfl_sync(FULL_MASK, v, 0);
  i = __shfl_sync(FULL_MASK, i, 0);
}

// set_direction for one warp: the first minimum of window row c over
// [b0, c] and of window column c over [a0, c] (each lane over its P
// positions, then across lanes), the append (lane 0 stores) and the next
// direction, with set_direction's scalar logic unchanged.
template <int P>
__device__ inline int warp_set_direction(const float* W, const Ring& ring, int t, int j, int c, Walk& w,
                                         int* path_x, int* path_y, int p_len, int path_base, bool monotone,
                                         int max_run_count) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const int b0 = max(c - j, 1), a0 = max(c - t, 1);
  // each register's (value, index), outside the band (inf, NO_INDEX), which
  // no pair displaces; then the lane's first minimum as a tree over its
  // registers (the order is total, so any combining order gives it)
  float vj[P], vt[P];
  int ij[P], it[P];
  static_for<P>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    const int p = k * 32 + lane;
    const int pc = min(p, c);  // positions above c read position c
    const bool in_row = p <= c && p >= b0, in_col = p <= c && p >= a0;
    vj[k] = fmaxf(W[ring.at(c, pc)], in_row ? -inf : inf);
    vt[k] = fmaxf(W[ring.at(pc, c)], in_col ? -inf : inf);
    ij[k] = in_row ? p : NO_INDEX;
    it[k] = in_col ? p : NO_INDEX;
  });
  static_for<log2_of(P)>([&](auto ec) {
    constexpr int h = 1 << decltype(ec)::value;
    static_for<P / (2 * h)>([&](auto mc) {
      constexpr int k = 2 * h * decltype(mc)::value;
      take_min(vj[k], ij[k], vj[k + h], ij[k + h]);
      take_min(vt[k], it[k], vt[k + h], it[k + h]);
    });
  });
  float cost_j = vj[0], cost_t = vt[0];
  int bj = ij[0], ak = it[0];
  warp_first_min(cost_j, bj);
  warp_first_min(cost_t, ak);

  const bool use_row = cost_j < cost_t;
  const int x = use_row ? t : t - c + ak;
  const int y = use_row ? j - c + bj : j;
  if (!monotone || w.plen == 0 || (x > w.lastx && y >= w.lasty)) {
    const int slot = w.plen - path_base;
    if (lane == 0 && slot >= 0 && slot < p_len) {
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
