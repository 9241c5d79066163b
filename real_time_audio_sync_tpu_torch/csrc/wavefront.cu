// The DP of the DTW-family recurrences and its backtrack, for sm_90a.  The
// Python wrappers and the plain PyTorch versions of both are in
// ops/wavefront.py; each kernel agrees with its plain version bit for bit.
//
// wavefront_dp_kernel replaces the TPU kernel
// real_time_audio_sync_tpu/ops/pallas_wavefront.py: wavefront_dp_pallas
// (:111), body _dp_kernel (:48).
//   Bound: latency.  The bytes (cost read once, acc and back written once:
//   9 B a float32 cell) stream in a small fraction of the time the chain of
//   dependent cells takes: a cell needs its left, up and diagonal
//   neighbours, so any schedule runs at least M + N - 1 dependent cells, each
//   a shuffle or a register move and first_min's add, compares and selects
//   (PERF.md has the bound and the times).  One block stepping over the
//   anti-diagonals with a block barrier each would use one SM of 132 and
//   read every neighbour N-1 elements apart.
//   Design: each warp sweeps a strip of 32*DP_R rows (DP_R rows a lane: 2
//   measured ahead of 1 and 4 at the main pair) as a systolic array.  At step t lane l computes column t - l of its rows: the
//   left neighbour is its own previous value, the up and diagonal ones lane
//   l-1's values of the last two steps (a shuffle and a register), and lane
//   0 takes them from the row above the strip.  No block barrier sits in the
//   sweep, and only phase 0 (the first 32 steps) pays for the lanes left of
//   column 0 and the corner.  The strip moves 32 columns (a chunk) a phase:
//   cost comes in by cp.async into a shared ring of three 32-column tiles
//   (the next chunk in flight while two are read), acc and back go out
//   through a ring of two, each device-memory access a whole row segment of
//   a warp.  When a chunk is stored, its bottom row goes to the strip below
//   as tagged words (below), loaded a chunk ahead and reloaded until all are
//   tagged; a tag in the word itself needs no fence on either side (a
//   release counter with an acquire spin, and the row read back from acc,
//   measured slower).  Strips are taken by an atomic ticket, not by
//   blockIdx, so a strip's producer holds an earlier ticket and is already
//   running: no deadlock at any strip count or block order.  The critical
//   path is about N steps plus, a strip, two phases and one hand-off.
//   A batch of B matrices of one shape is one launch: ticket t is strip t % S
//   of matrix t / S (S strips a matrix), so a strip's producer still holds
//   the ticket before it, and each matrix has its own edge rows.
//
// wavefront_backtrack_kernel replaces pallas_wavefront.py: backtrack_pallas
// (:181), body _make_backtrack_kernel (:147).
//   Bound: latency, up to M+N-1 dependent reads of back (each code decides
//   the next cell).  Chasing them through L2 costs a round trip a step, so
//   one warp stages the 64 x 64 tile of back whose bottom-right corner is
//   the current cell in shared memory (4-byte loads, two row segments a warp
//   access, realigned by a funnel shift, all in flight at once; clipped at
//   row and column 0) and turns each code into the byte offset of its step,
//   the clamp at row and column 0 and the origin folded in, with off-tile
//   bytes around the tile.  One lane then chases batches of 32 steps, a shared
//   load and a subtract each (a step off the tile lands on a byte that
//   stays), and the warp finds in parallel where a batch left the tile or
//   reached the origin, until the path leaves the tile or the point buffer
//   fills; the warp writes the points out coalesced and stages the next
//   tile.  The path moves only up, left or diagonally, so it crosses a tile
//   in at least 64 steps.  The whole warp writes the frozen (0, 0) tail.
//   A batch of B matrices is one launch of B blocks, a warp a matrix.
//
// Numerics: each cell is wavefront_step.cuh's first_min (nb + w*c with
// explicit round-to-nearest intrinsics, strict <, IEEE infinities outside
// the matrix), shared with the streaming WTW kernel.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wavefront_step.cuh"

namespace {

using wavefront_step::first_min;
using wavefront_step::Spec;
using wavefront_step::Table;

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int CHUNK = 32;             // columns a strip moves a phase, one a lane
constexpr int COST_RING = 3 * CHUNK;  // chunks p-1 and p read, p+1 in flight
constexpr int OUT_RING = 2 * CHUNK;   // chunk p-1 stored at the phase's end, p written

// A strip's shared memory.  Row k of a tile is strip row k; chunk q's
// column c lies at ring column (q*CHUNK + c) mod ring width, so lane l at
// step t touches column (t - l) mod 32 of a bank row: no bank conflict.
template <typename T, int R>
struct DpShared {
  T cost[LANES * R][COST_RING];
  T acc[LANES * R][OUT_RING];
  int code[LANES * R][OUT_RING];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// The hand-off of a strip's bottom row to the strip below: each value as
// 64-bit words of 32 value bits and a tag of 1 (a double takes two), in an
// edge row of the zeroed workspace, so a word is either all new or still
// 0 and a reader needs no fence.
constexpr unsigned long long TAG = 1ull << 32;
template <typename T>
constexpr int kEdgeWords = sizeof(T) / 4;  // 64-bit words a value: 32 value bits each

template <typename T>
__device__ __forceinline__ void put_edge(unsigned long long* e, T v);
template <>
__device__ __forceinline__ void put_edge<float>(unsigned long long* e, float v) {
  store_relaxed(e, TAG | __float_as_uint(v));
}
template <>
__device__ __forceinline__ void put_edge<double>(unsigned long long* e, double v) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  store_relaxed(e, TAG | (b & 0xffffffffull));
  store_relaxed(e + 1, TAG | (b >> 32));
}

template <typename T>
struct EdgeWord {
  unsigned long long w[kEdgeWords<T>];
  __device__ __forceinline__ void load(const unsigned long long* e) {
#pragma unroll
    for (int k = 0; k < kEdgeWords<T>; ++k) w[k] = load_relaxed(e + k);
  }
  __device__ __forceinline__ bool tagged() const {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < kEdgeWords<T>; ++k) ok &= (w[k] >> 32) == 1;
    return ok;
  }
  __device__ __forceinline__ T value() const;
};
template <>
__device__ __forceinline__ float EdgeWord<float>::value() const {
  return __uint_as_float(static_cast<unsigned>(w[0]));
}
template <>
__device__ __forceinline__ double EdgeWord<double>::value() const {
  return __longlong_as_double(static_cast<long long>((w[0] & 0xffffffffull) | (w[1] << 32)));
}

constexpr int STEP_GROUP = 8;  // steps a group: their cost loads go out before the first step

// workspace (zeroed): int [0] the ticket; from byte 16, for each matrix b of
// the batch, edge row s (strip s's bottom row, N columns of kEdgeWords<T>
// words) for s < strips - 1.
template <typename T, int R, int K0, int K1, int K2>
__global__ void __launch_bounds__(LANES)
wavefront_dp_kernel(const T* __restrict__ cost, T* acc, int8_t* __restrict__ back, long long m,
                    long long n, int strips, Spec spec, int* workspace) {
  constexpr int H = LANES * R;  // rows of a strip
  extern __shared__ __align__(16) unsigned char dp_smem[];
  DpShared<T, R>& sh = *reinterpret_cast<DpShared<T, R>*>(dp_smem);
  const T inf = static_cast<T>(INFINITY);
  const T w0 = static_cast<T>(spec.w[0]), w1 = static_cast<T>(spec.w[1]),
          w2 = static_cast<T>(spec.w[2]);
  Spec sp = spec;  // the same spec, its candidate kinds known at compile time
  sp.kind[0] = K0;
  sp.kind[1] = K1;
  sp.kind[2] = K2;
  const int lane = threadIdx.x;

  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(workspace, 1);
  ticket = __shfl_sync(FULL, ticket, 0);
  const int s = ticket % strips;  // strip s of matrix b
  const long long b = ticket / strips;
  cost += b * m * n;
  acc += b * m * n;
  back += b * m * n;
  const long long row0 = static_cast<long long>(s) * H;
  const int rows = static_cast<int>(m - row0 < H ? m - row0 : H);  // rows of this strip in the matrix
  const bool has_below = row0 + H < m;
  const int n_cols = static_cast<int>(n);  // M + N - 1 < 2^31 (points are int32)
  const int n_chunks = (n_cols + CHUNK - 1) / CHUNK;
  unsigned long long* edges =
      reinterpret_cast<unsigned long long*>(workspace + 4) + b * (strips - 1) * n * kEdgeWords<T>;
  unsigned long long* my_edge = edges + static_cast<long long>(s) * n * kEdgeWords<T>;
  const unsigned long long* above_edge = my_edge - n * kEdgeWords<T>;
  EdgeWord<T> next;  // lane u: the row above at column 32(p+1) + u, loaded a phase ahead
  if (s > 0 && lane < n_cols) next.load(above_edge + lane * kEdgeWords<T>);

  auto load_cost = [&](int q) {  // chunk q into its ring tile; one row segment a warp access
    const long long jj = static_cast<long long>(q) * CHUNK + lane;
    if (jj < n) {
      T* dst = &sh.cost[0][(q % 3) * CHUNK + lane];
      const T* src = cost + row0 * n + jj;
      for (int row = 0; row < rows; ++row) cp_async<sizeof(T)>(dst + row * COST_RING, src + row * n);
    }
    cp_async_commit();
  };

  T cur[R];  // this lane's rows at its current column
#pragma unroll
  for (int r = 0; r < R; ++r) cur[r] = inf;
  T prev_up = inf;  // the up neighbour of the previous step: this step's diagonal
  T above = inf;    // lane u: the row above the strip at column 32p + u
  const bool corner_lane = s == 0 && lane == 0;

  load_cost(0);
  for (int p = 0; p <= n_chunks; ++p) {  // phase p: lane l sweeps columns 32p - l .. 32p + 31 - l
    cp_async_wait_all();  // chunk p is in
    __syncwarp();
    if (p + 1 < n_chunks) load_cost(p + 1);  // over chunk p-2, read last phase
    if (p < n_chunks && s > 0) {
      const int jj = p * CHUNK + lane;
      while (!__all_sync(FULL, jj >= n_cols || next.tagged())) {
        if (jj < n_cols) next.load(above_edge + static_cast<long long>(jj) * kEdgeWords<T>);
      }
      above = jj < n_cols ? next.value() : inf;
      if (jj + CHUNK < n_cols) next.load(above_edge + static_cast<long long>(jj + CHUNK) * kEdgeWords<T>);
    }
    const int cbase = (p % 3) * CHUNK, obase = (p & 1) * CHUNK;
    // a group of steps; kFirst (phase 0 only) keeps the lanes left of column
    // 0 at +inf and sets the corner, later phases need neither: a lane past
    // column N-1 or row M-1 computes values no valid cell reads
    auto group = [&](int u0, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      T c[STEP_GROUP][R], ab[STEP_GROUP];
#pragma unroll
      for (int k = 0; k < STEP_GROUP; ++k) {
        int cc = cbase + u0 + k - lane;
        if (cc < 0) cc += COST_RING;
#pragma unroll
        for (int r = 0; r < R; ++r) c[k][r] = sh.cost[lane * R + r][cc];
        ab[k] = __shfl_sync(FULL, above, u0 + k);
      }
#pragma unroll
      for (int k = 0; k < STEP_GROUP; ++k) {
        const int u = u0 + k;
        const T from_lane = __shfl_up_sync(FULL, cur[R - 1], 1);
        T up = lane == 0 ? ab[k] : from_lane;
        T dg = prev_up;
        prev_up = up;
        const int oc = (obase + u - lane) & (OUT_RING - 1);  // the column's ring slot (before column 0: a free one)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = lane * R + r;
          const T left = cur[r];
          int code;
          T v = first_min(left, up, dg, c[k][r], sp, w0, w1, w2, &code);
          if (kFirst) {
            const int j = u - lane;
            if (r == 0) {
              const bool corner = corner_lane && j == 0;
              v = corner ? c[k][r] : v;
              code = corner ? spec.corner : code;
            }
            v = j >= 0 ? v : left;
          }
          cur[r] = v;
          sh.acc[row][oc] = v;
          sh.code[row][oc] = code;
          dg = left;
          up = v;
        }
      }
    };
    if (p == 0) {
      for (int u0 = 0; u0 < CHUNK; u0 += STEP_GROUP) group(u0, std::true_type{});
    } else {
      for (int u0 = 0; u0 < CHUNK; u0 += STEP_GROUP) group(u0, std::false_type{});
    }
    __syncwarp();
    if (p > 0) {  // chunk p-1 is complete: store it, and hand its bottom row down
      const int q = p - 1;
      const long long jj = static_cast<long long>(q) * CHUNK + lane;
      if (jj < n) {
        const int oc = (q & 1) * CHUNK + lane;
        if (has_below) put_edge<T>(my_edge + jj * kEdgeWords<T>, sh.acc[H - 1][oc]);
        T* a = acc + row0 * n + jj;
        int8_t* b = back + row0 * n + jj;
#pragma unroll 4
        for (int row = 0; row < rows; ++row) {
          a[row * n] = sh.acc[row][oc];
          b[row * n] = static_cast<int8_t>(sh.code[row][oc]);
        }
      }
    }
  }
}

constexpr int BT_TILE = 64;            // rows and columns of a staged tile of back
constexpr int BT_WORDS = BT_TILE / 4;  // 4-byte words of codes a tile row
constexpr int BT_STRIDE = BT_TILE + 4; // bytes a staged row: the codes' steps, then 4 off-tile bytes
constexpr int BT_LOADS = BT_TILE / 2;  // a lane's words a tile: two rows a warp access
constexpr int BT_BUF = 256;            // points buffered before the warp writes them out

// Staged tile: row r of the tile (matrix row ti + r) at byte (r + 2) *
// BT_STRIDE, column c at byte c; two rows before row 0 and each row's last
// 4 bytes lie off the tile.  A staged byte is the step of its cell's code
// as a byte offset to subtract (up BT_STRIDE, left 1, both, or 0: an
// unknown code, a step off the matrix, which stops at row or column 0, or
// the origin); off-tile bytes are 0 too.  A step that leaves the tile
// lands off it and stays there, so the chase runs a batch of steps with no
// test and the warp then finds, in parallel, the first address off the
// tile or at the origin.
__device__ __forceinline__ bool off_tile(int a) { return a < 2 * BT_STRIDE || a % BT_STRIDE >= BT_TILE; }

__global__ void __launch_bounds__(LANES)
wavefront_backtrack_kernel(const int8_t* __restrict__ back, int* __restrict__ points,
                           int* __restrict__ length_out, long long m, long long n, Table table) {
  __shared__ __align__(16) uint32_t tile[(BT_TILE + 2) * BT_STRIDE / 4];
  __shared__ int buf[BT_BUF];
  const int lane = threadIdx.x;
  back += static_cast<long long>(blockIdx.x) * m * n;  // matrix blockIdx.x of the batch
  points += static_cast<long long>(blockIdx.x) * (m + n - 1) * 2;
  length_out += blockIdx.x;
  unsigned deltas = 0;  // byte k: the offset of code k's step
#pragma unroll
  for (int k = 0; k < 4; ++k)
    deltas |= static_cast<unsigned>((table.di[k] < 0 ? BT_STRIDE : 0) + (table.dj[k] < 0 ? 1 : 0)) << (8 * k);
  for (int w = lane; w < 2 * BT_STRIDE / 4; w += LANES) tile[w] = 0;
  for (int r = lane; r < BT_TILE; r += LANES) tile[(r + 2) * BT_STRIDE / 4 + BT_WORDS] = 0;
  const long long max_len = m + n - 1;
  const uintptr_t end = reinterpret_cast<uintptr_t>(back + m * n);
  int i = static_cast<int>(m - 1), j = static_cast<int>(n - 1);
  long long s = 0;
  bool done = false;
  while (!done && s < max_len) {
    // stage rows ti..i, columns tj..tj+63 (those past j are never read):
    // lane l loads word l%16 of rows 2k + l/16, all loads before any use
    const int ti = i - (BT_TILE - 1) > 0 ? i - (BT_TILE - 1) : 0;
    const int tj = j - (BT_TILE - 1) > 0 ? j - (BT_TILE - 1) : 0;
    const int k = lane & 15;
    uint32_t lo[BT_LOADS], hi[BT_LOADS];
#pragma unroll
    for (int it = 0; it < BT_LOADS; ++it) {
      const int r = 2 * it + (lane >> 4);
      lo[it] = hi[it] = 0;
      if (ti + r <= i) {
        const uintptr_t p = reinterpret_cast<uintptr_t>(back + static_cast<long long>(ti + r) * n + tj);
        const uintptr_t a = (p & ~uintptr_t(3)) + 4 * k;
        if (a < end) lo[it] = __ldg(reinterpret_cast<const unsigned*>(a));
        if (k == 15 && (p & 3) && a + 4 < end) hi[it] = __ldg(reinterpret_cast<const unsigned*>(a + 4));
      }
    }
#pragma unroll
    for (int it = 0; it < BT_LOADS; ++it) {
      const int r = 2 * it + (lane >> 4);
      const uintptr_t p = reinterpret_cast<uintptr_t>(back + static_cast<long long>(ti + r) * n + tj);
      const uint32_t next = __shfl_down_sync(FULL, lo[it], 1);
      const uint32_t codes = __funnelshift_r(lo[it], k == 15 ? hi[it] : next, 8 * static_cast<int>(p & 3));
      // each byte: its code if 0..3, else 4 (the zero byte of __byte_perm's second word)
      const uint32_t known = __vcmpltu4(codes, 0x04040404u);
      const uint32_t sel = (codes & known) | (0x04040404u & ~known);
      const uint32_t nib = (sel & 0xfu) | ((sel >> 4) & 0xf0u) | ((sel >> 8) & 0xf00u) | ((sel >> 12) & 0xf000u);
      uint32_t d = __byte_perm(deltas, 0, nib);
      if (ti + r == 0) d &= 0x01010101u;  // row 0: no step up
      if (tj == 0 && k == 0) d &= ~1u;    // column 0: no step left (the origin: none)
      tile[(r + 2) * BT_STRIDE / 4 + k] = d;
    }
    __syncwarp();

    // chase in batches of up to 32 steps: lane 0 steps, the warp checks
    const unsigned char* steps = reinterpret_cast<const unsigned char*>(tile);
    const int origin = ti == 0 && tj == 0 ? 2 * BT_STRIDE : -1;
    const int limit = max_len - s < BT_BUF ? static_cast<int>(max_len - s) : BT_BUF;
    int a = (i - ti + 2) * BT_STRIDE + (j - tj);  // the current cell's byte, on the tile
    int count = 0, prev = -1, off = -1;           // prev -> off: the step that left the tile
    while (count < limit) {
      const int kk = limit - count < LANES ? limit - count : LANES;
      if (lane == 0) {
        for (int q = 0; q < kk; ++q) {
          buf[count + q] = a;
          a -= steps[a];
        }
      }
      a = __shfl_sync(FULL, a, 0);
      __syncwarp();
      const int v = lane < kk ? buf[count + lane] : 0;
      const unsigned bad = __ballot_sync(FULL, lane < kk && off_tile(v));
      const unsigned org = __ballot_sync(FULL, lane < kk && v == origin);
      const int fb = bad ? __ffs(bad) - 1 : LANES, fo = org ? __ffs(org) - 1 : LANES;
      if (fo < fb) {  // the origin, written once
        count += fo + 1;
        done = true;
        break;
      }
      if (fb < LANES) {  // entry fb is off the tile; the entry before it (maybe the last batch's) is on it
        prev = buf[count + fb - 1];
        off = buf[count + fb];
        count += fb;
        break;
      }
      count += kk;
      if (off_tile(a)) {
        prev = buf[count - 1];
        off = a;
        break;
      }
    }
    if (done) {
      i = j = 0;
    } else if (prev >= 0) {  // left the tile from prev, by the step it took
      const int step = prev - off;
      i = ti + prev / BT_STRIDE - 2 - (step >= BT_STRIDE ? 1 : 0);
      j = tj + prev % BT_STRIDE - (step & 1);
    } else {  // the buffer or the path is full: a is on the tile
      i = ti + a / BT_STRIDE - 2;
      j = tj + a % BT_STRIDE;
    }
    for (int q = lane; q < count; q += LANES) {
      const int b = buf[q];
      reinterpret_cast<int2*>(points)[s + q] = make_int2(ti + b / BT_STRIDE - 2, tj + b % BT_STRIDE);
    }
    s += count;
    __syncwarp();  // the tile and the buffer are free
  }
  if (lane == 0) *length_out = static_cast<int>(s);
  for (long long q = s + lane; q < max_len; q += LANES)  // frozen repeats after the origin
    reinterpret_cast<int2*>(points)[q] = make_int2(i, j);
}

constexpr int DP_R = 2;  // rows a lane

template <typename T, int K0, int K1, int K2>
struct Dp {
  static constexpr auto kernel = wavefront_dp_kernel<T, DP_R, K0, K1, K2>;
  static constexpr size_t smem = sizeof(DpShared<T, DP_R>);
  static cudaError_t attributes() {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  static cudaError_t launch(const void* cost, void* acc, void* back, long long batch, long long m, long long n,
                            const Spec& spec, int* workspace, cudaStream_t stream) {
    const cudaError_t e = attributes();
    if (e != cudaSuccess) return e;
    const long long strips = (m + LANES * DP_R - 1) / (LANES * DP_R);
    if (batch * strips > 0x7fffffffLL) return cudaErrorInvalidValue;  // the ticket is an int
    kernel<<<static_cast<unsigned>(batch * strips), LANES, smem, stream>>>(
        static_cast<const T*>(cost), static_cast<T*>(acc), static_cast<int8_t*>(back), m, n,
        static_cast<int>(strips), spec, workspace);
    return cudaGetLastError();
  }
  static cudaError_t resident(int* blocks) {
    cudaError_t e = attributes();
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, LANES, smem);
    return e;
  }
};

// The spec's candidate kinds, a permutation of (left 0, up 1, diagonal 2),
// as template arguments; f(Dp<T, K0, K1, K2>{}) for the spec's order.
template <typename T, typename F>
cudaError_t with_kinds(int k0, int k1, int k2, F&& f) {
  switch (k0 * 9 + k1 * 3 + k2) {
    case 0 * 9 + 1 * 3 + 2: return f(Dp<T, 0, 1, 2>{});  // DTW_SPEC
    case 1 * 9 + 0 * 3 + 2: return f(Dp<T, 1, 0, 2>{});  // WTW_SPEC
    case 0 * 9 + 2 * 3 + 1: return f(Dp<T, 0, 2, 1>{});
    case 1 * 9 + 2 * 3 + 0: return f(Dp<T, 1, 2, 0>{});
    case 2 * 9 + 0 * 3 + 1: return f(Dp<T, 2, 0, 1>{});
    case 2 * 9 + 1 * 3 + 0: return f(Dp<T, 2, 1, 0>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the zeroed workspace wavefront_dp needs for a batch of `batch`
// (m, n) costs.
extern "C" long long wavefront_dp_workspace_bytes(long long batch, long long m, long long n, int is_double) {
  const long long strips = (m + LANES * DP_R - 1) / (LANES * DP_R);
  return 16 + batch * (strips - 1) * n * 8 * (is_double ? 2 : 1);
}

// The DP over `batch` (m, n) costs stored one after another, one launch.
extern "C" int wavefront_dp(void* cost, void* acc, void* back, long long batch, long long m, long long n,
                            int is_double, int kind0, int kind1, int kind2, double w0,
                            double w1, double w2, int code0, int code1, int code2,
                            int corner, void* workspace, void* stream) {
  Spec spec{{kind0, kind1, kind2}, {w0, w1, w2}, {code0, code1, code2}, corner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  auto go = [&](auto dp) { return decltype(dp)::launch(cost, acc, back, batch, m, n, spec, ws, s); };
  const cudaError_t e = is_double ? with_kinds<double>(kind0, kind1, kind2, go)
                                  : with_kinds<float>(kind0, kind1, kind2, go);
  return static_cast<int>(e);
}

// The DP kernel's strips (blocks) an SM holds at once, into *blocks.
extern "C" int wavefront_dp_resident(int is_double, int* blocks) {
  auto go = [&](auto dp) { return decltype(dp)::resident(blocks); };
  return static_cast<int>(is_double ? with_kinds<double>(0, 1, 2, go) : with_kinds<float>(0, 1, 2, go));
}

// Rows of a DP strip.
extern "C" int wavefront_dp_strip_rows() { return LANES * DP_R; }


// The backtrack of `batch` (m, n) code matrices stored one after another, one
// launch: points (batch, m + n - 1, 2), length (batch).
extern "C" int wavefront_backtrack(void* back, void* points, void* length, long long batch, long long m,
                                   long long n, int di0, int di1, int di2, int di3, int dj0,
                                   int dj1, int dj2, int dj3, void* stream) {
  if (batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Table table{{di0, di1, di2, di3}, {dj0, dj1, dj2, dj3}};
  wavefront_backtrack_kernel<<<static_cast<unsigned>(batch), LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(back), static_cast<int*>(points), static_cast<int*>(length), m, n,
      table);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
