// The anti-diagonal wavefront DP of the DTW-family recurrences and its
// backtrack, for sm_90a.  The Python wrappers and the plain PyTorch versions
// of both are in ops/wavefront.py; each kernel agrees with its plain version
// bit for bit.
//
// wavefront_dp_kernel replaces the TPU kernel
// real_time_audio_sync_tpu/ops/pallas_wavefront.py: wavefront_dp_pallas
// (:111), body _dp_kernel (:48).
//   Bound: latency.  The work is M+N-1 dependent anti-diagonals of at most
//   min(M, N) independent cells, each cell 3 multiply-adds and 2 compares;
//   the bytes (cost read once, acc and back written once: 9 B per float32
//   cell) would stream in a small fraction of the time the chain of
//   dependent diagonals takes (PERF.md has both).  The design is the simple one:
//   one thread block per DP loops over the diagonals, its threads stride over
//   a diagonal's cells, and a block barrier separates diagonals (it replaces
//   the TPU's sequential grid and VMEM carry).  acc and back are written
//   row-major, not skewed, and neighbours are read back from acc in device
//   memory: the last two diagonals stay in L1/L2, the barrier makes one
//   diagonal's writes visible to the whole block, and unlike a shared-memory
//   ring this holds at every size the dense limit admits and for float64.
//   What holds it back: one SM does all the work, and a diagonal's cells lie
//   N-1 elements apart, so every load and store is uncoalesced.  A tiled
//   multi-block wavefront is the fix (ROADMAP Queue 2, PERF.md section 7).
//
// wavefront_backtrack_kernel replaces pallas_wavefront.py: backtrack_pallas
// (:181), body _make_backtrack_kernel (:147).
//   Bound: latency, up to M+N-1 dependent one-byte loads of back (each
//   waits for the previous code).  One thread chases the pointers, reading
//   the int8 codes directly (the TPU's int32 widening is a Mosaic limit),
//   and writes the frozen (0, 0) repeats after the origin without loads.
//
// Numerics: each cell is wavefront_step.cuh's first_min (nb + w*c with
// explicit round-to-nearest intrinsics, strict <, IEEE infinities outside
// the matrix), shared with the streaming WTW kernel.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wavefront_step.cuh"

namespace {

using wavefront_step::first_min;
using wavefront_step::Spec;
using wavefront_step::Table;

constexpr int DP_THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(DP_THREADS)
wavefront_dp_kernel(const T* __restrict__ cost, T* acc, int8_t* __restrict__ back,
                    long long m, long long n, Spec spec) {
  const T inf = static_cast<T>(INFINITY);
  const T w0 = static_cast<T>(spec.w[0]), w1 = static_cast<T>(spec.w[1]),
          w2 = static_cast<T>(spec.w[2]);
  if (threadIdx.x == 0) {
    acc[0] = cost[0];
    back[0] = static_cast<int8_t>(spec.corner);
  }
  __syncthreads();
  for (long long d = 1; d < m + n - 1; ++d) {
    const long long i_lo = d - (n - 1) > 0 ? d - (n - 1) : 0;
    const long long i_hi = d < m - 1 ? d : m - 1;
    for (long long i = i_lo + threadIdx.x; i <= i_hi; i += blockDim.x) {
      const long long j = d - i;
      const long long idx = i * n + j;
      const T c = cost[idx];
      const T left = j > 0 ? acc[idx - 1] : inf;
      const T up = i > 0 ? acc[idx - n] : inf;
      const T dg = i > 0 && j > 0 ? acc[idx - n - 1] : inf;
      int code;
      acc[idx] = first_min(left, up, dg, c, spec, w0, w1, w2, &code);
      back[idx] = static_cast<int8_t>(code);
    }
    __syncthreads();  // diagonal d is written before d + 1 reads it
  }
}

__global__ void wavefront_backtrack_kernel(const int8_t* __restrict__ back, int* __restrict__ points,
                                           int* __restrict__ length_out, long long m, long long n,
                                           Table table) {
  const long long max_len = m + n - 1;
  long long i = m - 1, j = n - 1;
  long long s = 0;
  bool done = false;
  for (; s < max_len && !done; ++s) {
    points[2 * s] = static_cast<int>(i);
    points[2 * s + 1] = static_cast<int>(j);
    if (i == 0 && j == 0) {
      done = true;
    } else {
      const int code = back[i * n + j];
      const bool known = code >= 0 && code < 4;
      i += known ? table.di[code] : 0;
      j += known ? table.dj[code] : 0;
      i = i < 0 ? 0 : i;
      j = j < 0 ? 0 : j;
    }
  }
  *length_out = static_cast<int>(s);
  for (; s < max_len; ++s) {  // frozen repeats after the origin
    points[2 * s] = static_cast<int>(i);
    points[2 * s + 1] = static_cast<int>(j);
  }
}

}  // namespace

extern "C" int wavefront_dp(void* cost, void* acc, void* back, long long m, long long n,
                            int is_double, int kind0, int kind1, int kind2, double w0,
                            double w1, double w2, int code0, int code1, int code2,
                            int corner, void* stream) {
  Spec spec{{kind0, kind1, kind2}, {w0, w1, w2}, {code0, code1, code2}, corner};
  const long long diag = m < n ? m : n;
  const int threads = diag < DP_THREADS ? static_cast<int>((diag + 31) / 32 * 32) : DP_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    wavefront_dp_kernel<double><<<1, threads, 0, s>>>(
        static_cast<const double*>(cost), static_cast<double*>(acc), static_cast<int8_t*>(back),
        m, n, spec);
  } else {
    wavefront_dp_kernel<float><<<1, threads, 0, s>>>(
        static_cast<const float*>(cost), static_cast<float*>(acc), static_cast<int8_t*>(back),
        m, n, spec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wavefront_backtrack(void* back, void* points, void* length, long long m,
                                   long long n, int di0, int di1, int di2, int di3, int dj0,
                                   int dj1, int dj2, int dj3, void* stream) {
  Table table{{di0, di1, di2, di3}, {dj0, dj1, dj2, dj3}};
  wavefront_backtrack_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(back), static_cast<int*>(points), static_cast<int*>(length), m, n,
      table);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
