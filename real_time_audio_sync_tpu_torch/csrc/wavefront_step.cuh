// One cell of the DTW-family anti-diagonal DP and its step table, shared by
// the wavefront kernels (wavefront.cu) and the streaming WTW kernel
// (wtw_insert.cu), so both take every decision with the same arithmetic.
//
// A cell takes the first minimum, in the spec's candidate order, of
// nb + w*c over its left, up and diagonal neighbours: each candidate one
// round-to-nearest multiply and one round-to-nearest add (built with
// --fmad=false as well), compared with strict <, so ties keep the first
// candidate as np.argmin does.  IEEE infinities mark the cells outside the
// matrix, so no fast-math.

#pragma once

#include <cuda_runtime.h>

namespace wavefront_step {

struct Spec {
  int kind[3];      // per candidate: 0 left, 1 up, 2 diagonal
  double w[3];      // per candidate: weight of the cell cost
  int code[3];      // per candidate: back code
  int corner;       // back code of (0, 0)
};

struct Table {
  int di[4], dj[4];  // step of each back code 0..3
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The cell's value; its back code goes to *code.  w0..w2 are the spec's
// weights in the cell's type.
template <typename T>
__device__ __forceinline__ T first_min(T left, T up, T dg, T c, const Spec& spec, T w0, T w1, T w2,
                                       int* code) {
  auto nb = [&](int kind) { return kind == 0 ? left : (kind == 1 ? up : dg); };
  T best = add_rn(nb(spec.kind[0]), mul_rn(w0, c));
  int k = spec.code[0];
  const T c1 = add_rn(nb(spec.kind[1]), mul_rn(w1, c));
  if (c1 < best) { best = c1; k = spec.code[1]; }
  const T c2 = add_rn(nb(spec.kind[2]), mul_rn(w2, c));
  if (c2 < best) { best = c2; k = spec.code[2]; }
  *code = k;
  return best;
}

}  // namespace wavefront_step
