// The reach of a RoI's window weights, shared by the window pool
// (roi_window_pool.cu, K2/K3) and its transpose, the window accumulate
// (roi_window_accum.cu, K4).
//
// A RoI's interpolation weights vy (P, WY) and vx (P, WX) are sparse: each
// pooled row p reaches a few window rows, each pooled column q a few window
// columns, and the RoI as a whole only part of its window. Both kernels
// visit only the rows and columns some weight reaches; the terms they leave
// out have zero weight, so for finite inputs the f32 sums equal the dense
// contraction's.

#pragma once

#include <cuda_runtime.h>

namespace window_reach {

// First and last index of row[0, len) that is nonzero (-1 and -2 when
// none), the same in every thread of the warp; threadIdx.x is the lane.
template <typename T>
__device__ __forceinline__ int2 nonzero_range(const T* row, int len) {
  int lo = -1, hi = -2;
  for (int k0 = 0; k0 < len; k0 += 32) {
    const int k = k0 + static_cast<int>(threadIdx.x);
    const unsigned bits =
        __ballot_sync(0xffffffffu, k < len && row[k] != T(0));
    if (bits) {
      if (lo < 0) lo = k0 + __ffs(bits) - 1;
      hi = k0 + 31 - __clz(bits);
    }
  }
  return make_int2(lo, hi);
}

// Bit p set iff w[p * stride] != 0, for p < P <= 16: the pooled rows (or
// columns) whose weight reaches one window row (or column).
__device__ __forceinline__ unsigned short nonzero_mask(const float* w, int P,
                                                       int stride) {
  unsigned m = 0;
  for (int p = 0; p < P; ++p) m |= (w[p * stride] != 0.0f) << p;
  return static_cast<unsigned short>(m);
}

}  // namespace window_reach
