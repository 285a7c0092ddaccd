// Windowed RoIAlign pooling, for sm_90a.
//
// Replaces detectron_tpu/ops/pallas/roi_align_kernel.py::roi_window_pool
// (kernel body _kernel, roi_align_kernel.py:114-206) and, through the
// active row range [row_lo, row_hi), ::roi_window_pool_seg (_kernel_seg,
// :213-296). For each RoI row n of the range:
//
//   out[n, p, q, c] = sum_w vx[n, q, w] * sum_h vy[n, p, h]
//                     * canvas[b, y0 + h, x0 + w, c]
//
// with (b, y0, x0) = starts[n]. The inner sum t1 and the outer sum are f32,
// as in the Pallas kernel (its t1 is an f32 matmul accumulator); the result
// is stored in the canvas dtype (f32 or bf16; vy/vx share that dtype).
//
// Design (first, simple version): one CTA per (RoI row, 32-channel tile),
// blockDim = (32, P): thread (c, p) owns one output row p of one channel
// and keeps the P sums over q in registers. vy and vx are staged in shared
// memory as f32. For each window column w the thread forms t1[p, w, c] from
// the column (coalesced 32-channel loads; the P warps of the CTA read the
// same addresses, so all but the first hit L1), then adds vx[q, w] * t1 into
// its P sums. Window reads past the canvas edge are skipped (they carry zero
// weight by construction of the window origins).
//
// Bound: the window reads. A base box-head window (32 x 48 x 256 bf16) is
// 786 KB per RoI against ~3 MFLOP, so the kernel sits far below the
// H100's FLOP/byte ridge; the dense weights are mostly zero (each p row of
// vy touches ~roi_h/P + 2 rows). Exploiting that sparsity, TMA staging of
// the window and tensor-core contractions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 16;
constexpr int kMaxWin = 128;
constexpr int kChannels = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kChannels * kMaxP)
roi_window_pool_kernel(const T* __restrict__ canvas,
                       const int32_t* __restrict__ starts,
                       const T* __restrict__ vy, const T* __restrict__ vx,
                       T* __restrict__ out, int B, int Hc, int Wc, int C,
                       int row_lo, int WY, int WX, int P) {
  __shared__ float svy[kMaxP * kMaxWin];
  __shared__ float svx[kMaxP * kMaxWin];
  const size_t n = static_cast<size_t>(row_lo) + blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < P * WY; k += nthreads) svy[k] = to_f32(vy[n * P * WY + k]);
  for (int k = tid; k < P * WX; k += nthreads) svx[k] = to_f32(vx[n * P * WX + k]);
  __syncthreads();

  const int c = blockIdx.y * kChannels + threadIdx.x;
  const int p = threadIdx.y;
  if (c >= C) return;
  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];

  float acc[kMaxP];
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) acc[q] = 0.0f;

  if (b >= 0 && b < B && y0 >= 0 && x0 >= 0) {
    const int h_end = min(WY, Hc - y0);
    const int w_end = min(WX, Wc - x0);
    const size_t row_stride = static_cast<size_t>(Wc) * C;
    const T* base = canvas + ((static_cast<size_t>(b) * Hc + y0) * Wc + x0) * C + c;
    const float* wy = svy + p * WY;
    for (int w = 0; w < w_end; ++w) {
      const T* col = base + static_cast<size_t>(w) * C;
      float t = 0.0f;
      for (int h = 0; h < h_end; ++h) t += wy[h] * to_f32(col[h * row_stride]);
#pragma unroll
      for (int q = 0; q < kMaxP; ++q) {
        if (q < P) acc[q] += svx[q * WX + w] * t;
      }
    }
  }

  T* o = out + (n * P + p) * P * C + c;
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) {
    if (q < P) o[static_cast<size_t>(q) * C] = from_f32<T>(acc[q]);
  }
}

}  // namespace

// canvas: (B, Hc, Wc, C); starts: (N, 3) int32 [img, y0, x0]; vy: (N, P, WY);
// vx: (N, P, WX); out: (N, P, P, C). Pools rows [row_lo, row_hi) only.
// dtype: 0 = float32, 1 = bfloat16 (canvas, vy, vx and out share it).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int roi_window_pool_launch(const void* canvas, const void* starts,
                                      const void* vy, const void* vx,
                                      void* out, int B, int Hc, int Wc, int C,
                                      int row_lo, int row_hi, int WY, int WX,
                                      int P, int dtype, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows > 0) {
    const dim3 grid(rows, (C + kChannels - 1) / kChannels);
    const dim3 block(kChannels, P);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
      roi_window_pool_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(canvas),
          static_cast<const int32_t*>(starts),
          static_cast<const __nv_bfloat16*>(vy),
          static_cast<const __nv_bfloat16*>(vx),
          static_cast<__nv_bfloat16*>(out), B, Hc, Wc, C, row_lo, WY, WX, P);
    } else {
      roi_window_pool_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(canvas),
          static_cast<const int32_t*>(starts),
          static_cast<const float*>(vy), static_cast<const float*>(vx),
          static_cast<float*>(out), B, Hc, Wc, C, row_lo, WY, WX, P);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
