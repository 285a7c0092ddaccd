// Windowed RoIAlign backward (window accumulate), for sm_90a.
//
// Replaces detectron_tpu/ops/pallas/roi_align_kernel.py::roi_window_accum_seg
// (kernel body _kernel_accum_seg, roi_align_kernel.py:396-449): the exact
// linear transpose of the window pool (roi_window_pool.cu) for the same
// (starts, vy, vx). For each RoI row n of the active range [row_lo, row_hi):
//
//   canvas_grad[b, y0 + h, x0 + w, c] +=
//       sum_p vy[n, p, h] * sum_q vx[n, q, w] * ct[n, p, q, c]
//
// with (b, y0, x0) = starts[n], everything in f32.
//
// Design (first, simple version): one CTA per (RoI row, 32-channel tile),
// 256 threads = 8 warps, lane = channel. vy, vx and the (P, P, 32) ct tile
// are staged in shared memory as f32. The window's columns go in chunks of
// kColChunk: first u[p, w, c] = sum_q vx[q, w] * ct[p, q, c] for the chunk
// into shared memory, then d[h, w, c] = sum_p vy[p, h] * u[p, w, c], which
// each thread adds into the canvas with atomicAdd. The TPU kernel runs its
// grid in order and serialises each window's read-modify-write, so
// overlapping windows (RoIs cluster on P2) sum correctly there; CTAs have
// no order, so here the adds are atomic (and their order, hence the last
// bits of the sum, changes from run to run). A d that is exactly zero (rows
// and columns outside the RoI's sampling extent) is not added. Canvas cells
// past the edge are skipped: they carry zero weight by construction of the
// window origins.
//
// Bound: the canvas read-modify-write and the ct read are the bytes; the
// contractions are ~2 (P P WX + P WY WX) C flops per RoI in f32. At the
// training shapes both bounds are ~0.1 ms per sweep on an H100; the kernel
// is far from either (scattered atomics, no tensor cores). Shared memory is
// (P WY + P WX + 32 P P + 32 P kColChunk) floats: 58 KB at P = 14 and a
// (32, 48) window, above the 48 KB default, so the launch opts in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;
constexpr int kWarps = 8;
constexpr int kColChunk = 16;

__global__ void __launch_bounds__(kChannels * kWarps)
roi_window_accum_kernel(float* __restrict__ canvas,
                        const int32_t* __restrict__ starts,
                        const float* __restrict__ ct,
                        const float* __restrict__ vy,
                        const float* __restrict__ vx, int B, int Hc, int Wc,
                        int C, int row_lo, int WY, int WX, int P) {
  extern __shared__ float smem[];
  float* svy = smem;                      // (P, WY)
  float* svx = svy + P * WY;              // (P, WX)
  float* sct = svx + P * WX;              // (P * P, 32)
  float* su = sct + P * P * kChannels;    // (P, kColChunk, 32)

  const size_t n = static_cast<size_t>(row_lo) + blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kChannels + lane;
  const int nthreads = kChannels * kWarps;
  const int c = blockIdx.y * kChannels + lane;
  const bool c_ok = c < C;

  for (int k = tid; k < P * WY; k += nthreads) svy[k] = vy[n * P * WY + k];
  for (int k = tid; k < P * WX; k += nthreads) svx[k] = vx[n * P * WX + k];
  for (int pq = warp; pq < P * P; pq += kWarps) {
    sct[pq * kChannels + lane] =
        c_ok ? ct[(n * P * P + pq) * static_cast<size_t>(C) + c] : 0.0f;
  }
  __syncthreads();

  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];
  if (b < 0 || b >= B || y0 < 0 || x0 < 0) return;  // uniform over the CTA
  const int h_end = min(WY, Hc - y0);
  const size_t row_stride = static_cast<size_t>(Wc) * C;
  float* base = canvas + ((static_cast<size_t>(b) * Hc + y0) * Wc + x0) * C + c;

  for (int w0 = 0; w0 < WX; w0 += kColChunk) {
    const int wn = min(kColChunk, WX - w0);
    for (int i = warp; i < P * wn; i += kWarps) {
      const int p = i / wn;
      const int wl = i - p * wn;
      const float* ctp = sct + p * P * kChannels + lane;
      const float* vxw = svx + w0 + wl;
      float s = 0.0f;
      for (int q = 0; q < P; ++q) s += vxw[q * WX] * ctp[q * kChannels];
      su[(p * kColChunk + wl) * kChannels + lane] = s;
    }
    __syncthreads();
    const int w_end = min(wn, Wc - x0 - w0);
    for (int i = warp; i < h_end * wn; i += kWarps) {
      const int h = i / wn;
      const int wl = i - h * wn;
      if (wl >= w_end) continue;
      float d = 0.0f;
      for (int p = 0; p < P; ++p) {
        d += svy[p * WY + h] * su[(p * kColChunk + wl) * kChannels + lane];
      }
      if (c_ok && d != 0.0f) {
        atomicAdd(base + h * row_stride + static_cast<size_t>(w0 + wl) * C, d);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// canvas: (B, Hc, Wc, C) f32, updated in place; starts: (N, 3) int32
// [img, y0, x0]; ct: (N, P, P, C) f32; vy: (N, P, WY) f32; vx: (N, P, WX)
// f32. Accumulates rows [row_lo, row_hi) only. Launches on `stream` and
// returns cudaGetLastError() (after the shared-memory opt-in, if that fails).
extern "C" int roi_window_accum_launch(void* canvas, const void* starts,
                                       const void* ct, const void* vy,
                                       const void* vx, int B, int Hc, int Wc,
                                       int C, int row_lo, int row_hi, int WY,
                                       int WX, int P, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows > 0) {
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(P) * (WY + WX) + kChannels * P * P +
         kChannels * P * kColChunk);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          roi_window_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(rows, (C + kChannels - 1) / kChannels);
    const dim3 block(kChannels, kWarps);
    roi_window_accum_kernel<<<grid, block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(canvas), static_cast<const int32_t*>(starts),
        static_cast<const float*>(ct), static_cast<const float*>(vy),
        static_cast<const float*>(vx), B, Hc, Wc, C, row_lo, WY, WX, P);
  }
  return static_cast<int>(cudaGetLastError());
}
