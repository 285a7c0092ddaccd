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
// What bounds it on the card: bytes, the f32 read-modify-write of the
// canvas cells the RoIs' nonzero weights reach, and the ct read (P P C
// floats per RoI). The weights are sparse (window_reach.cuh): a window row
// h has nonzero vy in 2-4 of the P pooled rows, a column w nonzero vx in
// 1-4 of the P pooled columns, and a RoI reaches only part of its window
// (~270 of a base window's 1536 cells at the box head). A dense
// contraction over the window, as the TPU kernel does it, is mostly zeros.
//
// Design: one CTA per (RoI row, 128-channel tile), 8 warps; a lane holds 4
// channels (16 bytes), so a warp covers the tile.
//  - vy and vx are staged in shared memory, with a bit mask per window row
//    of the p whose vy reaches it (pmask) and per column of the q whose vx
//    reaches it (qmask), and the reach's first and last row and column
//    (ballots), clipped at the canvas edge.
//  - Warp i takes the reached rows h = ylo + i, ylo + i + 8, ... For row h
//    it sums y first, in registers, over the p of pmask[h] only:
//    t[q] = sum_p vy[p, h] ct[p, q, c:c+4] for every q (ct read as 16-byte
//    vectors through L1: the rows of one p share them). Then, for each
//    reached column w, d = sum_q vx[q, w] t[q] over the q of qmask[w], and
//    one red.global.add.v4.f32 (atomicAdd of a float4) adds d into the
//    cell: one reduction per 16 bytes, on reached cells only.
//  - Overlapping windows (RoIs cluster on P2) land in one cell from many
//    CTAs, so the adds are atomic, and their order, hence the last bits of
//    the sum, changes from run to run. The other design, one CTA per canvas
//    tile summing the RoIs that reach it, would be deterministic but needs
//    per-tile RoI lists built on the device first (a count, a scan and a
//    scatter per call); the reductions keep one pass, and the tolerance
//    (1e-5 max|ref| + 1e-6) absorbs the order.
//  - Shared memory is P (WY + WX) floats (at most 16 KB) and two masks:
//    registers (a 16 x 4 t for P > 8) limit occupancy, not shared memory.
// Terms left out have zero weight, so for finite inputs the sums are the
// dense ones up to the order of the f32 adds. Channels go 4 at a time with
// 16-byte loads and reductions where C % 4 == 0 and the canvas and ct are
// 16-byte aligned, else one at a time (scalar atomicAdd).

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_reach.cuh"

namespace {

using window_reach::nonzero_mask;
using window_reach::nonzero_range;

constexpr int kWarps = 8;
constexpr int kMaxWin = 128;
constexpr int kCT = 128;  // channels per CTA: 4 per lane

template <int kPMax>
__global__ void __launch_bounds__(32 * kWarps)
roi_window_accum_kernel(float* __restrict__ canvas,
                        const int32_t* __restrict__ starts,
                        const float* __restrict__ ct,
                        const float* __restrict__ vy,
                        const float* __restrict__ vx, int B, int Hc, int Wc,
                        int C, int row_lo, int WY, int WX, int P, int vec4) {
  extern __shared__ float smem[];
  float* svy = smem;                      // (P, WY)
  float* svx = svy + P * WY;              // (P, WX)
  __shared__ unsigned short pmask[kMaxWin];
  __shared__ unsigned short qmask[kMaxWin];

  const size_t n = static_cast<size_t>(row_lo) + blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int nthreads = 32 * kWarps;
  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];
  if (b < 0 || b >= B || y0 < 0 || x0 < 0) return;  // uniform over the CTA
  // Cells past the canvas edge carry zero weight by construction of the
  // window origins; they are skipped.
  const int h_end = min(WY, Hc - y0);
  const int w_end = min(WX, Wc - x0);
  if (h_end <= 0 || w_end <= 0) return;

  for (int k = tid; k < P * WY; k += nthreads) svy[k] = vy[n * P * WY + k];
  for (int k = tid; k < P * WX; k += nthreads) svx[k] = vx[n * P * WX + k];
  __syncthreads();
  for (int h = tid; h < WY; h += nthreads) pmask[h] = nonzero_mask(svy + h, P, WY);
  for (int w = tid; w < WX; w += nthreads) qmask[w] = nonzero_mask(svx + w, P, WX);
  __syncthreads();
  const int2 yr = nonzero_range(pmask, h_end);
  const int2 xr = nonzero_range(qmask, w_end);
  if (yr.x < 0 || xr.x < 0) return;

  const int c = blockIdx.y * kCT + 4 * lane;   // this lane's channels
  if (c >= C) return;
  const int nc = min(4, C - c);
  const size_t row_stride = static_cast<size_t>(Wc) * C;
  float* base = canvas + ((static_cast<size_t>(b) * Hc + y0) * Wc + x0) * C + c;
  const float* ctn = ct + n * P * P * C + c;

  for (int h = yr.x + warp; h <= yr.y; h += kWarps) {
    const unsigned pm = pmask[h];
    if (pm == 0) continue;
    float t[kPMax][4];
#pragma unroll
    for (int q = 0; q < kPMax; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) t[q][v] = 0.0f;
    for (unsigned m = pm; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
      const float a = svy[p * WY + h];
      const float* ctp = ctn + static_cast<size_t>(p) * P * C;
#pragma unroll
      for (int q = 0; q < kPMax; ++q) {
        if (q < P) {
          float x[4];
          if (vec4) {
            const float4 v4 = __ldg(reinterpret_cast<const float4*>(
                ctp + static_cast<size_t>(q) * C));
            x[0] = v4.x; x[1] = v4.y; x[2] = v4.z; x[3] = v4.w;
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              x[v] = v < nc ? __ldg(ctp + static_cast<size_t>(q) * C + v) : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) t[q][v] = fmaf(a, x[v], t[q][v]);
        }
      }
    }
    float* row = base + h * row_stride;
    for (int w = xr.x; w <= xr.y; ++w) {
      const unsigned qm = qmask[w];
      if (qm == 0) continue;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kPMax; ++q) {
        if ((qm >> q) & 1) {
          const float a = svx[q * WX + w];
#pragma unroll
          for (int v = 0; v < 4; ++v) d[v] = fmaf(a, t[q][v], d[v]);
        }
      }
      float* cell = row + static_cast<size_t>(w) * C;
      if (vec4) {
        atomicAdd(reinterpret_cast<float4*>(cell),
                  make_float4(d[0], d[1], d[2], d[3]));
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nc) atomicAdd(cell + v, d[v]);
      }
    }
  }
}

template <int kPMax>
int launch(void* canvas, const void* starts, const void* ct, const void* vy,
           const void* vx, int B, int Hc, int Wc, int C, int row_lo, int rows,
           int WY, int WX, int P, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(P) * (WY + WX);
  const int vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  const dim3 grid(rows, (C + kCT - 1) / kCT);
  roi_window_accum_kernel<kPMax><<<grid, dim3(32, kWarps), smem, s>>>(
      static_cast<float*>(canvas), static_cast<const int32_t*>(starts),
      static_cast<const float*>(ct), static_cast<const float*>(vy),
      static_cast<const float*>(vx), B, Hc, Wc, C, row_lo, WY, WX, P, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// canvas: (B, Hc, Wc, C) f32, updated in place; starts: (N, 3) int32
// [img, y0, x0]; ct: (N, P, P, C) f32; vy: (N, P, WY) f32; vx: (N, P, WX)
// f32. P <= 16, WY and WX <= 128. Accumulates rows [row_lo, row_hi) only.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int roi_window_accum_launch(void* canvas, const void* starts,
                                       const void* ct, const void* vy,
                                       const void* vx, int B, int Hc, int Wc,
                                       int C, int row_lo, int row_hi, int WY,
                                       int WX, int P, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows <= 0 || C <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  if (P > 16 || WY > kMaxWin || WX > kMaxWin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return P <= 8 ? launch<8>(canvas, starts, ct, vy, vx, B, Hc, Wc, C, row_lo,
                            rows, WY, WX, P, s)
                : launch<16>(canvas, starts, ct, vy, vx, B, Hc, Wc, C, row_lo,
                             rows, WY, WX, P, s);
}
