// Windowed RoIAlign backward (window accumulate) without atomics, for
// sm_90a: the deterministic variant of roi_window_accum.cu (K4), which the
// wrapper launches while torch.use_deterministic_algorithms is on.
//
// Replaces, like K4, detectron_tpu/ops/pallas/roi_align_kernel.py ::
// roi_window_accum_seg (kernel body _kernel_accum_seg, roi_align_kernel.py:
// 396-449), whose grid steps run in order on the TPU, so its sums do not
// change from run to run. The same function: for each RoI row n of the
// active range [row_lo, row_hi),
//
//   canvas_grad[b, y0 + h, x0 + w, c] +=
//       sum_p vy[n, p, h] * sum_q vx[n, q, w] * ct[n, p, q, c]
//
// with (b, y0, x0) = starts[n], everything in f32. Two calls on the same
// inputs give the same bits.
//
// What bounds it on the card: K4's bytes (the f32 read-modify-write of the
// reached canvas cells and the ct read), plus every CTA's walk over the
// RoIs' reach rectangles (20 bytes a RoI). The design trades speed for a
// fixed order; it is not tuned.
//
// Design: two kernels in one call.
//  - reach: one warp per RoI row writes the rectangle of canvas cells its
//    nonzero weights reach (ballots over the window rows and columns that
//    some pooled row or column reaches, as window_reach.cuh finds a
//    range), clipped at the canvas edge, as (b, ylo, yhi, xlo, xhi), b = -1
//    for a row that reaches none.
//  - accumulate: one CTA per (image, 8 x kTW canvas tile, 128-channel
//    tile), 8 warps; warp r owns tile row r, a lane 4 channels. The CTA
//    lists, 256 rows at a time and in row order (a ballot and a prefix
//    count), the RoI rows whose rectangle meets its tile, then walks them
//    in that order: it stages the row's vy over the tile's rows and vx
//    over its columns in shared memory, each warp sums y first in
//    registers over the p whose vy reaches its canvas row, t[q] = sum_p
//    vy[p, h] ct[p, q, c:c+4], then x into its kTW cells' sums, acc[w] +=
//    sum_q vx[q, w] t[q]. At the end each warp adds its cells' sums into
//    canvas_grad with a plain load and store: the CTA owns those cells, so
//    no other CTA writes them, and the order of every sum is fixed.
//  - Registers hold acc (kTW x 4) and t (kPMax x 4): kTW = 16 columns for
//    P <= 8, 8 for P <= 16.
// Zero weights add exact zeros (x-sums run over every q < P), so for
// finite inputs the sums are the dense ones up to the order of the f32
// adds, as in K4; against K4 the last bits differ (K4 adds each RoI's
// term into the canvas, this kernel adds one sum per cell), within K4's
// tolerance of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTH = kWarps;   // tile rows: one per warp
constexpr int kMaxWin = 128;
constexpr int kCT = 128;      // channels per CTA: 4 per lane
constexpr int kChunk = 32 * kWarps;   // rows listed per pass

// Whether row (or column) k of the window has a nonzero weight in some
// pooled row (or column) p < P; w is (P, len) row-major.
__device__ __forceinline__ bool any_nonzero(const float* w, int P, int len,
                                            int k) {
  for (int p = 0; p < P; ++p)
    if (w[p * len + k] != 0.0f) return true;
  return false;
}

// One warp per RoI row: its reach rectangle in canvas coordinates.
__global__ void __launch_bounds__(32 * kWarps)
roi_reach_kernel(int32_t* __restrict__ reach,
                 const int32_t* __restrict__ starts,
                 const float* __restrict__ vy, const float* __restrict__ vx,
                 int B, int Hc, int Wc, int row_lo, int rows, int WY, int WX,
                 int P) {
  const int i = blockIdx.x * kWarps + threadIdx.y;
  if (i >= rows) return;   // uniform over the warp
  const int lane = threadIdx.x;
  const size_t n = static_cast<size_t>(row_lo) + i;
  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];
  int32_t* out = reach + 5 * static_cast<size_t>(i);
  const int h_end = min(WY, Hc - y0);
  const int w_end = min(WX, Wc - x0);
  if (b < 0 || b >= B || y0 < 0 || x0 < 0 || h_end <= 0 || w_end <= 0) {
    if (lane == 0) out[0] = -1;
    return;
  }
  const float* vyn = vy + n * P * WY;
  const float* vxn = vx + n * P * WX;
  int ylo = -1, yhi = -2, xlo = -1, xhi = -2;
  for (int k0 = 0; k0 < h_end; k0 += 32) {
    const int k = k0 + lane;
    const unsigned bits = __ballot_sync(
        0xffffffffu, k < h_end && any_nonzero(vyn, P, WY, k));
    if (bits) {
      if (ylo < 0) ylo = k0 + __ffs(bits) - 1;
      yhi = k0 + 31 - __clz(bits);
    }
  }
  for (int k0 = 0; k0 < w_end; k0 += 32) {
    const int k = k0 + lane;
    const unsigned bits = __ballot_sync(
        0xffffffffu, k < w_end && any_nonzero(vxn, P, WX, k));
    if (bits) {
      if (xlo < 0) xlo = k0 + __ffs(bits) - 1;
      xhi = k0 + 31 - __clz(bits);
    }
  }
  if (lane == 0) {
    if (ylo < 0 || xlo < 0) {
      out[0] = -1;
    } else {
      out[0] = b;
      out[1] = y0 + ylo;
      out[2] = y0 + yhi;
      out[3] = x0 + xlo;
      out[4] = x0 + xhi;
    }
  }
}

template <int kPMax, int kTW>
__global__ void __launch_bounds__(32 * kWarps)
roi_window_accum_det_kernel(float* __restrict__ canvas,
                            const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ reach,
                            const float* __restrict__ ct,
                            const float* __restrict__ vy,
                            const float* __restrict__ vx, int Hc, int Wc,
                            int C, int row_lo, int rows, int WY, int WX,
                            int P, int tiles_y, int tiles_x, int vec4) {
  __shared__ float svy[kPMax * kTH];   // (P, kTH): vy over the tile's rows
  __shared__ float svx[kPMax * kTW];   // (P, kTW): vx over its columns
  __shared__ int list[kChunk];
  __shared__ int warp_hits[kWarps];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int tile = blockIdx.x;
  const int b = tile / (tiles_y * tiles_x);
  const int ty0 = (tile / tiles_x) % tiles_y * kTH;
  const int tx0 = tile % tiles_x * kTW;
  const int hc = ty0 + warp;           // this warp's canvas row
  const int c = blockIdx.y * kCT + 4 * lane;
  const bool active = c < C;
  const int nc = min(4, C - c);

  float acc[kTW][4];
#pragma unroll
  for (int w = 0; w < kTW; ++w)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[w][v] = 0.0f;
  bool touched = false;                // uniform over the CTA

  for (int r0 = 0; r0 < rows; r0 += kChunk) {
    // The rows of this chunk whose reach meets the tile, in row order.
    const int i = r0 + tid;
    bool hit = false;
    if (i < rows) {
      const int32_t* rr = reach + 5 * static_cast<size_t>(i);
      hit = rr[0] == b && rr[2] >= ty0 && rr[1] < ty0 + kTH &&
            rr[4] >= tx0 && rr[3] < tx0 + kTW;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(bits);
    __syncthreads();
    int before = 0, count = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += k < warp ? warp_hits[k] : 0;
      count += warp_hits[k];
    }
    if (hit) list[before + __popc(bits & ((1u << lane) - 1u))] = i;
    __syncthreads();
    touched |= count > 0;

    for (int j = 0; j < count; ++j) {
      const size_t n = static_cast<size_t>(row_lo) + list[j];
      const int y0 = starts[3 * n + 1];
      const int x0 = starts[3 * n + 2];
      const float* vyn = vy + n * P * WY;
      const float* vxn = vx + n * P * WX;
      for (int k = tid; k < P * (kTH + kTW); k += 32 * kWarps) {
        if (k < P * kTH) {
          const int p = k / kTH, h = ty0 + k % kTH - y0;
          svy[k] = h >= 0 && h < WY ? vyn[p * WY + h] : 0.0f;
        } else {
          const int k2 = k - P * kTH;
          const int p = k2 / kTW, w = tx0 + k2 % kTW - x0;
          svx[k2] = w >= 0 && w < WX && tx0 + k2 % kTW < Wc
                        ? vxn[p * WX + w] : 0.0f;
        }
      }
      __syncthreads();
      unsigned pm = 0;
      if (hc < Hc)
        for (int p = 0; p < P; ++p) pm |= (svy[p * kTH + warp] != 0.0f) << p;
      if (pm != 0 && active) {
        float t[kPMax][4];
#pragma unroll
        for (int q = 0; q < kPMax; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) t[q][v] = 0.0f;
        const float* ctn = ct + n * P * P * C + c;
        for (unsigned m = pm; m; m &= m - 1) {
          const int p = __ffs(m) - 1;
          const float a = svy[p * kTH + warp];
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
                  x[v] = v < nc ? __ldg(ctp + static_cast<size_t>(q) * C + v)
                                : 0.0f;
              }
#pragma unroll
              for (int v = 0; v < 4; ++v) t[q][v] = fmaf(a, x[v], t[q][v]);
            }
          }
        }
#pragma unroll
        for (int w = 0; w < kTW; ++w) {
#pragma unroll
          for (int q = 0; q < kPMax; ++q) {
            if (q < P) {
              const float a = svx[q * kTW + w];
#pragma unroll
              for (int v = 0; v < 4; ++v)
                acc[w][v] = fmaf(a, t[q][v], acc[w][v]);
            }
          }
        }
      }
      __syncthreads();   // svy / svx are restaged for the next row
    }
  }

  if (!touched || !active || hc >= Hc) return;
  float* row = canvas + ((static_cast<size_t>(b) * Hc + hc) * Wc + tx0) * C + c;
#pragma unroll
  for (int w = 0; w < kTW; ++w) {
    if (tx0 + w >= Wc) break;
    float* cell = row + static_cast<size_t>(w) * C;
    if (vec4) {
      float4 v4 = *reinterpret_cast<float4*>(cell);
      v4.x += acc[w][0];
      v4.y += acc[w][1];
      v4.z += acc[w][2];
      v4.w += acc[w][3];
      *reinterpret_cast<float4*>(cell) = v4;
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (v < nc) cell[v] += acc[w][v];
    }
  }
}

template <int kPMax, int kTW>
int launch(void* canvas, const void* starts, void* reach, const void* ct,
           const void* vy, const void* vx, int B, int Hc, int Wc, int C,
           int row_lo, int rows, int WY, int WX, int P, cudaStream_t s) {
  const dim3 block(32, kWarps);
  roi_reach_kernel<<<(rows + kWarps - 1) / kWarps, block, 0, s>>>(
      static_cast<int32_t*>(reach), static_cast<const int32_t*>(starts),
      static_cast<const float*>(vy), static_cast<const float*>(vx), B, Hc, Wc,
      row_lo, rows, WY, WX, P);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int tiles_y = (Hc + kTH - 1) / kTH;
  const int tiles_x = (Wc + kTW - 1) / kTW;
  const int vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  const dim3 grid(B * tiles_y * tiles_x, (C + kCT - 1) / kCT);
  roi_window_accum_det_kernel<kPMax, kTW><<<grid, block, 0, s>>>(
      static_cast<float*>(canvas), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(reach), static_cast<const float*>(ct),
      static_cast<const float*>(vy), static_cast<const float*>(vx), Hc, Wc, C,
      row_lo, rows, WY, WX, P, tiles_y, tiles_x, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// canvas: (B, Hc, Wc, C) f32, updated in place; starts: (N, 3) int32
// [img, y0, x0]; reach: (row_hi - row_lo, 5) int32 scratch; ct: (N, P, P,
// C) f32; vy: (N, P, WY) f32; vx: (N, P, WX) f32. P <= 16, WY and WX <=
// 128. Accumulates rows [row_lo, row_hi) only, in row order for every
// canvas cell. Launches on `stream` and returns cudaGetLastError().
extern "C" int roi_window_accum_det_launch(void* canvas, const void* starts,
                                           void* reach, const void* ct,
                                           const void* vy, const void* vx,
                                           int B, int Hc, int Wc, int C,
                                           int row_lo, int row_hi, int WY,
                                           int WX, int P, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows <= 0 || C <= 0 || P <= 0 || B <= 0 || Hc <= 0 || Wc <= 0)
    return static_cast<int>(cudaGetLastError());
  if (P > 16 || WY > kMaxWin || WX > kMaxWin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return P <= 8 ? launch<8, 16>(canvas, starts, reach, ct, vy, vx, B, Hc, Wc,
                                C, row_lo, rows, WY, WX, P, s)
                : launch<16, 8>(canvas, starts, reach, ct, vy, vx, B, Hc, Wc,
                                C, row_lo, rows, WY, WX, P, s);
}
