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
// What bounds it on the card: bytes, the canvas cells the weights reach.
// The weights are sparse: each pooled row p of vy is nonzero on about
// roi_h / P + 2 window rows (2 samples x 2 bilinear taps), and a RoI
// reaches only part of its window (a base box window is 32 x 48 cells; a
// RoI spans about 7 to 28 of them), so a dense contraction over the window
// reads and multiplies mostly zeros. RoIs overlap: at the box head's 2000
// RoIs the cells reached RoI by RoI are about 4x the distinct cells the
// bound counts, and each RoI reads its own.
//
// Design: one CTA per (RoI row, 256-byte channel tile: 128 bf16 or 64 f32
// channels), one warp per pooled row p, 8 bytes of channels per thread.
//  - vy and vx are staged in shared memory as f32; each warp finds the
//    first and last nonzero window row of vy[p, :] and column of vx[p, :]
//    (ballots), clipped at the canvas edge. Their unions bound the cells
//    the RoI reaches; a RoI whose weights are all zero writes zeros. Each
//    window column also gets a bit mask of the q with vx[q, w] != 0.
//  - The reached block is staged column chunk by column chunk (at most
//    kStageCells cells, 32 KB) into shared memory with 16-byte cp.async
//    copies: each reached cell is read once per (RoI, channel tile).
//  - Warp p contracts y first, over its own row range only: for each
//    column w, t = sum_h vy[p, h] * win[h, w, c] in registers, then
//    out[p, q, c] += vx[q, w] * t for the q of w's mask, the P sums held in
//    registers across chunks. Sums run h ascending in t and w ascending in
//    out, one multiply-add per term, as the dense contraction would; only
//    the terms of zero weight outside p's rows and w's q are left out, and
//    those add exact zeros, so the f32 sums are the dense ones.
// Tensor cores are not needed: the nonzero contractions are about 1 GFLOP
// at the box-head shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 128;
constexpr int kTileBytes = 32 * 8;                 // channel tile per cell
constexpr int kStageCells = 128;                   // cells per stage
constexpr int kStageBytes = kStageCells * kTileBytes;
static_assert(kStageCells >= kMaxWin, "a stage holds a whole window column");

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

// 8 bytes of channels per thread: kV = 4 bf16 or 2 f32 channels.
template <typename T>
struct Lanes {
  static constexpr int kV = 8 / sizeof(T);
  __device__ static void load(const T* p, float* v) {
    alignas(8) T x[kV];
    *reinterpret_cast<uint2*>(x) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = to_f32(x[i]);
  }
  // The first n (<= kV) of the kV values.
  __device__ static void store(T* p, const float* v, int n) {
    if (n >= kV && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
      alignas(8) T x[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) x[i] = from_f32<T>(v[i]);
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(x);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (i < n) p[i] = from_f32<T>(v[i]);
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// First and last index of row[0, len) that is nonzero (-1 and -2 when
// none), the same in every thread of the warp.
__device__ __forceinline__ int2 nonzero_range(const float* row, int len) {
  int lo = -1, hi = -2;
  for (int k0 = 0; k0 < len; k0 += 32) {
    const int k = k0 + static_cast<int>(threadIdx.x);
    const unsigned bits =
        __ballot_sync(0xffffffffu, k < len && row[k] != 0.0f);
    if (bits) {
      if (lo < 0) lo = k0 + __ffs(bits) - 1;
      hi = k0 + 31 - __clz(bits);
    }
  }
  return make_int2(lo, hi);
}

template <typename T, int kPMax>
__global__ void __launch_bounds__(32 * kPMax)
roi_window_pool_kernel(const T* __restrict__ canvas,
                       const int32_t* __restrict__ starts,
                       const T* __restrict__ vy, const T* __restrict__ vx,
                       T* __restrict__ out, int B, int Hc, int Wc, int C,
                       int row_lo, int WY, int WX, int P, int vec16) {
  using L = Lanes<T>;
  constexpr int kV = L::kV;
  constexpr int kCT = 32 * kV;                     // channels per tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);             // [cells][kCT]
  float* svy = reinterpret_cast<float*>(smem + kStageBytes);
  float* svx = svy + P * WY;
  __shared__ int2 yr[kPMax];
  __shared__ int ext[4];                           // y lo, y hi, x lo, x hi
  __shared__ unsigned short qmask[kMaxWin];        // q with vx[q, w] != 0

  const size_t n = static_cast<size_t>(row_lo) + blockIdx.x;
  const int t = threadIdx.x;
  const int p = threadIdx.y;
  const int tid = p * 32 + t;
  const int nthreads = 32 * P;
  const int c0 = blockIdx.y * kCT;
  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];
  const bool inside = b >= 0 && b < B && y0 >= 0 && x0 >= 0;

  for (int k = tid; k < P * WY; k += nthreads)
    svy[k] = to_f32(vy[n * P * WY + k]);
  for (int k = tid; k < P * WX; k += nthreads)
    svx[k] = to_f32(vx[n * P * WX + k]);
  if (tid == 0) {
    ext[0] = ext[2] = kMaxWin;
    ext[1] = ext[3] = -1;
  }
  __syncthreads();
  for (int w = tid; w < WX; w += nthreads) {
    unsigned m = 0;
    for (int q = 0; q < P; ++q) m |= (svx[q * WX + w] != 0.0f) << q;
    qmask[w] = static_cast<unsigned short>(m);
  }

  // Warp p: the rows of vy[p, :] and the columns of vx[p, :] with nonzero
  // weight, clipped at the canvas edge (cells past it are never read).
  int2 ry = nonzero_range(svy + p * WY, WY);
  int2 rx = nonzero_range(svx + p * WX, WX);
  ry.y = min(ry.y, Hc - y0 - 1);
  rx.y = min(rx.y, Wc - x0 - 1);
  if (!inside || ry.x < 0) ry = make_int2(0, -1);
  if (t == 0) {
    yr[p] = ry;
    if (ry.x <= ry.y) {
      atomicMin(&ext[0], ry.x);
      atomicMax(&ext[1], ry.y);
    }
    if (inside && rx.x >= 0 && rx.x <= rx.y) {
      atomicMin(&ext[2], rx.x);
      atomicMax(&ext[3], rx.y);
    }
  }
  __syncthreads();
  const int ylo = ext[0], yhi = ext[1];
  const int xlo = ext[2], xhi = ext[3];
  const int nh = yhi - ylo + 1;
  const int c = c0 + kV * t;                       // this thread's channels

  float acc[kPMax][kV];
#pragma unroll
  for (int q = 0; q < kPMax; ++q)
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[q][v] = 0.0f;

  if (nh > 0 && xlo <= xhi) {
    const int wt = kStageCells / nh;               // >= 1: nh <= 128
    const T* base = canvas +
        ((static_cast<size_t>(b) * Hc + y0 + ylo) * Wc + x0) * C + c0;
    const int2 my = yr[p];
    for (int wc = xlo; wc <= xhi; wc += wt) {
      const int nwc = min(wt, xhi - wc + 1);
      const int cells = nh * nwc;
      if (vec16) {
        // 16-byte pieces of each cell's channel tile.
        constexpr int kPiece = 16 / sizeof(T);
        for (int k = tid; k < cells * (kCT / kPiece); k += nthreads) {
          const int cell = k / (kCT / kPiece);
          const int ch = (k % (kCT / kPiece)) * kPiece;
          if (c0 + ch < C) {
            const int hh = cell / nwc, ww = cell % nwc;
            cp_async16(win + cell * kCT + ch,
                       base + (static_cast<size_t>(hh) * Wc + wc + ww) * C +
                           ch);
          }
        }
        cp_async_wait_all();
      } else {
        for (int k = tid; k < cells * kCT; k += nthreads) {
          const int cell = k / kCT, ch = k % kCT;
          if (c0 + ch < C) {
            const int hh = cell / nwc, ww = cell % nwc;
            win[cell * kCT + ch] =
                base[(static_cast<size_t>(hh) * Wc + wc + ww) * C + ch];
          }
        }
      }
      __syncthreads();

      if (c < C) {
        const float* wy = svy + p * WY;
        for (int ww = 0; ww < nwc; ++ww) {
          float t1[kV];
#pragma unroll
          for (int v = 0; v < kV; ++v) t1[v] = 0.0f;
          for (int h = my.x; h <= my.y; ++h) {
            const float a = wy[h];
            float x[kV];
            L::load(win + ((h - ylo) * nwc + ww) * kCT + kV * t, x);
#pragma unroll
            for (int v = 0; v < kV; ++v) t1[v] = fmaf(a, x[v], t1[v]);
          }
          const float* wxc = svx + wc + ww;
          const unsigned qm = qmask[wc + ww];
#pragma unroll
          for (int q = 0; q < kPMax; ++q) {
            if ((qm >> q) & 1) {
              const float a = wxc[q * WX];
#pragma unroll
              for (int v = 0; v < kV; ++v)
                acc[q][v] = fmaf(a, t1[v], acc[q][v]);
            }
          }
        }
      }
      // The next chunk overwrites the stage.
      __syncthreads();
    }
  }

  if (c < C) {
    T* o = out + (n * P + p) * P * C + c;
#pragma unroll
    for (int q = 0; q < kPMax; ++q) {
      if (q < P) L::store(o + static_cast<size_t>(q) * C, acc[q], C - c);
    }
  }
}

template <typename T, int kPMax>
int launch(const void* canvas, const void* starts, const void* vy,
           const void* vx, void* out, int B, int Hc, int Wc, int C,
           int row_lo, int rows, int WY, int WX, int P, cudaStream_t s) {
  constexpr int kCT = kTileBytes / sizeof(T);
  const size_t smem =
      kStageBytes + static_cast<size_t>(P) * (WY + WX) * sizeof(float);
  auto kernel = roi_window_pool_kernel<T, kPMax>;
  // Above 48 KB of shared memory only after opting in, once per instance
  // for the largest stage (P = 16, 128 x 128 windows).
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes + 16 * 2 * kMaxWin * static_cast<int>(sizeof(float)));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int vec16 = reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                    (static_cast<size_t>(C) * sizeof(T)) % 16 == 0;
  const dim3 grid(rows, (C + kCT - 1) / kCT);
  kernel<<<grid, dim3(32, P), smem, s>>>(
      static_cast<const T*>(canvas), static_cast<const int32_t*>(starts),
      static_cast<const T*>(vy), static_cast<const T*>(vx),
      static_cast<T*>(out), B, Hc, Wc, C, row_lo, WY, WX, P, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// canvas: (B, Hc, Wc, C); starts: (N, 3) int32 [img, y0, x0]; vy: (N, P, WY);
// vx: (N, P, WX); out: (N, P, P, C). Pools rows [row_lo, row_hi) only.
// P <= 16, WY and WX <= 128. dtype: 0 = float32, 1 = bfloat16 (canvas, vy,
// vx and out share it). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int roi_window_pool_launch(const void* canvas, const void* starts,
                                      const void* vy, const void* vx,
                                      void* out, int B, int Hc, int Wc, int C,
                                      int row_lo, int row_hi, int WY, int WX,
                                      int P, int dtype, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows <= 0 || C <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  if (P > 16 || WY > kMaxWin || WX > kMaxWin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return P <= 8 ? launch<__nv_bfloat16, 8>(canvas, starts, vy, vx, out, B,
                                             Hc, Wc, C, row_lo, rows, WY, WX,
                                             P, s)
                  : launch<__nv_bfloat16, 16>(canvas, starts, vy, vx, out, B,
                                              Hc, Wc, C, row_lo, rows, WY, WX,
                                              P, s);
  }
  return P <= 8 ? launch<float, 8>(canvas, starts, vy, vx, out, B, Hc, Wc, C,
                                   row_lo, rows, WY, WX, P, s)
                : launch<float, 16>(canvas, starts, vy, vx, out, B, Hc, Wc,
                                    C, row_lo, rows, WY, WX, P, s);
}
