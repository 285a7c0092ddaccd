// The fused res2 stage (K6) for sm_90a: three bottleneck blocks, 64 -> 256
// channels, frozen BN folded into the weights, forward only.
//
// Replaces detectron_tpu/ops/pallas/fused_stem_kernel.py::fused_res2
// (kernel body _kernel, fused_stem_kernel.py:269-325). With act() the
// activation dtype T (bf16 or f32), every conv f32-accumulates the T-valued
// operands and adds an f32 bias:
//
//   a0 = act(relu(x . wa0 + ba0))          b0 = act(relu(a0 (*) wb0 + bb0))
//   h0 = act(relu(b0 . wc0 + x . ws0 + bc0))        (one f32 sum; bc0 = bc+bs)
//   for blocks i = 1, 2:
//     ai = act(relu(h . wai + bai))        bi = act(relu(ai (*) wbi + bbi))
//     h  = act(relu(act(bi . wci + bci) + h))       (the add in T)
//
// where . is a 1x1 conv and (*) a 3x3 conv with zero padding: every 3x3
// sees zeros outside the image, rows and columns (the folded 1x1 before it
// would give relu(bias) there), so a0, a1 and a2 are set to 0 at every
// position outside the image, as the Pallas kernel's zero_edge_rows and
// edge-column masks do.
//
// Design (first version): one CTA of 512 threads per (image, TY x TX output
// tile) runs the whole stage with every intermediate in shared memory, as
// the TPU kernel keeps them in VMEM; only x is read and only the output is
// written. The tile carries a 3-cell halo: level L of the tile is the
// (TY + 6 - 2L) x (TX + 6 - 2L) grid around it, and a0 is computed on level
// 0, b0/h0/a1 on level 1, b1/h1/a2 on level 2, b2/h2 on the tile. Three
// buffers, reused as values die:
//   X  (level 0 x 64):  x, then a1, then a2
//   Bf (level 1 x 64):  b0, then b1, then b2
//   Hb (level 1 x 256): a0 (level 0 x 64), then h0; h1 and h2 in place
// Activations are stored in T, position-major with channels contiguous and
// 16-byte chunks XOR-swizzled by position (no bank conflicts on the
// fragment loads). Each conv is an implicit GEMM (rows: the grid's
// positions, K: taps x input channels, N: output channels) split into
// warp items of one 16-row m-tile by NT 8-column n-tiles, with the
// accumulators in the mma.sync m16n8 fragment layout. bf16 runs
// mma.sync.m16n8k16 (f32 accumulation) at 8 x 16 tiles (189 KB of shared
// memory); f32 runs the same items with scalar FMAs at 4 x 8 tiles (155
// KB). Weights (426 KB in bf16) are read from L1/L2 in (Cout, kh, kw, Cin)
// layout, which is the mma's B fragment order.
//
// Bound: in bf16, operations (59.5 GFLOP at (2, 208, 336, 64) against 89.5
// MB of bytes). The halo recomputes 1.5x the stage's MACs at 8 x 16 tiles;
// the weight loads from L1, not the tensor cores, are expected to limit
// this version. wgmma, TMA staging of the weights and larger tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Packed weights (elements), each (Cout, kh, kw, Cin); see
// ops/cuda/fused_stem_kernel.py::pack_res2_weights.
constexpr int kWa0 = 0;
constexpr int kWb0 = kWa0 + 64 * 64;
constexpr int kWc0 = kWb0 + 64 * 576;
constexpr int kWs0 = kWc0 + 256 * 64;
constexpr int kWa1 = kWs0 + 256 * 64;
constexpr int kWb1 = kWa1 + 64 * 256;
constexpr int kWc1 = kWb1 + 64 * 576;
constexpr int kWa2 = kWc1 + 256 * 64;
constexpr int kWb2 = kWa2 + 64 * 256;
constexpr int kWc2 = kWb2 + 64 * 576;
// Biases (f32): ba, bb, bc of each block.
constexpr int kBiasBlock = 64 + 64 + 256;

enum Epilogue { kRelu, kReluMasked, kResidual };

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// Element index of channel ch of position pos in a buffer of C channels.
template <typename T>
__device__ __forceinline__ int swz(int pos, int ch, int C) {
  constexpr int E = 16 / sizeof(T);
  return pos * C + (((ch / E) ^ (pos & 7)) * E) + (ch % E);
}

template <typename T>
__device__ __forceinline__ float round_act(float v) {
  if constexpr (kIsBf16<T>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Loads / stores of the channel pair (ch, ch + 1), ch even.
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  if constexpr (kIsBf16<T>) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (kIsBf16<T>) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
    *reinterpret_cast<uint32_t*>(p) = lo | (hi << 16);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand of a conv: output position (r, c) reads input position
// (r + oy + dy, c + ox + dx) of `in` (a grid of width wi, cin channels) for
// the taps 0 <= dy, dx < taps, against w (Cout, taps, taps, cin).
template <typename T>
struct Operand {
  const T* in;
  int cin, wi, oy, ox, taps;
  const T* w;
};

// acc[nt] += the operand's product for the warp's rows (input base
// positions p0, p1: fragment rows g and g + 8) and output channels
// n0 + 8 nt + {2t, 2t + 1} (bf16: B columns n0 + 8 nt + g).
template <typename T, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4], const Operand<T> op, int p0, int p1,
                                           int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ldw = op.taps * op.taps * op.cin;
  for (int dy = 0; dy < op.taps; ++dy) {
    for (int dx = 0; dx < op.taps; ++dx) {
      const int q0 = p0 + dy * op.wi + dx, q1 = p1 + dy * op.wi + dx;
      const T* wt = op.w + (dy * op.taps + dx) * op.cin;
      if constexpr (kIsBf16<T>) {
        for (int k = 0; k < op.cin; k += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(op.in + swz<T>(q0, k + 2 * t, op.cin));
          a[1] = *reinterpret_cast<const uint32_t*>(op.in + swz<T>(q1, k + 2 * t, op.cin));
          a[2] = *reinterpret_cast<const uint32_t*>(op.in + swz<T>(q0, k + 2 * t + 8, op.cin));
          a[3] = *reinterpret_cast<const uint32_t*>(op.in + swz<T>(q1, k + 2 * t + 8, op.cin));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const unsigned int* wr = reinterpret_cast<const unsigned int*>(
                wt + (n0 + nt * 8 + g) * ldw + k + 2 * t);
            mma_bf16(acc[nt], a, __ldg(wr), __ldg(wr + 4));
          }
        }
      } else {
        for (int k = 0; k < op.cin; ++k) {
          const float a0 = op.in[swz<T>(q0, k, op.cin)];
          const float a1 = op.in[swz<T>(q1, k, op.cin)];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + nt * 8 + 2 * t;
            const float w0 = __ldg(wt + n * ldw + k);
            const float w1 = __ldg(wt + (n + 1) * ldw + k);
            acc[nt][0] = fmaf(a0, w0, acc[nt][0]);
            acc[nt][1] = fmaf(a0, w1, acc[nt][1]);
            acc[nt][2] = fmaf(a1, w0, acc[nt][2]);
            acc[nt][3] = fmaf(a1, w1, acc[nt][3]);
          }
        }
      }
    }
  }
}

// Where a conv's output goes: position (r, c) of the ho x wo output grid is
// cell (r + py, c + px) of `buf` (a grid of width wb, n channels); its image
// cell is (gy + r, gx + c) of the H x W image.
template <typename T>
struct Target {
  T* buf;
  int wb, py, px;
  int gy, gx;
};

// One conv over an ho x wo grid with n output channels: the sum of op0 and
// (if op1.in) op1, plus bias, then the epilogue.
template <typename T, int NT, Epilogue EPI>
__device__ __forceinline__ void conv(const Operand<T> op0, const Operand<T> op1, int ho, int wo,
                                     int n, const float* __restrict__ bias, const Target<T> out,
                                     int H, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_total = ho * wo;
  const int mtiles = (m_total + 15) / 16;
  const int nblocks = n / (8 * NT);
  for (int item = warp; item < mtiles * nblocks; item += kWarps) {
    const int mt = item % mtiles;
    const int n0 = (item / mtiles) * 8 * NT;
    int r[2], c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(mt * 16 + g + 8 * h, m_total - 1);
      r[h] = m / wo;
      c[h] = m % wo;
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
    }
    accumulate<T, NT>(acc, op0, (r[0] + op0.oy) * op0.wi + c[0] + op0.ox,
                      (r[1] + op0.oy) * op0.wi + c[1] + op0.ox, n0, lane);
    if (op1.in != nullptr) {
      accumulate<T, NT>(acc, op1, (r[0] + op1.oy) * op1.wi + c[0] + op1.ox,
                        (r[1] + op1.oy) * op1.wi + c[1] + op1.ox, n0, lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (mt * 16 + g + 8 * h >= m_total) continue;
      const int pos = (r[h] + out.py) * out.wb + c[h] + out.px;
      const int gy = out.gy + r[h], gx = out.gx + c[h];
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ch = n0 + nt * 8 + 2 * t;
        float v0 = acc[nt][2 * h] + bias[ch];
        float v1 = acc[nt][2 * h + 1] + bias[ch + 1];
        T* dst = out.buf + swz<T>(pos, ch, n);
        if constexpr (EPI == kResidual) {
          const float2 prev = load_pair(dst);
          v0 = fmaxf(round_act<T>(v0) + prev.x, 0.0f);
          v1 = fmaxf(round_act<T>(v1) + prev.y, 0.0f);
        } else {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
          if (EPI == kReluMasked && !inside) v0 = v1 = 0.0f;
        }
        store_pair(dst, v0, v1);
      }
    }
  }
}

template <int TY, int TX>
struct Tile {
  static constexpr int W0 = TX + 6, W1 = TX + 4, W2 = TX + 2;
  static constexpr int L0 = (TY + 6) * W0, L1 = (TY + 4) * W1;
  static constexpr int kX = L0 * 64, kB = L1 * 64;
  static constexpr int kH = L1 * 256 > L0 * 64 ? L1 * 256 : L0 * 64;
  static constexpr int kElems = kX + kB + kH;
};

template <typename T, int TY, int TX>
__global__ void __launch_bounds__(kThreads, 1)
fused_res2_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                  T* __restrict__ out, int H, int W) {
  using G = Tile<TY, TX>;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* X = reinterpret_cast<T*>(smem);
  T* Bf = X + G::kX;
  T* Hb = Bf + G::kB;
  const int64_t img = blockIdx.z;
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int gy0 = ty0 - 3, gx0 = tx0 - 3;  // image cell of level 0's (0, 0)

  // The input tile with its 3-cell halo; zeros outside the image.
  for (int i = threadIdx.x; i < G::L0 * (64 / E); i += kThreads) {
    const int pos = i / (64 / E), ch = (i % (64 / E)) * E;
    const int gy = gy0 + pos / G::W0, gx = gx0 + pos % G::W0;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = __ldg(reinterpret_cast<const uint4*>(x + ((img * H + gy) * W + gx) * 64 + ch));
    }
    *reinterpret_cast<uint4*>(X + swz<T>(pos, ch, 64)) = v;
  }
  __syncthreads();

  const Operand<T> none{nullptr, 0, 0, 0, 0, 0, nullptr};
  const float* b0 = bias;
  const float* b1 = bias + kBiasBlock;
  const float* b2 = bias + 2 * kBiasBlock;
  // Block 0.
  conv<T, 4, kReluMasked>(Operand<T>{X, 64, G::W0, 0, 0, 1, w + kWa0}, none, TY + 6, G::W0, 64,
                          b0, Target<T>{Hb, G::W0, 0, 0, gy0, gx0}, H, W);
  __syncthreads();
  conv<T, 8, kRelu>(Operand<T>{Hb, 64, G::W0, 0, 0, 3, w + kWb0}, none, TY + 4, G::W1, 64,
                    b0 + 64, Target<T>{Bf, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W);
  __syncthreads();
  conv<T, 8, kRelu>(Operand<T>{Bf, 64, G::W1, 0, 0, 1, w + kWc0},
                    Operand<T>{X, 64, G::W0, 1, 1, 1, w + kWs0}, TY + 4, G::W1, 256, b0 + 128,
                    Target<T>{Hb, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W);
  __syncthreads();
  // Block 1: h1 overwrites h0 cell by cell (each cell reads its own h0).
  conv<T, 8, kReluMasked>(Operand<T>{Hb, 256, G::W1, 0, 0, 1, w + kWa1}, none, TY + 4, G::W1, 64,
                          b1, Target<T>{X, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W);
  __syncthreads();
  conv<T, 8, kRelu>(Operand<T>{X, 64, G::W1, 0, 0, 3, w + kWb1}, none, TY + 2, G::W2, 64,
                    b1 + 64, Target<T>{Bf, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W);
  __syncthreads();
  conv<T, 8, kResidual>(Operand<T>{Bf, 64, G::W2, 0, 0, 1, w + kWc1}, none, TY + 2, G::W2, 256,
                        b1 + 128, Target<T>{Hb, G::W1, 1, 1, gy0 + 2, gx0 + 2}, H, W);
  __syncthreads();
  // Block 2.
  conv<T, 8, kReluMasked>(Operand<T>{Hb, 256, G::W1, 1, 1, 1, w + kWa2}, none, TY + 2, G::W2, 64,
                          b2, Target<T>{X, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W);
  __syncthreads();
  conv<T, 4, kRelu>(Operand<T>{X, 64, G::W2, 0, 0, 3, w + kWb2}, none, TY, TX, 64, b2 + 64,
                    Target<T>{Bf, TX, 0, 0, ty0, tx0}, H, W);
  __syncthreads();
  conv<T, 8, kResidual>(Operand<T>{Bf, 64, TX, 0, 0, 1, w + kWc2}, none, TY, TX, 256, b2 + 128,
                        Target<T>{Hb, G::W1, 2, 2, ty0, tx0}, H, W);
  __syncthreads();

  // The tile's h2, from level 1's cells (r + 2, c + 2), to the output.
  for (int i = threadIdx.x; i < TY * TX * (256 / E); i += kThreads) {
    const int pos = i / (256 / E), ch = (i % (256 / E)) * E;
    const int r = pos / TX, c = pos % TX;
    if (ty0 + r < H && tx0 + c < W) {
      *reinterpret_cast<uint4*>(out + ((img * H + ty0 + r) * W + tx0 + c) * 256 + ch) =
          *reinterpret_cast<const uint4*>(Hb + swz<T>((r + 2) * G::W1 + c + 2, ch, 256));
    }
  }
}

template <typename T, int TY, int TX>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const size_t smem = sizeof(T) * Tile<TY, TX>::kElems;
  cudaError_t err = cudaFuncSetAttribute(fused_res2_kernel<T, TY, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fused_res2_kernel<T, TY, TX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, 64), out: (B, H, W, 256), both NHWC in the activation dtype
// (dtype 1 = bf16, 0 = f32), 16-byte aligned; w: the 212,992 packed folded
// weights in that dtype; bias: the 1,152 packed f32 biases. Launches on
// `stream` and returns cudaGetLastError() (or the attribute call's error).
extern "C" int fused_res2_launch(const void* x, const void* w, const void* bias, void* out, int B,
                                 int H, int W, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16, 8, 16>(x, w, bias, out, B, H, W, s);
  return launch<float, 4, 8>(x, w, bias, out, B, H, W, s);
}
