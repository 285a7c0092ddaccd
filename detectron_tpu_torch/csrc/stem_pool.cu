// Stem post-ops (K5) for sm_90a: AffineChannel + ReLU + 3x3/2 max pool.
//
// Replaces detectron_tpu/ops/pallas/fused_stem_kernel.py::stem_pool_pack
// (kernel body _stem_pool_kernel, fused_stem_kernel.py:418-470). For the
// raw stem-conv output x (B, Hp, Wp, C) bf16 and the frozen-BN scale s and
// bias b (C,) f32:
//
//   y[i, j, c]   = bf16(relu(f32(x[i, j, c]) * s[c] + b[c]))
//   out[y, x, c] = max over i in {2y-1, 2y, 2y+1}, j in {2x-1, 2x, 2x+1}
//                  inside the image of y[i, j, c]
//
// The multiply and the add round separately (__fmul_rn, __fadd_rn: no
// contraction to an FMA, which rounds once and could change the bf16
// result), as the Pallas kernel's two f32 ops do. Window cells outside the
// image are skipped; that equals the Pallas kernel's zero padding, since
// every y >= 0 and every window holds an image cell. The TPU kernel's x-pair
// lane packing is a TPU layout: this kernel writes plain NHWC
// (B, Hp/2, Wp/2, C).
//
// Design: one thread per output position and 8-channel group (16-byte
// loads and stores); each window row is read from L1/L2 by up to two
// output rows, and the affine is recomputed per read (ALU work the memory
// time hides). Bound: bytes (x read once, out written once; ~7 flops per
// input element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 channels per 16-byte vector

__global__ void stem_pool_kernel(const uint4* __restrict__ x,
                                 const float* __restrict__ s,
                                 const float* __restrict__ b,
                                 uint4* __restrict__ out, int B, int Hp,
                                 int Wp, int C) {
  const int groups = C / kVec;
  const int Ho = Hp / 2, Wo = Wp / 2;
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * groups;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  int64_t rest = idx / groups;
  const int ox = static_cast<int>(rest % Wo);
  rest /= Wo;
  const int oy = static_cast<int>(rest % Ho);
  const int bi = static_cast<int>(rest / Ho);

  float sc[kVec], bc[kVec], m[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sc[k] = s[g * kVec + k];
    bc[k] = b[g * kVec + k];
    m[k] = 0.0f;  // every affine+ReLU value is >= 0
  }
  for (int i = max(2 * oy - 1, 0); i <= min(2 * oy + 1, Hp - 1); ++i) {
    for (int j = max(2 * ox - 1, 0); j <= min(2 * ox + 1, Wp - 1); ++j) {
      const uint4 v = x[((static_cast<int64_t>(bi) * Hp + i) * Wp + j) * groups + g];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint32_t bits = (k & 1) ? (w[k / 2] & 0xffff0000u) : (w[k / 2] << 16);
        const float a = __fadd_rn(__fmul_rn(__uint_as_float(bits), sc[k]), bc[k]);
        // relu, then round to bf16; the max of bf16 values is exact in f32.
        m[k] = fmaxf(m[k], __bfloat162float(__float2bfloat16_rn(fmaxf(a, 0.0f))));
      }
    }
  }
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[k] = (__float_as_uint(m[2 * k]) >> 16) | (__float_as_uint(m[2 * k + 1]) & 0xffff0000u);
  }
  out[idx] = make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// x: (B, Hp, Wp, C) bf16, Hp and Wp even, C % 8 == 0, 16-byte aligned;
// s, b: (C,) f32; out: (B, Hp/2, Wp/2, C) bf16. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int stem_pool_launch(const void* x, const void* s, const void* b,
                                void* out, int B, int Hp, int Wp, int C,
                                void* stream) {
  const int64_t total = static_cast<int64_t>(B) * (Hp / 2) * (Wp / 2) * (C / kVec);
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    stem_pool_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(s),
        static_cast<const float*>(b), static_cast<uint4*>(out), B, Hp, Wp, C);
  }
  return static_cast<int>(cudaGetLastError());
}
