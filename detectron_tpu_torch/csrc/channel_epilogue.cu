// A convolution's per-channel epilogue in one pass, for sm_90a.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses the frozen-BN
// AffineChannel, the conv bias, the residual add and the ReLU into the
// convolution; the eager port ran each as its own bf16 elementwise kernel,
// with a round trip to device memory each. For a contiguous tensor y whose
// last axis holds C channels (a conv's NHWC output):
//
//   out = [relu]( y * s[c] + b[c]  [ + r * s_r[c] + b_r[c]  |  + r ] )
//
// with s absent for a bias alone (out = [relu](y + b[c])), r the
// bottleneck's shortcut (the identity, or branch1's conv output under its
// own affine). All math is float32: each multiply and add rounds on its
// own (__fmul_rn, __fadd_rn: no contraction to an FMA), in the order the
// plain version's torch ops take, then one rounding to the output dtype.
// The (C,) vectors are read in their own dtype, float32 or (for a bf16 y)
// bf16, and widened exactly, so the caller copies none of them.
// out may be y itself (the wrapper writes into the conv's fresh output):
// each element is read before it is written, by the one thread that owns
// it.
//
// Bound: bytes. y (and r) read once, out written once; 2-5 flops an
// element. Design: 16-byte vector loads and stores (8 bf16 or 4 f32 a
// thread), neighbouring threads on neighbouring vectors; C % 8 == 0, so a
// vector's channels are c0 .. c0 + n - 1 with c0 from the flat offset, and
// the (C,) vectors come as 16-byte loads through the read-only cache. A
// grid-stride loop over as many blocks as the SMs hold at once (the
// occupancy API), so no block waits for another to finish; the channel
// offset advances by the grid's stride modulo C, with no division in the
// loop. Instantiated for the forms the models call (scale with no
// residual, the identity or branch1's affine; a bias alone), each for a
// bf16 y with bf16 or float32 vectors and a float32 y with float32 ones;
// the ReLU is a flag, the same for every thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Residual { kNone = 0, kIdentity = 1, kAffine = 2 };

template <typename T>
struct Pack;

// 4 float32 values in a 16-byte vector.
template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// 8 bf16 values in a 16-byte vector, element 2k in the low half of word k.
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]));
      o[k] = lo | (hi << 16);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// kN values of a (C,) vector at channel c0 (16-byte aligned), as floats.
template <int kN>
__device__ __forceinline__ void load_channels(const float* __restrict__ p, int c0,
                                              float* f) {
  const float4* q = reinterpret_cast<const float4*>(p + c0);
#pragma unroll
  for (int k = 0; k < kN / 4; ++k) {
    const float4 v = __ldg(q + k);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

template <int kN>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* __restrict__ p, int c0,
                                              float* f) {
  static_assert(kN == Pack<__nv_bfloat16>::kN, "bf16 vectors go with a bf16 y");
  Pack<__nv_bfloat16>::unpack(__ldg(reinterpret_cast<const uint4*>(p + c0)), f);
}

// y, r and out are not __restrict__: out may be y.
template <typename T, typename V, bool kScale, int kRes>
__global__ void __launch_bounds__(kThreads)
    channel_epilogue_kernel(const uint4* y, const V* __restrict__ s,
                            const V* __restrict__ b, const uint4* r,
                            const V* __restrict__ sr, const V* __restrict__ br,
                            uint4* out, int64_t nvec, int cvec, bool relu) {
  constexpr int kN = Pack<T>::kN;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int step = static_cast<int>(stride % cvec);
  int cv = static_cast<int>(start % cvec);  // this vector's channel group
  for (int64_t i = start; i < nvec; i += stride) {
    const int c0 = cv * kN;
    float t[kN], p[kN];
    Pack<T>::unpack(y[i], t);
    load_channels<kN>(b, c0, p);
    if (kScale) {
      float sc[kN];
      load_channels<kN>(s, c0, sc);
#pragma unroll
      for (int k = 0; k < kN; ++k) t[k] = __fadd_rn(__fmul_rn(t[k], sc[k]), p[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) t[k] = __fadd_rn(t[k], p[k]);
    }
    if (kRes != kNone) {
      float u[kN];
      Pack<T>::unpack(r[i], u);
      if (kRes == kAffine) {
        float sc[kN];
        load_channels<kN>(sr, c0, sc);
        load_channels<kN>(br, c0, p);
#pragma unroll
        for (int k = 0; k < kN; ++k) u[k] = __fadd_rn(__fmul_rn(u[k], sc[k]), p[k]);
      }
#pragma unroll
      for (int k = 0; k < kN; ++k) t[k] = __fadd_rn(t[k], u[k]);
    }
    if (relu) {
      // NaN passes, as torch.relu lets it.
#pragma unroll
      for (int k = 0; k < kN; ++k) t[k] = t[k] < 0.0f ? 0.0f : t[k];
    }
    out[i] = Pack<T>::pack(t);
    cv += step;
    if (cv >= cvec) cv -= cvec;
  }
}

struct Args {
  const void* y;
  const void* s;
  const void* b;
  const void* r;
  const void* sr;
  const void* br;
  void* out;
  int64_t nvec;
  int cvec;
  bool relu;
  int sms;
};

template <typename T, typename V, bool kScale, int kRes>
void launch(const Args& a, cudaStream_t stream) {
  auto kernel = channel_epilogue_kernel<T, V, kScale, kRes>;
  // Blocks an SM holds at once: asked once for each instantiation.
  static int per_sm = 0;
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    per_sm = n > 0 ? n : 1;
  }
  const int64_t need = (a.nvec + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(a.sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  const V* s = static_cast<const V*>(a.s);
  const V* b = static_cast<const V*>(a.b);
  const V* sr = static_cast<const V*>(a.sr);
  const V* br = static_cast<const V*>(a.br);
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const uint4*>(a.y), s, b,
                                          static_cast<const uint4*>(a.r), sr, br,
                                          static_cast<uint4*>(a.out), a.nvec, a.cvec,
                                          a.relu);
}

// The forms the models call; any other returns false.
template <typename T, typename V>
bool by_form(const Args& a, cudaStream_t stream) {
  if (a.s == nullptr) {
    if (a.r != nullptr) return false;
    launch<T, V, false, kNone>(a, stream);
  } else if (a.r == nullptr) {
    launch<T, V, true, kNone>(a, stream);
  } else if (a.sr == nullptr) {
    launch<T, V, true, kIdentity>(a, stream);
  } else {
    launch<T, V, true, kAffine>(a, stream);
  }
  return true;
}

}  // namespace

// y, r, out: n elements (n % 8 == 0) of a contiguous tensor whose last axis
// holds C channels (C % 8 == 0), bf16 (dtype 1) or float32 (dtype 0), each
// 16-byte aligned; r null for no residual; out may equal y. s (null for a
// bias alone), b, sr and br: (C,) vectors in vdtype (bf16 1, only with a
// bf16 y, or float32 0), 16-byte aligned; sr and br null for an identity
// residual; a bias alone takes no residual. sms: the card's SM count.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a form or dtype pair it does not take.
extern "C" int channel_epilogue_launch(const void* y, const void* s, const void* b,
                                       const void* r, const void* sr, const void* br,
                                       void* out, int64_t n, int C, int dtype,
                                       int vdtype, int relu, int sms, void* stream) {
  const int kn = dtype == 1 ? 8 : 4;
  const Args a{y, s, b, r, sr, br, out, n / kn, C / kn, relu != 0, sms};
  if (a.nvec == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool known = false;
  if (dtype == 1 && vdtype == 1) {
    known = by_form<__nv_bfloat16, __nv_bfloat16>(a, st);
  } else if (dtype == 1 && vdtype == 0) {
    known = by_form<__nv_bfloat16, float>(a, st);
  } else if (dtype == 0 && vdtype == 0) {
    known = by_form<float, float>(a, st);
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
