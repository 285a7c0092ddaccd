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
// One CTA (512 threads in bf16, 384 in f32) per (image, TY x TX output
// tile) runs the whole stage with every intermediate in shared memory, as
// the TPU kernel keeps them in VMEM; only x (and the weights) are read and
// only the output is written. The tile carries a 3-cell halo: level L of the tile is the
// (TY + 6 - 2L) x (TX + 6 - 2L) grid around it, and a0 is computed on level
// 0, b0/h0/a1 on level 1, b1/h1/a2 on level 2, b2/h2 on the tile. Three
// activation buffers, reused as values die:
//   X  (level 0 x 64):  x, then a1, then a2
//   Bf (level 1 x 64):  b0, then b1, then b2
//   Hb (level 1 x 256): a0 (level 0 x 64), then h0; h1 and h2 in place
// Activations are stored in T, position-major with channels contiguous and
// 16-byte chunks XOR-swizzled by position (no bank conflicts on the
// fragment loads; swz for bf16, swz_f32 for f32). Each conv is an implicit
// GEMM (rows: the grid's positions, K: taps x input channels, N: output
// channels).
//
// bf16 (the path that TPU.FUSED_RES2 runs): 8 x 16 tiles, mma.sync m16n8k16
// with f32 accumulation. What bounds it: operations, 59.5 GFLOP at
// (2, 208, 336, 64) against 89.5 MB of bytes, and the halo's recompute on
// top (41.3 M multiply-adds per tile against the stage's 27.3 M, 1.51x).
// B fragments read from L1 for every mma (two 4-byte loads per fragment,
// each serving one 16-row m-tile) would bound it below the tensor cores'
// rate and cost registers, so the design:
//  - stages the weights in shared memory, shared by all 16 warps: the 52
//    chunks of 64 output x 64 input channels (8 KB each) that the nine
//    convs consume, in that order, go through a ring of kRing = 4 chunks
//    (32 KB), each chunk one 16-byte cp.async per thread, issued three
//    chunks ahead of its use (rows XOR-swizzled like the activations);
//  - reads A and B fragments with ldmatrix.x4: per k-step a warp loads one
//    A fragment per m-tile and two B fragments per pair of n-tiles;
//  - runs warp items of kM = 2 m-tiles x 4 n-tiles (a 32 x 32 block, 32
//    accumulators), so each B fragment serves two m-tiles (kM = 1 on the
//    tile grid, whose 8 m-tiles would leave half the warps idle). A conv
//    whose n-block takes several chunks (the 3x3s: one per tap; the 1x1s
//    from 256 channels: one per 64 inputs; block 0's branch2c + branch1:
//    one each) holds each warp's accumulators across them: at most 16
//    items per n-block there, one per warp.
// Shared memory: 189 KB of activations + the 32 KB ring = 220.5 KB of the
// 227 KB a block can have, at the 8 x 16 tile and its 1.51x halo factor.
//
// f32 (TPU.FUSED_RES2's "auto" mode, which the default TPU.COMPUTE_DTYPE
// float32 takes): the same stage on the tensor cores at f32 accuracy,
// 3xTF32. What bounds it: operations, 59.5 GFLOP at (2, 208, 336, 64)
// against 179 MB of bytes; three TF32 products run at 494.7 / 3 TFLOP/s,
// f32 FMAs at 67. The design:
//  - every operand splits into a TF32 head (cvt.rna.tf32.f32's rounding)
//    and the TF32 head of its remainder, and each m16n8k8 product is
//    lo(a) hi(w) + hi(a) lo(w) + hi(a) hi(w) (the dropped lo lo term and
//    the tails' rounding are ~2^-22 of a product); the wrapper splits the
//    weights once, the kernel the activations as it loads their fragments;
//  - the tensor cores' own f32 sums round toward zero, which over a whole
//    conv's K drifts past 1e-5 of the result (measured: 1.14e-5 of
//    max|ref| with one accumulator chain): each weight chunk's products
//    (4 k-steps, a chain of 12 mma) sum from zero and join the conv's sum
//    by a rounded f32 add;
//  - the weights go through a shared-memory ring in the order the nine
//    convs consume them: 104 chunks of 64 output x 32 input channels, head
//    and tail (16 KB), two 16-byte cp.async per thread each, issued
//    one chunk ahead (a ring of kRingF = 2);
//  - activations stay f32 in shared memory, 16-byte pieces XOR-swizzled by
//    the position's low three bits reversed (swz_f32); a k-step maps the
//    mma's k to channel pairs, so that a lane's two A values of a row are
//    one 8-byte load and its B heads and tails one 16-byte load;
//  - each conv's warp items are one m-tile x NT n-tiles, NT set per level
//    (kNtL0 .. kNtT); a warp splits an A fragment once for all of its
//    item's NT n-tiles, so a few large items beat many small ones
//    (measured: 16 items a conv where the level allows ran ~1.4x slower).
// The tile is 8 x 6: 192 KB of activations and a ring of 2 chunks
// (224 KB), 1.87x halo recompute against 2.16x at 4 x 8. Twelve warps, not
// 16: the items need no more, and the registers are not spilled. Half
// chunks through a ring of 4 (twice the barriers, a prefetch three deep)
// ran 1.3x slower: the per-chunk barrier costs more than the copy's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Packed bf16 weights (elements), each (Cout, kh, kw, Cin); see
// ops/cuda/fused_stem_kernel.py::pack_res2_weights (f32: the chunks of
// pack_res2_weights_tf32).
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

// Where a conv's output goes: position (r, c) of the ho x wo output grid is
// cell (r + py, c + px) of `buf` (a grid of width wb, n channels); its image
// cell is (gy + r, gx + c) of the H x W image.
template <typename T>
struct Target {
  T* buf;
  int wb, py, px;
  int gy, gx;
};

template <int TY, int TX>
struct Tile {
  static constexpr int W0 = TX + 6, W1 = TX + 4, W2 = TX + 2;
  static constexpr int L0 = (TY + 6) * W0, L1 = (TY + 4) * W1;
  static constexpr int kX = L0 * 64, kB = L1 * 64;
  static constexpr int kH = L1 * 256 > L0 * 64 ? L1 * 256 : L0 * 64;
  static constexpr int kElems = kX + kB + kH;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores, weights staged in shared memory
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;                      // output x input channels
constexpr int kChunkElems = kChunk * kChunk;    // 8 KB in bf16
constexpr int kRing = 4;                        // chunks in shared memory
constexpr int kChunks = 52;                     // the nine convs' chunks
static_assert(kThreads == kChunk * kChunk * 2 / 16,
              "one 16-byte copy per thread per chunk");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunk i of the weights, in the order the convs consume them: its first
// element (output channel 0 of its n-block, input column 0 of its k-chunk)
// in the packed weights, and ldw, the conv's row length (K).
//   0: wa0 | 1-9: wb0, one per tap | 10-17: per n-block, wc0 then ws0 |
//   18-21: wa1 by 64 inputs | 22-30: wb1 | 31-34: wc1 by n-block |
//   35-38: wa2 | 39-47: wb2 | 48-51: wc2
__device__ __forceinline__ const bf16* chunk_src(const bf16* w, int i, int& ldw) {
  if (i < 1) { ldw = 64; return w + kWa0; }
  if (i < 10) { ldw = 576; return w + kWb0 + 64 * (i - 1); }
  if (i < 18) {
    ldw = 64;
    return w + ((i - 10) & 1 ? kWs0 : kWc0) + ((i - 10) >> 1) * kChunkElems;
  }
  if (i < 22) { ldw = 256; return w + kWa1 + 64 * (i - 18); }
  if (i < 31) { ldw = 576; return w + kWb1 + 64 * (i - 22); }
  if (i < 35) { ldw = 64; return w + kWc1 + (i - 31) * kChunkElems; }
  if (i < 39) { ldw = 256; return w + kWa2 + 64 * (i - 35); }
  if (i < 48) { ldw = 576; return w + kWb2 + 64 * (i - 39); }
  ldw = 64;
  return w + kWc2 + (i - 48) * kChunkElems;
}

// Chunk i (if any) into ring slot i % kRing, rows of 64 inputs with their
// 16-byte pieces XOR-swizzled by row; one commit group either way.
__device__ __forceinline__ void fetch_chunk(bf16* ring, const bf16* w, int i) {
  if (i < kChunks) {
    int ldw;
    const bf16* src = chunk_src(w, i, ldw);
    const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
    cp_async16(ring + (i % kRing) * kChunkElems + r * kChunk + ((j ^ (r & 7)) << 3),
               src + r * ldw + 8 * j);
  }
  cp_async_commit();
}

// The next chunk, once every thread's copy of it has landed; the barrier
// also ends every warp's use of the slot the prefetch refills, and every
// write of the conv before.
__device__ __forceinline__ const bf16* next_chunk(bf16* ring, const bf16* w, int& c) {
  cp_async_wait<kRing - 2>();
  __syncthreads();
  fetch_chunk(ring, w, c + kRing - 1);
  return ring + (c++ % kRing) * kChunkElems;
}

// One operand of a tensor-core conv (its weights come from the chunks).
struct OpTC {
  const bf16* in;
  int cin, wi, oy, ox, taps;
  __device__ int chunks() const { return taps * taps * cin / kChunk; }
};

// The epilogue of a warp item: kM m-tiles from m-tile mt0, the output
// channels ch0 + 8 nt + {2t, 2t + 1}.
template <Epilogue EPI, int kM>
__device__ __forceinline__ void epilogue_tc(const float (&acc)[kM][4][4], int mt0, int ch0,
                                            int m_total, int wo, int n,
                                            const float* __restrict__ bias,
                                            const Target<bf16> out, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + mi) * 16 + g + 8 * h;
      if (m >= m_total) continue;
      const int r = m / wo, c = m % wo;
      const int pos = (r + out.py) * out.wb + c + out.px;
      const int gy = out.gy + r, gx = out.gx + c;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = ch0 + nt * 8 + 2 * t;
        float v0 = acc[mi][nt][2 * h] + bias[ch];
        float v1 = acc[mi][nt][2 * h + 1] + bias[ch + 1];
        bf16* dst = out.buf + swz<bf16>(pos, ch, n);
        if constexpr (EPI == kResidual) {
          const float2 prev = load_pair(dst);
          v0 = fmaxf(round_act<bf16>(v0) + prev.x, 0.0f);
          v1 = fmaxf(round_act<bf16>(v1) + prev.y, 0.0f);
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

// Warp items of one n-block: kM m-tiles x 4 n-tiles (32 output channels),
// items = ceil(m-tiles / kM) x 2 halves of the block's 64 channels.
template <int kM>
__host__ __device__ constexpr int items_tc(int positions) {
  return ((positions + 15) / 16 + kM - 1) / kM * 2;
}

// One conv on the tensor cores over an ho x wo grid with n output channels:
// op0's chunks then (if op1.in) op1's per n-block of 64, plus bias, then the
// epilogue. c counts the weight chunks consumed so far.
template <Epilogue EPI, int kM>
__device__ __forceinline__ void conv_tc(const OpTC op0, const OpTC op1, int ho, int wo, int n,
                                        const float* __restrict__ bias, const Target<bf16> out,
                                        int H, int W, bf16* ring, const bf16* w, int& c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_total = ho * wo;
  const int groups = ((m_total + 15) / 16 + kM - 1) / kM;
  const int items = 2 * groups;
  const int nk0 = op0.chunks();
  const int nk = nk0 + (op1.in != nullptr ? op1.chunks() : 0);
  // Several chunks per n-block: each warp holds one item's accumulators
  // across them (the callers keep such convs at <= kWarps items).
  const bool hold = nk > 1;
  // This lane's ldmatrix rows: A row (lane & 7) + 8 ((lane >> 3) & 1) of
  // an m-tile at input piece lane >> 4; B row (lane & 7) + 8 (lane >> 4)
  // of an n-tile pair at piece (lane >> 3) & 1.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, apiece = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bpiece = (lane >> 3) & 1;

  for (int nb = 0; nb < n / kChunk; ++nb) {
    float acc[kM][4][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nt][k] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
      const bf16* sb = next_chunk(ring, w, c);
      // This chunk's operand, field by field (a reference to either
      // operand would put both on the stack).
      const bool first = kc < nk0;
      const bf16* in = first ? op0.in : op1.in;
      const int cin = first ? op0.cin : op1.cin, wi = first ? op0.wi : op1.wi;
      const int oy = first ? op0.oy : op1.oy, ox = first ? op0.ox : op1.ox;
      const int kk = first ? kc : kc - nk0;
      const bool taps3 = (first ? op0.taps : op1.taps) == 3;
      const int dy = taps3 ? kk / 3 : 0, dx = taps3 ? kk % 3 : 0;
      const int ch_in = taps3 ? 0 : kChunk * kk;
      for (int item = warp; item < items; item += kWarps) {
        const int grp = item % groups, half = item / groups;
        if (!hold) {
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[mi][nt][k] = 0.0f;
        }
        int pa[kM];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          const int m = min((grp * kM + mi) * 16 + arow, m_total - 1);
          const int r = m / wo, cc = m % wo;
          pa[mi] = (r + oy + dy) * wi + cc + ox + dx;
        }
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks) {
          uint32_t a[kM][4];
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
            ldmatrix_x4(a[mi], in + swz<bf16>(pa[mi], ch_in + 16 * ks + 8 * apiece, cin));
          uint32_t b[2][4];
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int nr = 32 * half + 16 * pp + brow;
            ldmatrix_x4(b[pp], sb + nr * kChunk + (((2 * ks + bpiece) ^ (nr & 7)) << 3));
          }
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mi][nt], a[mi], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
        }
        if (!hold)
          epilogue_tc<EPI, kM>(acc, grp * kM, kChunk * nb + 32 * half, m_total, wo, n, bias, out,
                               H, W);
      }
    }
    if (hold && warp < items)
      epilogue_tc<EPI, kM>(acc, (warp % groups) * kM, kChunk * nb + 32 * (warp / groups),
                           m_total, wo, n, bias, out, H, W);
  }
}

template <int TY, int TX>
__global__ void __launch_bounds__(kThreads, 1)
fused_res2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out, int H, int W) {
  using G = Tile<TY, TX>;
  // Convs of several chunks per n-block hold one item per warp.
  static_assert(items_tc<2>((TY + 4) * (TX + 4)) <= kWarps, "level 1 items");
  static_assert(items_tc<2>((TY + 2) * (TX + 2)) <= kWarps, "level 2 items");
  static_assert(items_tc<1>(TY * TX) <= kWarps, "tile items");
  constexpr int E = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Bf = X + G::kX;
  bf16* Hb = Bf + G::kB;
  bf16* ring = Hb + G::kH;
  const int64_t img = blockIdx.z;
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int gy0 = ty0 - 3, gx0 = tx0 - 3;  // image cell of level 0's (0, 0)

  // The first weight chunks in flight, then the input tile with its 3-cell
  // halo; zeros outside the image.
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) fetch_chunk(ring, w, i);
  for (int i = threadIdx.x; i < G::L0 * (64 / E); i += kThreads) {
    const int pos = i / (64 / E), ch = (i % (64 / E)) * E;
    const int gy = gy0 + pos / G::W0, gx = gx0 + pos % G::W0;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = __ldg(reinterpret_cast<const uint4*>(x + ((img * H + gy) * W + gx) * 64 + ch));
    }
    *reinterpret_cast<uint4*>(X + swz<bf16>(pos, ch, 64)) = v;
  }

  const OpTC none{nullptr, 0, 0, 0, 0, 0};
  const float* b0 = bias;
  const float* b1 = bias + kBiasBlock;
  const float* b2 = bias + 2 * kBiasBlock;
  int c = 0;
  // Block 0.
  conv_tc<kReluMasked, 2>(OpTC{X, 64, G::W0, 0, 0, 1}, none, TY + 6, G::W0, 64, b0,
                          Target<bf16>{Hb, G::W0, 0, 0, gy0, gx0}, H, W, ring, w, c);
  conv_tc<kRelu, 2>(OpTC{Hb, 64, G::W0, 0, 0, 3}, none, TY + 4, G::W1, 64, b0 + 64,
                    Target<bf16>{Bf, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W, ring, w, c);
  conv_tc<kRelu, 2>(OpTC{Bf, 64, G::W1, 0, 0, 1}, OpTC{X, 64, G::W0, 1, 1, 1}, TY + 4, G::W1,
                    256, b0 + 128, Target<bf16>{Hb, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W, ring, w,
                    c);
  // Block 1: h1 overwrites h0 cell by cell (each cell reads its own h0).
  conv_tc<kReluMasked, 2>(OpTC{Hb, 256, G::W1, 0, 0, 1}, none, TY + 4, G::W1, 64, b1,
                          Target<bf16>{X, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W, ring, w, c);
  conv_tc<kRelu, 2>(OpTC{X, 64, G::W1, 0, 0, 3}, none, TY + 2, G::W2, 64, b1 + 64,
                    Target<bf16>{Bf, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  conv_tc<kResidual, 2>(OpTC{Bf, 64, G::W2, 0, 0, 1}, none, TY + 2, G::W2, 256, b1 + 128,
                        Target<bf16>{Hb, G::W1, 1, 1, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  // Block 2.
  conv_tc<kReluMasked, 2>(OpTC{Hb, 256, G::W1, 1, 1, 1}, none, TY + 2, G::W2, 64, b2,
                          Target<bf16>{X, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  conv_tc<kRelu, 1>(OpTC{X, 64, G::W2, 0, 0, 3}, none, TY, TX, 64, b2 + 64,
                    Target<bf16>{Bf, TX, 0, 0, ty0, tx0}, H, W, ring, w, c);
  conv_tc<kResidual, 1>(OpTC{Bf, 64, TX, 0, 0, 1}, none, TY, TX, 256, b2 + 128,
                        Target<bf16>{Hb, G::W1, 2, 2, ty0, tx0}, H, W, ring, w, c);
  __syncthreads();

  // The tile's h2, from level 1's cells (r + 2, c + 2), to the output.
  for (int i = threadIdx.x; i < TY * TX * (256 / E); i += kThreads) {
    const int pos = i / (256 / E), ch = (i % (256 / E)) * E;
    const int r = pos / TX, cc = pos % TX;
    if (ty0 + r < H && tx0 + cc < W) {
      *reinterpret_cast<uint4*>(out + ((img * H + ty0 + r) * W + tx0 + cc) * 256 + ch) =
          *reinterpret_cast<const uint4*>(Hb + swz<bf16>((r + 2) * G::W1 + cc + 2, ch, 256));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 tensor cores, weights staged in shared memory
// ---------------------------------------------------------------------------

// The tile: 8 x 6 outputs, picked by measurement against 4 x 8, 5 x 8 and
// 6 x 8 at full width (PERF.md, section 6): its 192 KB of f32 activations
// leave room for a ring of two weight chunks in the 227 KB a block can have.
constexpr int kTY = 8, kTX = 6;
using TileF = Tile<kTY, kTX>;
constexpr int kChunkF = 64 * 32 * 2;            // floats: 64 x 32, head and tail
constexpr int kChunksF = 104;                   // the nine convs' chunks
constexpr int kRingF = 2;                       // chunks in shared memory
constexpr int kSmemF = 4 * (TileF::kElems + kRingF * kChunkF);
static_assert(kSmemF <= 232448, "more shared memory than a block can have");
// 12 warps: every level's warp items fit (at most 12), and a thread may
// then hold 168 registers; 16 warps' 128 spilled (96 bytes of stores) and
// ran 7% slower at full width.
constexpr int kThreadsF = 384, kWarpsF = kThreadsF / 32;

// Element index of channel ch of position pos in an f32 buffer of C
// channels: 16-byte pieces XOR-swizzled by the position's low three bits
// reversed, so that four consecutive positions put a piece pair each on
// distinct banks (the A fragments' and the epilogue's 8-byte accesses).
__device__ __forceinline__ int swz_f32(int pos, int ch, int C) {
  const int f = ((pos & 1) << 2) | (pos & 2) | ((pos >> 2) & 1);
  return pos * C + ((((ch >> 2) ^ f)) << 2) + (ch & 3);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), in two integer ops: ptxas expands the cvt into a
// longer sequence.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as a TF32 head and the TF32 head of the remainder (the wrapper's
// split_tf32), in f32 registers.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Chunk i (if any) into ring slot i % kRingF: 64 rows of 16 pieces, each
// piece XOR-swizzled by bit 2 with the row's parity (two rows a load phase);
// one commit group either way.
__device__ __forceinline__ void fetch_chunk_f32(float* ring, const float* w, int i) {
  if (i < kChunksF) {
#pragma unroll
    for (int u = threadIdx.x; u < kChunkF / 4; u += kThreadsF) {
      const int row = u >> 4, v = u & 15;
      cp_async16(ring + (i % kRingF) * kChunkF + row * 64 + ((v ^ ((row & 1) << 2)) << 2),
                 w + static_cast<int64_t>(i) * kChunkF + 4 * u);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ const float* next_chunk_f32(float* ring, const float* w, int& c) {
  cp_async_wait<kRingF - 2>();
  __syncthreads();
  fetch_chunk_f32(ring, w, c + kRingF - 1);
  return ring + (c++ % kRingF) * kChunkF;
}

// Warp items: one m-tile x NT n-tiles of a 64-channel n-block, so that a
// warp splits each A fragment once for NT n-tiles; each warp holds one
// item's accumulators across the n-block's chunks (at most 16 items). NT of
// each level, measured at full width (PERF.md, section 6, PR 16 run 10):
constexpr int kNtL0 = 8;  // 11 m-tiles: 11 items (an A split serves 8 n-tiles)
constexpr int kNtL1 = 8;  // 8 m-tiles: 8 items; 2 m-tiles x 4 n-tiles ran the same
constexpr int kNtL2 = 4;  // 5 m-tiles: 10 items; 8 n-tiles (5 items) ran ~7% slower
constexpr int kNtT = 2;   // 3 m-tiles: 12 items; 4 n-tiles (6 items) ran the same

// One operand of an f32 conv (its weights come from the chunks): output
// position (r, c) reads input position (r + oy + dy, c + ox + dx) of `in`
// (a grid of width wi, cin channels) for the taps 0 <= dy, dx < taps.
struct OpF {
  const float* in;
  int cin, wi, oy, ox, taps;
  __device__ int chunks() const { return taps * taps * cin / 32; }
};

// The epilogue of a warp item: m-tile mt, the output channels ch0 + 8 j +
// {2t, 2t + 1}.
template <Epilogue EPI, int NT>
__device__ __forceinline__ void epilogue_f32(const float (&acc)[NT][4], int mt, int ch0,
                                             int m_total, int wo, int n,
                                             const float* __restrict__ bias,
                                             const Target<float> out, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + g + 8 * h;
    if (m >= m_total) continue;
    const int r = m / wo, c = m % wo;
    const int pos = (r + out.py) * out.wb + c + out.px;
    const int gy = out.gy + r, gx = out.gx + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ch = ch0 + 8 * j + 2 * t;
      float v0 = acc[j][2 * h] + bias[ch];
      float v1 = acc[j][2 * h + 1] + bias[ch + 1];
      float2* dst = reinterpret_cast<float2*>(out.buf + swz_f32(pos, ch, n));
      if constexpr (EPI == kResidual) {
        const float2 prev = *dst;
        v0 = fmaxf(v0 + prev.x, 0.0f);
        v1 = fmaxf(v1 + prev.y, 0.0f);
      } else {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
        if (EPI == kReluMasked && !inside) v0 = v1 = 0.0f;
      }
      *dst = make_float2(v0, v1);
    }
  }
}

// One f32 conv over an ho x wo grid with n output channels: per n-block of
// 64, op0's chunks then (if op1.in) op1's, each a 32-input slice of one tap,
// each k-step summed on the tensor cores as lo(a) hi(w) + hi(a) lo(w) +
// hi(a) hi(w) and added to the f32 sum; plus bias, then the epilogue. Warp
// items of NT n-tiles; c counts the weight chunks consumed so far.
//
// Fragments: mma m16n8k8 takes A (row g / g + 8, k t / t + 4) and B (k t /
// t + 4, n g); a k-step of 8 input channels maps k t to channel 2t and
// k t + 4 to channel 2t + 1, so a lane reads its two A values of a row as
// one 8-byte load and its head and tail of both B values as one 16-byte
// load (the packing in ops/cuda/fused_stem_kernel.py::pack_res2_weights_tf32).
template <Epilogue EPI, int NT>
__device__ __forceinline__ void conv_f32(const OpF op0, const OpF op1, int ho, int wo, int n,
                                         const float* __restrict__ bias, const Target<float> out,
                                         int H, int W, float* ring, const float* w, int& c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_total = ho * wo;
  const int mtiles = (m_total + 15) / 16;
  const bool active = warp < mtiles * (8 / NT);
  const int mt = warp % mtiles, n0 = (warp / mtiles) * 8 * NT;
  const int nk0 = op0.chunks();
  const int nk = nk0 + (op1.in != nullptr ? op1.chunks() : 0);
  // This lane's A rows g and g + 8 of the m-tile, as grid cells.
  int rr[2], cc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(mt * 16 + g + 8 * h, m_total - 1);
    rr[h] = m / wo;
    cc[h] = m % wo;
  }
  // This lane's B piece of k-step ks in row 8 j + g of its n-tiles:
  // piece 4 ks + t, swizzled by the row's parity.
  const int bofs = (n0 + g) * 64 + 4 * t, bpar = g & 1;

  for (int nb = 0; nb < n / 64; ++nb) {
    float acc[NT][4], d[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
      const float* sb = next_chunk_f32(ring, w, c);
      if (!active) continue;
      // This chunk's operand, field by field (a reference to either
      // operand would put both on the stack).
      const bool first = kc < nk0;
      const float* in = first ? op0.in : op1.in;
      const int cin = first ? op0.cin : op1.cin, wi = first ? op0.wi : op1.wi;
      const int oy = first ? op0.oy : op1.oy, ox = first ? op0.ox : op1.ox;
      const int kk = first ? kc : kc - nk0;
      const int per_tap = cin >> 5;
      const int tap = kk / per_tap, ch_in = 32 * (kk % per_tap);
      const bool taps3 = (first ? op0.taps : op1.taps) == 3;
      const int dy = taps3 ? tap / 3 : 0, dx = taps3 ? tap % 3 : 0;
      // Row bases: the cell's channel ch_in + 2 (t & 1), and the swizzle
      // term of its piece (t >> 1) ^ f(pos) (swz_f32: a k-step's piece is
      // 2 ks above it, below the 8-piece swizzle span).
      int aoff[2], aswz[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = (rr[h] + oy + dy) * wi + cc[h] + ox + dx;
        aoff[h] = pos * cin + ch_in + 2 * (t & 1);
        aswz[h] = (t >> 1) ^ (((pos & 1) << 2) | (pos & 2) | ((pos >> 2) & 1));
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4];
        const float2 r0 = *reinterpret_cast<const float2*>(in + aoff[0] +
                                                           ((aswz[0] ^ (2 * ks)) << 2));
        const float2 r1 = *reinterpret_cast<const float2*>(in + aoff[1] +
                                                           ((aswz[1] ^ (2 * ks)) << 2));
        split_tf32(r0.x, ah[0], al[0]);
        split_tf32(r1.x, ah[1], al[1]);
        split_tf32(r0.y, ah[2], al[2]);
        split_tf32(r1.y, ah[3], al[3]);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(sb + bofs + 8 * j * 64 +
                                                            16 * (ks ^ bpar));
          bh[j][0] = __float_as_uint(b.x);
          bh[j][1] = __float_as_uint(b.y);
          bl[j][0] = __float_as_uint(b.z);
          bl[j][1] = __float_as_uint(b.w);
        }
        // The three products in passes over the item's n-tiles, so that
        // consecutive mma are independent.
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (ks == 0)
            mma_tf32_zero(d[j], al, bh[j][0], bh[j][1]);
          else
            mma_tf32(d[j], al, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
      }
      // The chunk's partial joins the conv's sum.
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] += d[j][k];
    }
    if (active)
      epilogue_f32<EPI, NT>(acc, mt, 64 * nb + n0, m_total, wo, n, bias, out, H, W);
  }
}

__global__ void __launch_bounds__(kThreadsF, 1)
fused_res2_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, int H, int W) {
  using G = TileF;
  constexpr int TY = kTY, TX = kTX;
  static_assert((G::L0 + 15) / 16 * (8 / kNtL0) <= kWarpsF &&
                    (G::L1 + 15) / 16 * (8 / kNtL1) <= kWarpsF &&
                    ((TY + 2) * (TX + 2) + 15) / 16 * (8 / kNtL2) <= kWarpsF &&
                    (TY * TX + 15) / 16 * (8 / kNtT) <= kWarpsF,
                "a level has more warp items than warps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  float* Bf = X + G::kX;
  float* Hb = Bf + G::kB;
  float* ring = Hb + G::kH;
  const int64_t img = blockIdx.z;
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int gy0 = ty0 - 3, gx0 = tx0 - 3;  // image cell of level 0's (0, 0)

  // The first weight chunks in flight, then the input tile with its 3-cell
  // halo; zeros outside the image.
#pragma unroll
  for (int i = 0; i < kRingF - 1; ++i) fetch_chunk_f32(ring, w, i);
  for (int i = threadIdx.x; i < G::L0 * 16; i += kThreadsF) {
    const int pos = i >> 4, ch = (i & 15) * 4;
    const int gy = gy0 + pos / G::W0, gx = gx0 + pos % G::W0;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = __ldg(reinterpret_cast<const float4*>(x + ((img * H + gy) * W + gx) * 64 + ch));
    }
    *reinterpret_cast<float4*>(X + swz_f32(pos, ch, 64)) = v;
  }

  const OpF none{nullptr, 0, 0, 0, 0, 0};
  const float* b0 = bias;
  const float* b1 = bias + kBiasBlock;
  const float* b2 = bias + 2 * kBiasBlock;
  int c = 0;
  // Block 0.
  conv_f32<kReluMasked, kNtL0>(OpF{X, 64, G::W0, 0, 0, 1}, none, TY + 6, G::W0, 64, b0,
                               Target<float>{Hb, G::W0, 0, 0, gy0, gx0}, H, W, ring, w, c);
  conv_f32<kRelu, kNtL1>(OpF{Hb, 64, G::W0, 0, 0, 3}, none, TY + 4, G::W1, 64, b0 + 64,
                         Target<float>{Bf, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W, ring, w, c);
  conv_f32<kRelu, kNtL1>(OpF{Bf, 64, G::W1, 0, 0, 1}, OpF{X, 64, G::W0, 1, 1, 1}, TY + 4,
                         G::W1, 256, b0 + 128, Target<float>{Hb, G::W1, 0, 0, gy0 + 1, gx0 + 1},
                         H, W, ring, w, c);
  // Block 1: h1 overwrites h0 cell by cell (each cell reads its own h0).
  conv_f32<kReluMasked, kNtL1>(OpF{Hb, 256, G::W1, 0, 0, 1}, none, TY + 4, G::W1, 64, b1,
                               Target<float>{X, G::W1, 0, 0, gy0 + 1, gx0 + 1}, H, W, ring, w, c);
  conv_f32<kRelu, kNtL2>(OpF{X, 64, G::W1, 0, 0, 3}, none, TY + 2, G::W2, 64, b1 + 64,
                         Target<float>{Bf, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  conv_f32<kResidual, kNtL2>(OpF{Bf, 64, G::W2, 0, 0, 1}, none, TY + 2, G::W2, 256, b1 + 128,
                             Target<float>{Hb, G::W1, 1, 1, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  // Block 2.
  conv_f32<kReluMasked, kNtL2>(OpF{Hb, 256, G::W1, 1, 1, 1}, none, TY + 2, G::W2, 64, b2,
                               Target<float>{X, G::W2, 0, 0, gy0 + 2, gx0 + 2}, H, W, ring, w, c);
  conv_f32<kRelu, kNtT>(OpF{X, 64, G::W2, 0, 0, 3}, none, TY, TX, 64, b2 + 64,
                        Target<float>{Bf, TX, 0, 0, ty0, tx0}, H, W, ring, w, c);
  conv_f32<kResidual, kNtT>(OpF{Bf, 64, TX, 0, 0, 1}, none, TY, TX, 256, b2 + 128,
                            Target<float>{Hb, G::W1, 2, 2, ty0, tx0}, H, W, ring, w, c);
  __syncthreads();

  // The tile's h2, from level 1's cells (r + 2, c + 2), to the output.
  for (int i = threadIdx.x; i < TY * TX * 64; i += kThreadsF) {
    const int pos = i >> 6, ch = (i & 63) * 4;
    const int r = pos / TX, cc = pos % TX;
    if (ty0 + r < H && tx0 + cc < W) {
      *reinterpret_cast<float4*>(out + ((img * H + ty0 + r) * W + tx0 + cc) * 256 + ch) =
          *reinterpret_cast<const float4*>(Hb + swz_f32((r + 2) * G::W1 + cc + 2, ch, 256));
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int ty, int tx, const void* x, const void* w,
           const void* bias, void* out, int B, int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + tx - 1) / tx, (H + ty - 1) / ty, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          static_cast<const float*>(bias), static_cast<T*>(out),
                                          H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, 64), out: (B, H, W, 256), both NHWC in the activation dtype
// (dtype 1 = bf16, 0 = f32), 16-byte aligned; w: the 212,992 packed folded
// bf16 weights, or for f32 the 104 chunks of 4,096 floats (heads and
// tails), 16-byte aligned; bias: the 1,152 packed f32 biases. Launches on
// `stream` and returns cudaGetLastError() (or the attribute call's error).
extern "C" int fused_res2_launch(const void* x, const void* w, const void* bias, void* out, int B,
                                 int H, int W, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<bf16>(fused_res2_tc_kernel<8, 16>, kThreads,
                        sizeof(bf16) * (Tile<8, 16>::kElems + kRing * kChunkElems), 8, 16, x, w,
                        bias, out, B, H, W, s);
  }
  return launch<float>(fused_res2_f32_kernel, kThreadsF, kSmemF, kTY, kTX, x, w, bias, out, B, H,
                       W, s);
}
