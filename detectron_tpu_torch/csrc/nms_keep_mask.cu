// Batched greedy NMS keep mask, for sm_90a.
//
// Replaces detectron_tpu/ops/pallas/nms_kernel.py::nms_keep_mask (its
// kernel body _kernel, nms_kernel.py:26-87). L independent lanes, each of
// N boxes in descending score order: a valid box is kept unless a kept,
// earlier box of its lane overlaps it with IoU > thr (Detectron's +1 rule).
// Invalid boxes never pivot and never survive; each lane stops at its last
// valid index, so invalid holes mid-lane are safe. N has no cap of its own.
//
// What bounds it on the card: the greedy recurrence is serial in the pivot,
// and its latency, not bytes or operations, sets the time. A barrier per
// pivot would chain up to N barriers on L CTAs (2 CTAs on 132 SMs for an
// RPN level), so the serial part runs in one warp without barriers.
//
// Design: two kernels in one call, through an (L, N, nw) 64-bit scratch
// mask that the caller allocates, nw = ceil(N / 64) words per row.
//  1. nms_iou_mask_kernel, all the IoUs in parallel: one 64-thread CTA per
//     (lane, 64-row block, 64-column block), column block >= row block, on
//     grid (L, nw, nw) (grid.y and grid.z reach 65,535 blocks: N up to 4.2
//     M boxes). The column block's boxes and areas sit in shared memory;
//     thread r of the CTA writes one word for row i: bit k set iff
//     j = 64 * block + k > i, j is valid and IoU(i, j) > thr. A CTA whose
//     row block or column block holds no valid box returns at once, and so
//     does an invalid row: the scan uses only the rows of alive pivots, and
//     a stale word of a column block with no valid box can only mark boxes
//     that are never kept.
//  2. The scan, the serial part without barriers, in one of two kernels.
//     Short lanes (N <= 2048, nw <= 32), nms_scan_kernel: one warp per lane
//     holds the lane's "removed" mask in registers, one word per thread.
//     Block k's slab of mask rows (64 rows, words k..) is copied into
//     shared memory with cp.async two blocks ahead of its use (three slabs,
//     at most 48 KB), so no pivot waits on a global load. The owner of word
//     k resolves the block's 64 pivots alone, from the 64 diagonal words
//     held in registers, in an unrolled chain of a bit test and a masked
//     AND per pivot; the block's alive pivots are broadcast with
//     __shfl_sync, and every later word ORs in their rows (independent
//     loads, in any order: OR is order-free). The lane's valid bytes are
//     loaded all at once before the ballots that pack them.
//     Long lanes (nw > 32), nms_scan_long_kernel: the removed mask and the
//     valid words live in shared memory (16 bytes per word: 3 KB at N =
//     12000), and the blocks go in groups of 32. Warp 0 scans a group
//     exactly as the short kernel scans a lane, with the group's 32 words
//     in registers (thread t owns word k0 + t) and slabs of the group's
//     words only (64 rows x 32 words, 16 KB; three in flight, 48 KB for any
//     N). The words past the group wait for the group's end: then all 32
//     warps OR the rows of the group's alive pivots into them, a thread per
//     (word, eighth of the group's blocks), reading its column of those
//     rows (a warp reads 256 contiguous bytes of a row) with unconditional
//     loads, 16 in flight, and merging with a shared atomicOr; no barrier
//     inside the group. What bounds a long lane: the scan's chain per
//     block as for short lanes, plus the flush's reads, the rows' words
//     past their group (~N nw / 2 words, from L2). The
//     shared memory, 48 KB + 16 nw bytes, caps nw at 11,392 words (N <=
//     729,088), where one lane's (N, nw) scratch takes 66 GB.
//     keep = valid & ~removed.
//
// The IoU is computed in f32 exactly as the Pallas kernel writes it, with
// round-to-nearest intrinsics so that no multiply-add is contracted: the
// keep mask matches the plain PyTorch version bit for bit. A pair with no
// intersection skips the divide: its IoU is 0, -0 or NaN, never > thr >= 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;      // boxes per row / column block (one word)
constexpr int kMaxWords = 32;   // short lanes: 2048 boxes, a word a thread
constexpr int kStages = 3;      // mask slabs in flight in the scan
constexpr int kLongWarps = 32;  // long lanes: the scan warp and 31 helpers
constexpr int kFlushWords = 128;  // words a flush pass covers
// Long lanes' shared memory: the slabs, then removed and valid words.
constexpr int kLongSlabBytes =
    kStages * kBlock * kMaxWords * static_cast<int>(sizeof(unsigned long long));

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__device__ __forceinline__ float4 load_box(const float* b, size_t k) {
  return make_float4(b[4 * k], b[4 * k + 1], b[4 * k + 2], b[4 * k + 3]);
}

__global__ void __launch_bounds__(kBlock)
nms_iou_mask_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    unsigned long long* __restrict__ mask, int n, int nw,
                    float thr) {
  const int lane = blockIdx.x;
  const int rb = blockIdx.y;
  const int cb = blockIdx.z;
  if (cb < rb) return;
  __shared__ float4 sbox[kBlock];
  __shared__ float sarea[kBlock];
  __shared__ unsigned col_half[2];

  const int t = threadIdx.x;
  const int i = rb * kBlock + t;
  const int j = cb * kBlock + t;
  const float* lb = boxes + static_cast<size_t>(lane) * n * 4;
  const uint8_t* lv = valid + static_cast<size_t>(lane) * n;
  const bool vi = i < n && lv[i] != 0;
  const bool vj = j < n && lv[j] != 0;
  if (vj) {
    const float4 o = load_box(lb, j);
    sbox[t] = o;
    sarea[t] = box_area(o.x, o.y, o.z, o.w);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, vj);
  if ((t & 31) == 0) col_half[t >> 5] = ballot;
  const int any_row = __syncthreads_or(vi);
  const unsigned long long cols =
      (static_cast<unsigned long long>(col_half[1]) << 32) | col_half[0];
  if (!any_row || cols == 0 || !vi) return;

  const float4 b = load_box(lb, i);
  const float barea = box_area(b.x, b.y, b.z, b.w);
  unsigned long long word = 0;
  // On the diagonal only the columns after i.
  unsigned long long todo = cb == rb ? cols & (~0ull << t << 1) : cols;
  while (todo) {
    const int k = __ffsll(static_cast<long long>(todo)) - 1;
    todo &= todo - 1;
    const float4 o = sbox[k];
    const float iw = fmaxf(
        __fadd_rn(__fsub_rn(fminf(o.z, b.z), fmaxf(o.x, b.x)), 1.0f), 0.0f);
    const float ih = fmaxf(
        __fadd_rn(__fsub_rn(fminf(o.w, b.w), fmaxf(o.y, b.y)), 1.0f), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    if (inter > 0.0f || thr < 0.0f) {
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(sarea[k], barea), inter));
      if (iou > thr) word |= 1ull << k;
    }
  }
  mask[(static_cast<size_t>(lane) * n + i) * nw + cb] = word;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v,
                                                     int src) {
  const unsigned lo = __shfl_sync(0xffffffffu, static_cast<unsigned>(v), src);
  const unsigned hi =
      __shfl_sync(0xffffffffu, static_cast<unsigned>(v >> 32), src);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int n, int nw) {
  // kStages slabs of 64 mask rows x nw words.
  extern __shared__ unsigned long long slab[];
  __shared__ unsigned long long kept[kMaxWords];

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* lv = valid + static_cast<size_t>(lane) * n;
  const unsigned long long* lm = mask + static_cast<size_t>(lane) * n * nw;

  // Thread t's valid word, and the lane's last valid index: every load
  // issued before the first ballot.
  bool v[2 * kMaxWords];
#pragma unroll
  for (int m = 0; m < 2 * kMaxWords; ++m) {
    const int j = 32 * m + t;
    v[m] = j < n && lv[j] != 0;
  }
  unsigned long long vword = 0;
  int last = -1;
#pragma unroll
  for (int m = 0; m < 2 * kMaxWords; ++m) {
    const unsigned bits = __ballot_sync(0xffffffffu, v[m]);
    if (t == m / 2)
      vword |= static_cast<unsigned long long>(bits) << (32 * (m % 2));
    if (bits) last = 32 * m + 31 - __clz(bits);
  }
  const int nblk = last < 0 ? 0 : last / kBlock + 1;
  const int slab_words = kBlock * nw;

  // Block k's rows up to the last valid one, words k.. of each, into slab
  // k % kStages; one commit group per block (empty past the last block).
  // Each thread copies, and later reads, only its own word column, so no
  // copy waits on another thread.
  auto fetch = [&](int k) {
    if (k < nblk && t >= k && t < nw) {
      const int row_end = min(kBlock * k + kBlock, last + 1);
      unsigned long long* dst = slab + (k % kStages) * slab_words + t;
      for (int i = kBlock * k; i < row_end; ++i)
        cp_async8(dst + (i - kBlock * k) * nw,
                  lm + static_cast<size_t>(i) * nw + t);
    }
    cp_async_commit();
  };

  unsigned long long removed = 0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  for (int k = 0; k < nblk; ++k) {
    fetch(k + kStages - 1);
    cp_async_wait<kStages - 1>();
    const unsigned long long* s = slab + (k % kStages) * slab_words;
    unsigned long long alive = 0;
    if (t == k) {
      // The block's 64 pivots in order, in registers: pivot ii is alive iff
      // its bit survives every earlier alive pivot of the lane, and then
      // it clears the later bits its diagonal word holds. Rows that are
      // not alive are never used (their words may be stale).
      unsigned long long d[kBlock];
#pragma unroll
      for (int ii = 0; ii < kBlock; ++ii) d[ii] = s[ii * nw + k];
      alive = vword & ~removed;
#pragma unroll
      for (int ii = 0; ii < kBlock; ++ii)
        if ((alive >> ii) & 1) alive &= ~d[ii];
      removed = vword & ~alive;
    }
    alive = shfl64(alive, k);
    if (t > k && t < nw) {
      unsigned long long r = removed;
#pragma unroll
      for (int ii = 0; ii < kBlock; ++ii)
        if ((alive >> ii) & 1) r |= s[ii * nw + t];
      removed = r;
    }
  }

  if (t < nw) kept[t] = vword & ~removed;
  __syncwarp();
  uint8_t* lk = keep + static_cast<size_t>(lane) * n;
  for (int j = t; j < n; j += 32)
    lk[j] = static_cast<uint8_t>((kept[j / kBlock] >> (j % kBlock)) & 1);
}

// Long lanes (nw > kMaxWords): see the source note. One CTA of kLongWarps
// warps per lane; warp 0 scans each group of 32 blocks, then all warps
// carry the group's alive rows into the words past it.
__global__ void __launch_bounds__(32 * kLongWarps)
nms_scan_long_kernel(const unsigned long long* __restrict__ mask,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int n, int nw) {
  constexpr int kThreads = 32 * kLongWarps;
  constexpr int kSlabWords = kBlock * kMaxWords;
  constexpr int kSlices = kThreads / kFlushWords;
  extern __shared__ unsigned long long smem[];
  unsigned long long* slab = smem;                       // kStages slabs
  unsigned long long* removed = slab + kStages * kSlabWords;  // nw words
  unsigned long long* vwords = removed + nw;                  // nw words
  __shared__ unsigned long long alive_blk[kMaxWords];    // the group's
  __shared__ int s_last;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* lv = valid + static_cast<size_t>(lane) * n;
  const unsigned long long* lm = mask + static_cast<size_t>(lane) * n * nw;

  // The valid words, 32 boxes per ballot (a warp loads 8 pieces before
  // it ballots them), and the last valid index.
  if (tid == 0) s_last = -1;
  for (int j = tid; j < nw; j += kThreads) removed[j] = 0;
  __syncthreads();
  unsigned* vhalf = reinterpret_cast<unsigned*>(vwords);
  int my_last = -1;
  for (int base = 8 * warp; base < 2 * nw; base += 8 * kLongWarps) {
    bool v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = 32 * (base + m) + t;
      v[m] = j < n && lv[j] != 0;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const unsigned bits = __ballot_sync(0xffffffffu, v[m]);
      if (base + m < 2 * nw) {
        if (t == 0) vhalf[base + m] = bits;
        if (bits) my_last = 32 * (base + m) + 31 - __clz(bits);
      }
    }
  }
  if (t == 0 && my_last >= 0) atomicMax(&s_last, my_last);
  __syncthreads();
  const int last = s_last;
  const int nblk = last < 0 ? 0 : last / kBlock + 1;

  // Block k's rows up to the last valid one, the words of k's group from k
  // on (thread t: word k0 + t), into slab k % kStages; one commit group per
  // block (empty past the last block). Only warp 0 copies and reads slabs.
  auto fetch = [&](int k) {
    const int w = (k & ~(kMaxWords - 1)) + t;
    if (k < nblk && w >= k && w < nw) {
      const int row_end = min(kBlock * k + kBlock, last + 1);
      unsigned long long* dst = slab + (k % kStages) * kSlabWords + t;
      for (int i = kBlock * k; i < row_end; ++i)
        cp_async8(dst + (i - kBlock * k) * kMaxWords,
                  lm + static_cast<size_t>(i) * nw + w);
    }
    cp_async_commit();
  };

  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) fetch(k);
  }
  for (int k0 = 0; k0 < nblk; k0 += kMaxWords) {
    const int kend = min(k0 + kMaxWords, nblk);
    if (warp == 0) {
      const int w = k0 + t;
      unsigned long long removed_w = w < nw ? removed[w] : 0;
      const unsigned long long vword = w < nw ? vwords[w] : 0;
      for (int k = k0; k < kend; ++k) {
        fetch(k + kStages - 1);
        cp_async_wait<kStages - 1>();
        const unsigned long long* s = slab + (k % kStages) * kSlabWords;
        const int kt = k - k0;
        unsigned long long alive = 0;
        if (t == kt) {
          unsigned long long d[kBlock];
#pragma unroll
          for (int ii = 0; ii < kBlock; ++ii) d[ii] = s[ii * kMaxWords + kt];
          alive = vword & ~removed_w;
#pragma unroll
          for (int ii = 0; ii < kBlock; ++ii)
            if ((alive >> ii) & 1) alive &= ~d[ii];
          removed_w = vword & ~alive;
        }
        alive = shfl64(alive, kt);
        if (t > kt && w < nw) {
          unsigned long long r = removed_w;
#pragma unroll
          for (int ii = 0; ii < kBlock; ++ii)
            if ((alive >> ii) & 1) r |= s[ii * kMaxWords + t];
          removed_w = r;
        }
        if (t == 0) alive_blk[kt] = alive;
      }
      if (w < nw) removed[w] = removed_w;
    }
    __syncthreads();
    // The words past the group take the rows of its alive pivots: thread
    // (slice, word j) ORs in the rows of blocks k0 + slice, k0 + slice +
    // kSlices, ... up to each block's last alive pivot, loading every row
    // (unconditional loads pipeline; the alive bits pick the ones kept).
    for (int j0 = k0 + kMaxWords; j0 < nblk; j0 += kFlushWords) {
      const int j = j0 + tid % kFlushWords;
      if (j < nblk) {
        unsigned long long r = 0;
        for (int kb = tid / kFlushWords; kb < kend - k0; kb += kSlices) {
          const unsigned long long a = alive_blk[kb];
          if (a == 0) continue;
          const int rows = kBlock - __clzll(static_cast<long long>(a));
          const unsigned long long* col =
              lm + static_cast<size_t>(kBlock) * (k0 + kb) * nw + j;
#pragma unroll 16
          for (int ii = 0; ii < rows; ++ii) {
            const unsigned long long v = col[static_cast<size_t>(ii) * nw];
            r |= (a >> ii) & 1 ? v : 0ull;
          }
        }
        if (r) atomicOr(&removed[j], r);
      }
    }
    __syncthreads();
  }

  uint8_t* lk = keep + static_cast<size_t>(lane) * n;
  for (int j = tid; j < n; j += kThreads) {
    const int w = j / kBlock;
    lk[j] = static_cast<uint8_t>(((vwords[w] & ~removed[w]) >> (j % kBlock)) & 1);
  }
}

}  // namespace

// boxes: (L, N, 4) f32; valid, keep: (L, N) bytes (torch.bool); mask:
// (L, N, ceil(N / 64)) 64-bit scratch. Launches the IoU kernel and the
// scan for N's lane length on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue where a long lane's words exceed the shared memory
// a block can have).
extern "C" int nms_keep_mask_launch(const void* boxes, const void* valid,
                                    void* keep, void* mask, int lanes, int n,
                                    float thr, void* stream) {
  if (lanes > 0 && n > 0) {
    const int nw = (n + kBlock - 1) / kBlock;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* m = static_cast<const unsigned long long*>(mask);
    if (nw > kMaxWords) {
      // Check the shared memory before launching anything.
      int dev = 0, optin = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      const size_t smem = kLongSlabBytes +
          2 * static_cast<size_t>(nw) * sizeof(unsigned long long);
      if (smem + 1024 > static_cast<size_t>(optin))
        return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t e = cudaFuncSetAttribute(
          nms_scan_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    nms_iou_mask_kernel<<<dim3(lanes, nw, nw), kBlock, 0, s>>>(
        static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
        static_cast<unsigned long long*>(mask), n, nw, thr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nw > kMaxWords) {
      const size_t smem = kLongSlabBytes +
          2 * static_cast<size_t>(nw) * sizeof(unsigned long long);
      nms_scan_long_kernel<<<lanes, 32 * kLongWarps, smem, s>>>(
          m, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
          n, nw);
      return static_cast<int>(cudaGetLastError());
    }
    // Above 48 KB of shared memory only after opting in, once, for the
    // largest short lane (32 words).
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kStages * kBlock * kMaxWords *
                         sizeof(unsigned long long)));
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    const size_t smem =
        static_cast<size_t>(kStages) * kBlock * nw * sizeof(unsigned long long);
    nms_scan_kernel<<<lanes, 32, smem, s>>>(
        m, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
        nw);
  }
  return static_cast<int>(cudaGetLastError());
}
