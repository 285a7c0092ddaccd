// Windowed RoIAlign backward (window accumulate) without float atomics, for
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
// with (b, y0, x0) = starts[n], everything in f32. Every canvas cell gets
// its terms in an order fixed by the inputs alone, so two calls on the same
// inputs give the same bits.
//
// What bounds it on the card: bytes, as K4: the f32 read-modify-write of
// the reached canvas cells and the ct read. Without atomics each cell needs
// one owner that adds its RoIs in order; a grid over every canvas tile that
// scans every RoI (the first design) spent its time on tiles nothing
// reaches, ran one CTA an SM, and walked the hundreds of RoIs of a hot tile
// (the C4 map) one after another.
//
// Design: a pre-pass builds, on the device and without a host sync, the
// list of RoI rows of every (image, 8 x 16 canvas tile); the accumulate then
// works only where a list has rows, in chunks of 32 rows.
//  - reach: one warp per RoI row. For each window row (column) inside the
//    canvas, the first and last pooled row p (column q) with a nonzero
//    weight (pr, qr); the bands of tile rows (columns) that some reached
//    window row (column) falls in, as a bit mask from the band of the
//    window's origin; and, with integer atomics that only count, the
//    number of rows in each tile the row reaches.
//  - scan: one CTA. Exclusive scans of the tile counts (list offsets) and
//    of their chunk counts ceil(count / 32), and the tile of every chunk.
//  - fill: one warp per tile with rows. It walks the reach masks of all
//    rows, 32 at a time, and writes the rows that reach its tile in row
//    order (a ballot and a prefix count), each with the range of pooled
//    rows and columns that reach the tile and the tile rows and columns it
//    reaches.
//  - accumulate: a persistent grid of 256-thread CTAs, two an SM, takes
//    work items (chunk, channel tile) in increasing order from an integer
//    counter, one ahead, and starts the next item's copies before this
//    one's read-modify-write. Warp r owns tile row r, a lane kV channels
//    (CT = 32 kV: 128 for P <= 8, 64 for P <= 16). Per listed RoI the CTA
//    copies, with cp.async and double buffered so that the next RoI's
//    copy runs under this one's FMAs, vy over the tile's rows and vx over
//    its columns for the pooled ranges that reach it, and the ct rows
//    (p, q) of those ranges for the channel tile into shared memory: the
//    8 warps share one read of ct, and a RoI spanning k tiles reads each
//    (p, q) once per tile that needs it. One barrier a RoI. Each warp then
//    sums, for each q, t = sum_p vy[p, h] ct[p, q] over the p that reach
//    its row (2 or 4 q at a time, independent chains), and adds vx[q, w] t
//    into its 16 cells' registers.
//  - A tile with one chunk adds its sums into canvas_grad directly. The
//    chunks of a longer list add theirs in chunk order: chunk j waits
//    (after its own sums) until a per-(tile, channel tile) ticket reads j,
//    adds, and sets it to j + 1 (the in-order serial reduction of a
//    split-K GEMM). Items are taken in increasing order, so chunk j - 1 is
//    always held by a running CTA: the wait ends. The short chunk of a
//    list comes first, so a full chunk never waits for a shorter one that
//    started after it. The hot tiles of the C4 map so compute in parallel
//    and only their read-modify-writes follow one another; no float
//    scratch holds partial sums.
//  - Only the cells some RoI of the chunk reaches are read and written.
// Terms left out have zero weight, so for finite inputs the sums are the
// dense ones up to the order of the f32 adds, as in K4.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTH = 8;         // tile rows: one per warp
constexpr int kTW = 16;        // tile columns
constexpr int kWarps = kTH;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;     // rows of a tile's list per work item
constexpr int kMaxWin = 128;
constexpr int kHeader = 4;     // chunks, entries, work counter, unused

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The scratch of one call, in int32 units from its start. The header,
// counts and tickets come first: one memset clears them.
struct Layout {
  int tiles_y, tiles_x, tiles, ct_tile, n_ct, pairs, chunks, rstride;
  long long counts, tickets, reach, pr, qr, offsets, chunk_info, entries,
      total;
};

Layout layout(int B, int Hc, int Wc, int C, int rows, int WY, int WX,
              int P) {
  Layout L;
  L.tiles_y = (Hc + kTH - 1) / kTH;
  L.tiles_x = (Wc + kTW - 1) / kTW;
  L.tiles = B * L.tiles_y * L.tiles_x;
  L.ct_tile = P <= 8 ? 128 : 64;
  L.n_ct = (C + L.ct_tile - 1) / L.ct_tile;
  // A window of WY rows meets at most ceil(WY / kTH) + 1 bands of tile
  // rows (WX columns: ceil(WX / kTW) + 1 bands of tile columns).
  const long long per_row =
      static_cast<long long>(std::min(L.tiles_y, (WY + kTH - 1) / kTH + 1)) *
      std::min(L.tiles_x, (WX + kTW - 1) / kTW + 1);
  L.pairs = static_cast<int>(rows * per_row);
  L.chunks = std::min(L.tiles, L.pairs) + (L.pairs + kChunk - 1) / kChunk;
  L.rstride = round4(rows);
  long long o = kHeader;   // every offset a multiple of 4: 16-byte aligned
  L.counts = o;     o += round4(L.tiles);
  L.tickets = o;    o += round4(L.tiles * L.n_ct);
  L.reach = o;      o += 5LL * L.rstride;
  L.pr = o;         o += round4((rows * WY + 1) / 2);
  L.qr = o;         o += round4((rows * WX + 1) / 2);
  L.offsets = o;    o += round4(L.tiles);
  L.chunk_info = o; o += 4LL * L.chunks;
  L.entries = o;    o += 4LL * L.pairs;
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// Pre-pass
// ---------------------------------------------------------------------------

// First and last p < P with w[p * stride] != 0, packed as first | last <<
// 8 (first > last: none); the P loads are issued together.
__device__ __forceinline__ uint16_t nonzero_range(const float* w, int P,
                                                  int stride) {
  float v[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) v[p] = p < P ? w[p * stride] : 0.0f;
  int lo = 255, hi = 0;
#pragma unroll
  for (int p = 15; p >= 0; --p)
    if (v[p] != 0.0f) {
      lo = p;
      hi = max(hi, p);
    }
  return static_cast<uint16_t>(lo | hi << 8);
}

// One warp per RoI row: pr / qr, the reach masks and the tile counts. The
// reach of row i is five int32 arrays of rstride (structure of arrays):
// image (-1: reaches nothing), first band of tile rows, mask of bands,
// first band of tile columns, mask of bands.
__global__ void __launch_bounds__(kThreads)
roi_reach_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ reach,
                 uint16_t* __restrict__ pr, uint16_t* __restrict__ qr,
                 const int32_t* __restrict__ starts,
                 const float* __restrict__ vy, const float* __restrict__ vx,
                 int B, int Hc, int Wc, int row_lo, int rows, int rstride,
                 int WY, int WX, int P, int tiles_y, int tiles_x) {
  const int i = blockIdx.x * kWarps + threadIdx.y;
  if (i >= rows) return;   // uniform over the warp
  const int lane = threadIdx.x;
  const size_t n = static_cast<size_t>(row_lo) + i;
  const int b = starts[3 * n];
  const int y0 = starts[3 * n + 1];
  const int x0 = starts[3 * n + 2];
  const bool valid = b >= 0 && b < B && y0 >= 0 && x0 >= 0;
  const int h_end = valid ? min(WY, Hc - y0) : 0;
  const int w_end = valid ? min(WX, Wc - x0) : 0;
  const int by0 = valid ? y0 / kTH : 0;
  const int bx0 = valid ? x0 / kTW : 0;
  const float* vyn = vy + n * P * WY;
  const float* vxn = vx + n * P * WX;
  unsigned my = 0, mx = 0;
  for (int k = lane; k < WY; k += 32) {
    const uint16_t r = k < h_end ? nonzero_range(vyn + k, P, WY) : 0x00ff;
    pr[static_cast<size_t>(i) * WY + k] = r;
    if ((r & 255) <= (r >> 8)) my |= 1u << ((y0 + k) / kTH - by0);
  }
  for (int k = lane; k < WX; k += 32) {
    const uint16_t r = k < w_end ? nonzero_range(vxn + k, P, WX) : 0x00ff;
    qr[static_cast<size_t>(i) * WX + k] = r;
    if ((r & 255) <= (r >> 8)) mx |= 1u << ((x0 + k) / kTW - bx0);
  }
  my = __reduce_or_sync(0xffffffffu, my);
  mx = __reduce_or_sync(0xffffffffu, mx);
  const bool hit = my != 0 && mx != 0;
  if (lane == 0) {
    reach[i] = hit ? b : -1;
    reach[rstride + i] = by0;
    reach[2 * rstride + i] = static_cast<int32_t>(my);
    reach[3 * rstride + i] = bx0;
    reach[4 * rstride + i] = static_cast<int32_t>(mx);
  }
  if (!hit) return;
  // Bands span at most 17 bits (a window of 128 rows from any offset in
  // its first band); a lane per band of tile columns, a loop over rows.
  for (unsigned m = my; m; m &= m - 1) {
    const int ty = by0 + __ffs(m) - 1;
    if (mx >> lane & 1u)
      atomicAdd(counts + (static_cast<size_t>(b) * tiles_y + ty) * tiles_x +
                    bx0 + lane, 1);
  }
}

// One CTA of 1024 threads: the list offsets, and each work item's chunk
// (tile, first entry, rows, j | chunks of the tile << 16). A list of c
// rows splits into a first chunk of c - 32 (n - 1) rows and n - 1 chunks
// of 32 that follow it, so that no chunk waits (tickets, below) for a
// shorter one taken after it.
__global__ void __launch_bounds__(1024)
roi_tile_scan_kernel(int32_t* __restrict__ header,
                     const int32_t* __restrict__ counts,
                     int32_t* __restrict__ offsets,
                     int4* __restrict__ chunk_info, int tiles,
                     int max_chunks) {
  __shared__ int warp_e[32], warp_c[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (tiles + 1023) / 1024;
  const int t0 = min(tiles, tid * per), t1 = min(tiles, t0 + per);
  int se = 0, sc = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = counts[t];
    se += c;
    sc += (c + kChunk - 1) / kChunk;
  }
  int ie = se, ic = sc;   // inclusive scans over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ie, d);
    const int c = __shfl_up_sync(0xffffffffu, ic, d);
    if (lane >= d) {
      ie += a;
      ic += c;
    }
  }
  if (lane == 31) {
    warp_e[warp] = ie;
    warp_c[warp] = ic;
  }
  __syncthreads();
  if (warp == 0) {
    int a = warp_e[lane], c = warp_c[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int a2 = __shfl_up_sync(0xffffffffu, a, d);
      const int c2 = __shfl_up_sync(0xffffffffu, c, d);
      if (lane >= d) {
        a += a2;
        c += c2;
      }
    }
    warp_e[lane] = a;
    warp_c[lane] = c;
  }
  __syncthreads();
  int be = ie - se + (warp ? warp_e[warp - 1] : 0);
  int bc = ic - sc + (warp ? warp_c[warp - 1] : 0);
  for (int t = t0; t < t1; ++t) {
    const int c = counts[t];
    const int nch = (c + kChunk - 1) / kChunk;
    offsets[t] = be;
    const int first = c - kChunk * (nch - 1);
    for (int j = 0; j < nch && bc + j < max_chunks; ++j)
      chunk_info[bc + j] = make_int4(
          t, be + (j ? first + kChunk * (j - 1) : 0), j ? kChunk : first,
          j | nch << 16);
    be += c;
    bc += nch;
  }
  if (tid == 1023) {
    header[0] = min(bc, max_chunks);
    header[1] = be;
  }
}

__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// One CTA per tile with rows: its list, in row order. Warp w takes a slice
// of the rows, a lane 4 rows at a time (16-byte loads of the reach
// arrays); the warps count their hits, then write them after the slices
// before theirs (a prefix count). Entry: (row n, p0 | p1 << 8 | q0 << 16 |
// q1 << 24, column mask | row mask << 16, y0 | x0 << 16): the pooled rows
// [p0, p1] and columns [q0, q1] that reach the tile, the tile's columns
// and rows the RoI reaches, and its window origin.
__global__ void __launch_bounds__(kThreads)
roi_tile_fill_kernel(int4* __restrict__ entries,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ reach,
                     const uint16_t* __restrict__ pr,
                     const uint16_t* __restrict__ qr,
                     const int32_t* __restrict__ starts, int row_lo, int rows,
                     int rstride, int WY, int WX, int tiles_y, int tiles_x) {
  __shared__ int warp_hits[kWarps];
  const int t = blockIdx.x;
  if (counts[t] == 0) return;   // uniform over the CTA
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = t / (tiles_y * tiles_x);
  const int ty = t / tiles_x % tiles_y;
  const int tx = t % tiles_x;
  const int slice = (rows + kWarps * 128 - 1) / (kWarps * 128) * 128;
  const int r0 = warp * slice, r1 = min(rows, r0 + slice);

  // The hits among rows i .. i + 3 (i a multiple of 4), as 4 bits.
  auto hits = [&](int i) {
    if (i >= r1) return 0u;
    const int4 rb = ld4(reach + i), by = ld4(reach + rstride + i);
    const int4 my = ld4(reach + 2 * rstride + i);
    const int4 bx = ld4(reach + 3 * rstride + i);
    const int4 mx = ld4(reach + 4 * rstride + i);
    const int rbv[4] = {rb.x, rb.y, rb.z, rb.w};
    const int byv[4] = {by.x, by.y, by.z, by.w};
    const int myv[4] = {my.x, my.y, my.z, my.w};
    const int bxv[4] = {bx.x, bx.y, bx.z, bx.w};
    const int mxv[4] = {mx.x, mx.y, mx.z, mx.w};
    unsigned h = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dy = ty - byv[k], dx = tx - bxv[k];
      h |= static_cast<unsigned>(
               i + k < r1 && rbv[k] == b && dy >= 0 && dy < 32 &&
               (static_cast<unsigned>(myv[k]) >> dy & 1u) && dx >= 0 &&
               dx < 32 && (static_cast<unsigned>(mxv[k]) >> dx & 1u))
           << k;
    }
    return h;
  };

  int mine = 0;
  for (int i0 = r0; i0 < r1; i0 += 128) mine += __popc(hits(i0 + 4 * lane));
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) warp_hits[warp] = mine;
  __syncthreads();
  int pos = offsets[t];
  for (int w = 0; w < warp; ++w) pos += warp_hits[w];
  for (int i0 = r0; i0 < r1; i0 += 128) {
    const int i = i0 + 4 * lane;
    unsigned h = hits(i);
    const int nh = __popc(h);
    int before = nh;   // inclusive scan of the lanes' hits
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, before, d);
      if (lane >= d) before += v;
    }
    int4* out = entries + pos + before - nh;
    pos += __shfl_sync(0xffffffffu, before, 31);
    for (; h; h &= h - 1) {
      const int k = __ffs(h) - 1;
      const size_t n = static_cast<size_t>(row_lo) + i + k;
      const int y0 = starts[3 * n + 1];
      const int x0 = starts[3 * n + 2];
      const uint16_t* prn = pr + static_cast<size_t>(i + k) * WY;
      const uint16_t* qrn = qr + static_cast<size_t>(i + k) * WX;
      int p0 = 255, p1 = 0, q0 = 255, q1 = 0;
      unsigned hm = 0, wm = 0;
#pragma unroll
      for (int r = 0; r < kTH; ++r) {
        const int kk = ty * kTH + r - y0;
        const int v = kk >= 0 && kk < WY ? prn[kk] : 0x00ff;
        if ((v & 255) <= (v >> 8)) {
          p0 = min(p0, v & 255);
          p1 = max(p1, v >> 8);
          hm |= 1u << r;
        }
      }
#pragma unroll
      for (int w = 0; w < kTW; ++w) {
        const int kk = tx * kTW + w - x0;
        const int v = kk >= 0 && kk < WX ? qrn[kk] : 0x00ff;
        if ((v & 255) <= (v >> 8)) {
          q0 = min(q0, v & 255);
          q1 = max(q1, v >> 8);
          wm |= 1u << w;
        }
      }
      *out++ = make_int4(static_cast<int>(n),
                         p0 | p1 << 8 | q0 << 16 | q1 << 24,
                         static_cast<int>(wm | hm << 16), y0 | x0 << 16);
    }
  }
}

// ---------------------------------------------------------------------------
// Accumulate
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Shared floats of one pipeline stage: ct rows (P P CT), vy (P kTH), vx
// (P kTW), each from a 16-byte boundary.
__host__ __device__ inline int stage_floats(int P, int ct_tile) {
  return round4(P * P * ct_tile) + round4(P * kTH) + round4(P * kTW);
}

template <int kV>
__device__ __forceinline__ void load_vec(float (&x)[kV], const float* s) {
  if constexpr (kV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(s);
    x[0] = v.x; x[1] = v.y;
  }
}

struct Args {
  float* canvas;
  const float* ct;
  const float* vy;
  const float* vx;
  int32_t* header;
  int32_t* tickets;
  const int4* chunk_info;
  const int4* entries;
  int Hc, Wc, C, WY, WX, P, tiles_y, tiles_x, n_ct, vec;
};

// Copies RoI entry e's vy / vx over the tile and its ct rows of the
// channel tile into the stage at s (all threads take part).
template <int kV>
__device__ __forceinline__ void stage_roi(const Args& a, float* s,
                                          const int4& e, int ty0, int tx0,
                                          int c0) {
  constexpr int kCT = 32 * kV;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const size_t n = static_cast<size_t>(e.x);
  const int p0 = e.y & 255, p1 = e.y >> 8 & 255;
  const int q0 = e.y >> 16 & 255, q1 = e.y >> 24 & 255;
  const int np = p1 - p0 + 1, nq = q1 - q0 + 1;
  const int y0 = e.w & 0xffff, x0 = static_cast<unsigned>(e.w) >> 16;
  const int P = a.P;
  float* sct = s;
  float* svy = s + round4(P * P * kCT);
  float* svx = svy + round4(P * kTH);
  const float* vyn = a.vy + (n * P + p0) * a.WY;
  const float* vxn = a.vx + (n * P + q0) * a.WX;
  for (int k = tid; k < np * kTH + nq * kTW; k += kThreads) {
    if (k < np * kTH) {
      const int r = k % kTH, h = ty0 + r - y0;
      const bool in = h >= 0 && h < a.WY && ty0 + r < a.Hc;
      cp_async4(svy + k, in ? vyn + (k / kTH) * a.WY + h : a.vy, in);
    } else {
      const int k2 = k - np * kTH;
      const int r = k2 % kTW, w = tx0 + r - x0;
      const bool in = w >= 0 && w < a.WX && tx0 + r < a.Wc;
      cp_async4(svx + k2, in ? vxn + (k2 / kTW) * a.WX + w : a.vx, in);
    }
  }
  // The ct rows (p, q): a warp (a half warp for 64 channels) copies one
  // (p, q) a step, a lane 16 bytes (4 bytes a lane per channel when the
  // rows are not 16-byte aligned); (p, q) advance without a division.
  const float* ctn = a.ct + ((n * P + p0) * P + q0) * a.C + c0;
  const int lane = threadIdx.x, warp = threadIdx.y;
  constexpr int kPieces = kCT / 4;
  constexpr int kPairs = 32 / kPieces;   // (p, q) a warp a step
  const int per_warp = a.vec ? kPairs : 1;
  const int step = kWarps * per_warp;
  int pq = warp * per_warp + (a.vec ? lane / kPieces : 0);
  int p = 0, q = pq;
  while (q >= nq) {
    q -= nq;
    ++p;
  }
  for (; pq < np * nq; pq += step) {
    const float* src = ctn + (static_cast<size_t>(p) * P + q) * a.C;
    if (a.vec) {
      const int c = lane % kPieces * 4;
      const bool in = c0 + c < a.C;
      cp_async16(sct + pq * kCT + c, in ? src + c : a.ct, in);
    } else {
      for (int c = lane; c < kCT; c += 32) {
        const bool in = c0 + c < a.C;
        cp_async4(sct + pq * kCT + c, in ? src + c : a.ct, in);
      }
    }
    for (q += step; q >= nq; ++p) q -= nq;
  }
}

// A work item's tile and channel tile.
struct Item {
  int t, b, ty0, tx0, c0, cti;
};

__device__ __forceinline__ Item decode(const Args& a, int item,
                                       const int4& info, int ct_tile) {
  Item it;
  it.cti = item % a.n_ct;
  it.t = info.x;
  it.b = info.x / (a.tiles_y * a.tiles_x);
  it.ty0 = info.x / a.tiles_x % a.tiles_y * kTH;
  it.tx0 = info.x % a.tiles_x * kTW;
  it.c0 = it.cti * ct_tile;
  return it;
}

// The first copies of a work item: its list entries into list_s and its
// first RoI into stage 0.
template <int kV>
__device__ __forceinline__ void stage_item(const Args& a, float* smem,
                                           int4* list_s, int item,
                                           const int4& info) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const Item it = decode(a, item, info, 32 * kV);
  const int4* list = a.entries + info.y;
  if (tid < info.z)
    cp_async16(reinterpret_cast<float*>(list_s + tid),
               reinterpret_cast<const float*>(list + tid), true);
  stage_roi<kV>(a, smem, list[0], it.ty0, it.tx0, it.c0);
  cp_async_commit();
}

template <int kV>
__global__ void __launch_bounds__(kThreads, 2)
roi_window_accum_det_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int item_s;
  __shared__ int4 info_s;
  __shared__ int4 list_s[kChunk];   // the work item's list entries
  constexpr int kCT = 32 * kV;
  constexpr int kQU = kV == 4 ? 2 : 4;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int stage = stage_floats(a.P, kCT);
  const int items = a.header[0] * a.n_ct;

  // Work items are taken in increasing order from the counter; thread 0
  // takes the next one while the CTA works on this one, and the CTA
  // starts its copies before this one's read-modify-write.
  if (tid == 0) {
    const int x = atomicAdd(a.header + 2, 1);
    item_s = x;
    if (x < items) info_s = a.chunk_info[x / a.n_ct];
  }
  __syncthreads();
  int item = item_s;
  int4 info = info_s;
  if (item >= items) return;
  stage_item<kV>(a, smem, list_s, item, info);
  for (;;) {
    const Item it = decode(a, item, info, kCT);
    const int m = info.z;
    const int j = info.w & 0xffff, n_chunks = info.w >> 16;

    float acc[kTW][kV];
#pragma unroll
    for (int w = 0; w < kTW; ++w)
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[w][v] = 0.0f;
    unsigned cols = 0;   // this warp's reached columns (uniform)

    for (int r = 0; r < m; ++r) {
      cp_async_wait_all();
      __syncthreads();   // RoI r staged; stage (r + 1) & 1 no longer read
      if (r + 1 < m)
        stage_roi<kV>(a, smem + ((r + 1) & 1) * stage, list_s[r + 1],
                      it.ty0, it.tx0, it.c0);
      if (r == 0 && tid == 0) {
        const int x = atomicAdd(a.header + 2, 1);
        item_s = x;
        if (x < items)
          cp_async16(reinterpret_cast<float*>(&info_s),
                     reinterpret_cast<const float*>(a.chunk_info +
                                                    x / a.n_ct),
                     true);
      }
      cp_async_commit();
      const int4 e = list_s[r];
      if (!(e.z >> (16 + warp) & 1)) continue;   // row not reached
      cols |= static_cast<unsigned>(e.z) & 0xffffu;
      const float* s = smem + (r & 1) * stage;
      const float* sct = s;
      const float* svy = s + round4(a.P * a.P * kCT);
      const float* svx = svy + round4(a.P * kTH);
      const int p0 = e.y & 255, np = (e.y >> 8 & 255) - p0 + 1;
      const int nq = (e.y >> 24 & 255) - (e.y >> 16 & 255) + 1;
      // This row's weight for pooled row p0 + lane, and the p that reach it.
      const float wy = lane < np ? svy[lane * kTH + warp] : 0.0f;
      const unsigned pm = __ballot_sync(0xffffffffu, wy != 0.0f);
      // kQU pooled columns q at a time: their sums over p are independent
      // chains, so their shared loads and FMAs interleave.
      const float* sl = sct + lane * kV;
      for (int qi = 0; qi < nq; qi += kQU) {
        float tq[kQU][kV];
#pragma unroll
        for (int u = 0; u < kQU; ++u)
#pragma unroll
          for (int v = 0; v < kV; ++v) tq[u][v] = 0.0f;
        for (unsigned mm = pm; mm; mm &= mm - 1) {
          const int pi = __ffs(mm) - 1;
          const float w = __shfl_sync(0xffffffffu, wy, pi);
          const float* row = sl + (pi * nq + qi) * kCT;
#pragma unroll
          for (int u = 0; u < kQU; ++u) {
            if (qi + u < nq) {
              float x[kV];
              load_vec<kV>(x, row + u * kCT);
#pragma unroll
              for (int v = 0; v < kV; ++v) tq[u][v] = fmaf(w, x[v], tq[u][v]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kQU; ++u) {
          if (qi + u >= nq) break;
          const float4* vq =
              reinterpret_cast<const float4*>(svx + (qi + u) * kTW);
#pragma unroll
          for (int w4 = 0; w4 < kTW / 4; ++w4) {
            const float4 f = vq[w4];
            const float fw[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int v = 0; v < kV; ++v)
                acc[4 * w4 + k][v] =
                    fmaf(fw[k], tq[u][v], acc[4 * w4 + k][v]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // every RoI summed; the next item is known
    const int next = item_s;
    const int4 next_info = info_s;
    if (next < items) stage_item<kV>(a, smem, list_s, next, next_info);

    // Add the chunk's sums into its reached cells; the chunks of a split
    // list in chunk order.
    int32_t* ticket = a.tickets + static_cast<size_t>(it.t) * a.n_ct + it.cti;
    if (n_chunks > 1) {
      if (tid == 0) {
        long long spins = 0;
        while (ld_acquire(ticket) != j) {
          __nanosleep(64);
          if (++spins > (1LL << 26)) __trap();   // never: fail, not hang
        }
      }
      __syncthreads();
    }
    const int hc = it.ty0 + warp;
    const int c = it.c0 + lane * kV;
    if (cols && hc < a.Hc && c < a.C) {
      float* row = a.canvas + ((static_cast<size_t>(it.b) * a.Hc + hc) *
                                   a.Wc + it.tx0) * a.C + c;
#pragma unroll
      for (int w = 0; w < kTW; ++w) {
        if (!(cols >> w & 1)) continue;
        float* cell = row + static_cast<size_t>(w) * a.C;
        if (a.vec) {
          if constexpr (kV == 4) {
            float4 v4 = __ldcg(reinterpret_cast<const float4*>(cell));
            v4.x += acc[w][0];
            v4.y += acc[w][1];
            v4.z += acc[w][2];
            v4.w += acc[w][3];
            __stcg(reinterpret_cast<float4*>(cell), v4);
          } else {
            float2 v2 = __ldcg(reinterpret_cast<const float2*>(cell));
            v2.x += acc[w][0];
            v2.y += acc[w][1];
            __stcg(reinterpret_cast<float2*>(cell), v2);
          }
        } else {
#pragma unroll
          for (int v = 0; v < kV; ++v)
            if (c + v < a.C) __stcg(cell + v, __ldcg(cell + v) + acc[w][v]);
        }
      }
    }
    if (n_chunks > 1) {
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(ticket, j + 1);
      }
    }
    item = next;
    info = next_info;
    if (item >= items) return;
  }
}

struct Bufs {
  int32_t* base;
  Layout L;
  int32_t* at(long long off) const { return base + off; }
};

// The pre-pass: clears header, counts and tickets, then reach, scan, fill.
int pre_pass(const Bufs& s, const void* starts, const void* vy,
             const void* vx, int B, int Hc, int Wc, int row_lo, int rows,
             int WY, int WX, int P, cudaStream_t st) {
  const Layout& L = s.L;
  int err = static_cast<int>(cudaMemsetAsync(
      s.base, 0, sizeof(int32_t) * static_cast<size_t>(L.reach), st));
  if (err != 0) return err;
  const dim3 warps(32, kWarps);
  roi_reach_kernel<<<(rows + kWarps - 1) / kWarps, warps, 0, st>>>(
      s.at(L.counts), s.at(L.reach), reinterpret_cast<uint16_t*>(s.at(L.pr)),
      reinterpret_cast<uint16_t*>(s.at(L.qr)),
      static_cast<const int32_t*>(starts), static_cast<const float*>(vy),
      static_cast<const float*>(vx), B, Hc, Wc, row_lo, rows, L.rstride, WY,
      WX, P, L.tiles_y, L.tiles_x);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  roi_tile_scan_kernel<<<1, 1024, 0, st>>>(
      s.base, s.at(L.counts), s.at(L.offsets),
      reinterpret_cast<int4*>(s.at(L.chunk_info)), L.tiles, L.chunks);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  roi_tile_fill_kernel<<<L.tiles, warps, 0, st>>>(
      reinterpret_cast<int4*>(s.at(L.entries)), s.at(L.counts),
      s.at(L.offsets), s.at(L.reach),
      reinterpret_cast<const uint16_t*>(s.at(L.pr)),
      reinterpret_cast<const uint16_t*>(s.at(L.qr)),
      static_cast<const int32_t*>(starts), row_lo, rows, L.rstride, WY, WX,
      L.tiles_y, L.tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int kV>
int accumulate(const Bufs& s, void* canvas, const void* ct, const void* vy,
               const void* vx, int Hc, int Wc, int C, int WY, int WX, int P,
               cudaStream_t st) {
  const Layout& L = s.L;
  const size_t smem = sizeof(float) * 2 * stage_floats(P, 32 * kV);
  const size_t smem_max =
      sizeof(float) * 2 * stage_floats(kV == 4 ? 8 : 16, 32 * kV);
  static int sms = 0;
  static bool attr = false;
  int err;
  if (!attr) {
    if ((err = static_cast<int>(cudaFuncSetAttribute(
             roi_window_accum_det_kernel<kV>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem_max)))) != 0)
      return err;
    int dev = 0;
    if ((err = static_cast<int>(cudaGetDevice(&dev))) != 0) return err;
    if ((err = static_cast<int>(cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev))) != 0)
      return err;
    attr = true;
  }
  int per_sm = 0;
  if ((err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, roi_window_accum_det_kernel<kV>, kThreads, smem))) != 0)
    return err;
  const long long most = static_cast<long long>(L.chunks) * L.n_ct;
  const int grid = static_cast<int>(
      std::max(1LL, std::min<long long>(std::max(per_sm, 1) * sms, most)));
  Args a;
  a.canvas = static_cast<float*>(canvas);
  a.ct = static_cast<const float*>(ct);
  a.vy = static_cast<const float*>(vy);
  a.vx = static_cast<const float*>(vx);
  a.header = s.base;
  a.tickets = s.at(L.tickets);
  a.chunk_info = reinterpret_cast<const int4*>(s.at(L.chunk_info));
  a.entries = reinterpret_cast<const int4*>(s.at(L.entries));
  a.Hc = Hc;
  a.Wc = Wc;
  a.C = C;
  a.WY = WY;
  a.WX = WX;
  a.P = P;
  a.tiles_y = L.tiles_y;
  a.tiles_x = L.tiles_x;
  a.n_ct = L.n_ct;
  a.vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  roi_window_accum_det_kernel<kV>
      <<<grid, dim3(32, kWarps), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int P, int WY, int WX) {
  return P > 16 || WY > kMaxWin || WX > kMaxWin;
}

}  // namespace

// The scratch layout for a call's shapes: out[0..6] = tile rows, tile
// columns, tiles_y, tiles_x, and the int32 offsets of the tile counts
// ((B, tiles_y, tiles_x)), of the list entries (int4 each, their number at
// offset 1) and of the end (the scratch's size). Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int roi_window_accum_det_layout(int B, int Hc, int Wc, int C,
                                           int rows, int WY, int WX, int P,
                                           long long* out) {
  if (bad_shape(P, WY, WX) || P <= 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(B, Hc, Wc, C, rows, WY, WX, P);
  const long long v[] = {kTH, kTW, L.tiles_y, L.tiles_x, L.counts, L.entries,
                         L.total};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

// The pre-pass alone, into scratch (roi_window_accum_det_layout's size):
// for the lists' check against their plain version.
extern "C" int roi_window_accum_det_lists(const void* starts, void* scratch,
                                          const void* vy, const void* vx,
                                          int B, int Hc, int Wc, int C,
                                          int row_lo, int row_hi, int WY,
                                          int WX, int P, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows <= 0 || B <= 0 || Hc <= 0 || Wc <= 0 || C <= 0 || P <= 0)
    return static_cast<int>(cudaGetLastError());
  if (bad_shape(P, WY, WX)) return static_cast<int>(cudaErrorInvalidValue);
  const Bufs s{static_cast<int32_t*>(scratch),
               layout(B, Hc, Wc, C, rows, WY, WX, P)};
  return pre_pass(s, starts, vy, vx, B, Hc, Wc, row_lo, rows, WY, WX, P,
                  static_cast<cudaStream_t>(stream));
}

// canvas: (B, Hc, Wc, C) f32, updated in place; starts: (N, 3) int32
// [img, y0, x0]; scratch: int32 of roi_window_accum_det_layout's size; ct:
// (N, P, P, C) f32; vy: (N, P, WY) f32; vx: (N, P, WX) f32. P <= 16, WY
// and WX <= 128. Accumulates rows [row_lo, row_hi) only, each canvas cell's
// terms in an order fixed by the inputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int roi_window_accum_det_launch(void* canvas, const void* starts,
                                           void* scratch, const void* ct,
                                           const void* vy, const void* vx,
                                           int B, int Hc, int Wc, int C,
                                           int row_lo, int row_hi, int WY,
                                           int WX, int P, void* stream) {
  const int rows = row_hi - row_lo;
  if (rows <= 0 || C <= 0 || P <= 0 || B <= 0 || Hc <= 0 || Wc <= 0)
    return static_cast<int>(cudaGetLastError());
  if (bad_shape(P, WY, WX)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bufs s{static_cast<int32_t*>(scratch),
               layout(B, Hc, Wc, C, rows, WY, WX, P)};
  int err = pre_pass(s, starts, vy, vx, B, Hc, Wc, row_lo, rows, WY, WX, P,
                     st);
  if (err != 0) return err;
  return P <= 8 ? accumulate<4>(s, canvas, ct, vy, vx, Hc, Wc, C, WY, WX, P,
                                st)
                : accumulate<2>(s, canvas, ct, vy, vx, Hc, Wc, C, WY, WX, P,
                                st);
}
