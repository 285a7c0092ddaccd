// Native host-side geometry and mask ops of the data and evaluation
// pipelines (the port's copy of detectron_tpu/native/host_ops.cpp;
// reference: lib/utils/cython_nms.pyx, cython_bbox.pyx and the pycocotools
// C mask runtime): greedy NMS, pairwise IoU, COCO run-length mask encode
// and decode, polygon rasterization (COCO's 5x-upsampled scanline scheme)
// and the RLE intersection behind mask IoU. A plain C ABI, bound with
// ctypes by detectron_tpu_torch/native/__init__.py, which builds this file
// with g++ at its first call.
//
// Every function gives the bits of its numpy twin (`*_plain` in
// data/rle.py and utils/boxes.py). NMS differs from the JAX package's copy
// in two ways, both to hold those bits (cython_nms's):
// - the caller passes the visiting order (numpy's
//   `scores.argsort()[::-1]`), where the JAX copy stable-sorts, which
//   keeps the other box of two with equal scores;
// - the IoU is computed in the dets' own type (nms_f32 / nms_f64), where
//   the JAX copy computes float32 dets' IoU in double, which moves an IoU
//   that lands near the threshold to its other side.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -ffp-contract=off host_ops.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Greedy NMS over dets (n, 5) [x1, y1, x2, y2, score] visited in `order`;
// every operation in T, in numpy's order. iou > thresh suppresses, the
// comparison in float when cmp_single (numpy compares a float32 IoU with a
// Python float in float32) and in double otherwise.
template <typename T>
int nms_impl(const T* dets, const int64_t* order, int n, double thresh,
             int cmp_single, int* keep) {
  std::vector<T> areas(n);
  for (int i = 0; i < n; ++i) {
    const T* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + T(1)) * (d[3] - d[1] + T(1));
  }
  const float thresh_single = static_cast<float>(thresh);
  std::vector<char> suppressed(n, 0);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep[n_keep++] = static_cast<int>(i);
    const T* di = dets + i * 5;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      const T* dj = dets + j * 5;
      T xx1 = std::max(di[0], dj[0]);
      T yy1 = std::max(di[1], dj[1]);
      T xx2 = std::min(di[2], dj[2]);
      T yy2 = std::min(di[3], dj[3]);
      T w = std::max(T(0), xx2 - xx1 + T(1));
      T h = std::max(T(0), yy2 - yy1 + T(1));
      T inter = w * h;
      T ovr = inter / (areas[i] + areas[j] - inter);
      bool over = cmp_single ? static_cast<float>(ovr) > thresh_single
                             : static_cast<double>(ovr) > thresh;
      if (over) suppressed[j] = 1;
    }
  }
  return n_keep;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Greedy NMS. dets: (n, 5); order: the visiting order (score-descending);
// keep (out): kept indices in that order. Returns the number kept.
// ---------------------------------------------------------------------------
int nms_f32(const float* dets, const int64_t* order, int n, double thresh,
            int cmp_single, int* keep) {
  return nms_impl<float>(dets, order, n, thresh, cmp_single, keep);
}

int nms_f64(const double* dets, const int64_t* order, int n, double thresh,
            int cmp_single, int* keep) {
  return nms_impl<double>(dets, order, n, thresh, cmp_single, keep);
}

// ---------------------------------------------------------------------------
// Pairwise IoU with the Detectron +1 edge convention. out: (n, k) doubles.
// ---------------------------------------------------------------------------
void bbox_overlaps(const double* boxes, int n, const double* query, int k,
                   double* out) {
  for (int j = 0; j < k; ++j) {
    const double* q = query + j * 4;
    double qa = (q[2] - q[0] + 1) * (q[3] - q[1] + 1);
    for (int i = 0; i < n; ++i) {
      const double* b = boxes + i * 4;
      double iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1;
      double out_v = 0.0;
      if (iw > 0) {
        double ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1;
        if (ih > 0) {
          double ba = (b[2] - b[0] + 1) * (b[3] - b[1] + 1);
          double ua = ba + qa - iw * ih;
          out_v = iw * ih / ua;
        }
      }
      out[i * k + j] = out_v;
    }
  }
}

// ---------------------------------------------------------------------------
// RLE decode: counts -> column-major binary mask of hw bytes. Returns 0, or
// -1 where the counts do not sum to hw.
// ---------------------------------------------------------------------------
int rle_decode(const uint32_t* counts, int m, uint8_t* mask, int64_t hw) {
  int64_t p = 0;
  uint8_t v = 0;
  for (int i = 0; i < m; ++i) {
    int64_t c = counts[i];
    if (p + c > hw) return -1;
    std::memset(mask + p, v, c);
    p += c;
    v = 1 - v;
  }
  return p == hw ? 0 : -1;
}

// RLE encode: column-major mask bytes (any nonzero byte is 1) -> counts
// (caller buffer >= hw + 1). Returns the count length m. A run is scanned
// 8 bytes at a time where it can be: a word of zeros continues a 0-run, a
// word with no zero byte a 1-run.
int rle_encode(const uint8_t* mask, int64_t hw, uint32_t* counts) {
  const uint64_t kOnes = 0x0101010101010101ULL;
  const uint64_t kHighs = 0x8080808080808080ULL;
  int m = 0;
  int cur = 0;
  int64_t start = 0, i = 0;
  while (i < hw) {
    uint64_t word;
    if (cur == 0) {
      while (i + 8 <= hw && (std::memcpy(&word, mask + i, 8), word == 0))
        i += 8;
    } else {
      while (i + 8 <= hw && (std::memcpy(&word, mask + i, 8),
                             ((word - kOnes) & ~word & kHighs) == 0))
        i += 8;
    }
    while (i < hw && (mask[i] != 0) == (cur != 0)) ++i;
    if (i < hw) {
      counts[m++] = static_cast<uint32_t>(i - start);
      start = i;
      cur ^= 1;
    }
  }
  counts[m++] = static_cast<uint32_t>(hw - start);
  return m;
}

// ---------------------------------------------------------------------------
// Polygon -> RLE counts (COCO scheme: 5x upsample, boundary trace,
// downsample, parity fill). counts buffer must hold >= h*w + 2 entries.
// Returns the count length m.
// ---------------------------------------------------------------------------
int poly_to_counts(const double* xy, int k, int h, int w, uint32_t* counts) {
  const double scale = 5.0;
  std::vector<int64_t> x(k + 1), y(k + 1);
  for (int j = 0; j < k; ++j) {
    x[j] = (int64_t)std::floor(scale * xy[2 * j] + 0.5);
    y[j] = (int64_t)std::floor(scale * xy[2 * j + 1] + 0.5);
  }
  x[k] = x[0];
  y[k] = y[0];

  // Trace integer boundary points along each edge.
  std::vector<int64_t> u, v;
  for (int j = 0; j < k; ++j) {
    int64_t xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    int64_t dx = std::llabs(xe - xs);
    int64_t dy = std::llabs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    if (dx >= dy) {
      double s = dx > 0 ? (double)(ye - ys) / dx : 0.0;
      for (int64_t d = 0; d <= dx; ++d) {
        int64_t t = flip ? xe - d : xs + d;
        u.push_back(t);
        v.push_back((int64_t)std::floor(ys + s * (t - xs) + 0.5));
      }
    } else {
      double s = dy > 0 ? (double)(xe - xs) / dy : 0.0;
      for (int64_t d = 0; d <= dy; ++d) {
        int64_t t = flip ? ye - d : ys + d;
        v.push_back(t);
        u.push_back((int64_t)std::floor(xs + s * (t - ys) + 0.5));
      }
    }
  }

  // Downsample to pixel-granularity vertical-boundary crossings.
  std::vector<int64_t> a;
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] != u[j - 1]) {
      double xd = (double)std::min(u[j], u[j - 1]);
      xd = (xd + 0.5) / scale - 0.5;
      if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
      double yd = (double)std::min(v[j], v[j - 1]);
      yd = (yd + 0.5) / scale - 0.5;
      if (yd < 0) yd = 0;
      else if (yd > h) yd = h;
      yd = std::ceil(yd);
      a.push_back((int64_t)xd * h + (int64_t)yd);
    }
  }
  a.push_back((int64_t)h * w);
  std::sort(a.begin(), a.end());

  // Differences, then merge zero runs (double crossings cancel).
  int64_t prev = 0;
  for (size_t j = 0; j < a.size(); ++j) {
    int64_t t = a[j];
    a[j] -= prev;
    prev = t;
  }
  int m = 0;
  counts[m++] = (uint32_t)a[0];
  size_t j = 1;
  while (j < a.size()) {
    if (a[j] > 0) {
      counts[m++] = (uint32_t)a[j++];
    } else {
      ++j;
      if (j < a.size()) {
        counts[m - 1] += (uint32_t)a[j++];
      }
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// RLE-vs-RLE intersection area (counts co-iteration, no decode).
// ---------------------------------------------------------------------------
int64_t rle_intersection(const uint32_t* ca, int ma, const uint32_t* cb,
                         int mb) {
  int64_t inter = 0;
  int ia = 0, ib = 0;
  int64_t ra = ia < ma ? ca[ia] : 0;  // remaining in current a-run
  int64_t rb = ib < mb ? cb[ib] : 0;
  uint8_t va = 0, vb = 0;
  while (ia < ma && ib < mb) {
    int64_t step = std::min(ra, rb);
    if (va && vb) inter += step;
    ra -= step;
    rb -= step;
    if (ra == 0) {
      ++ia;
      va = 1 - va;
      if (ia < ma) ra = ca[ia];
    }
    if (rb == 0) {
      ++ib;
      vb = 1 - vb;
      if (ib < mb) rb = cb[ib];
    }
  }
  return inter;
}

}  // extern "C"
