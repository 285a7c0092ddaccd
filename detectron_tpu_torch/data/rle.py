"""COCO run-length-encoding mask codec and RLE geometry (the port's copy of
the numpy code paths of detectron_tpu/data/rle.py; pycocotools.mask is not
a dependency). Formats:

- binary mask (H, W) uint8, column-major (Fortran) run-length order
- uncompressed RLE: {'size': [h, w], 'counts': [c0, c1, ...]} with c0 the
  count of leading zeros
- compressed RLE string: base-48 varint stream, 5 data bits + continuation
  bit per char, counts delta-encoded against counts[i-2] from i >= 3

Polygon rasterization follows the COCO scheme (vertices upsampled 5x,
boundary traced along integer steps, downsampled to pixel boundaries,
filled by parity of boundary-crossing positions), which gives the COCO
API's masks bit for bit. The JAX package's C++ fast path
(detectron_tpu/native/host_ops.cpp) is not ported: every function here is
the numpy algorithm, and its strings are the same bytes.
"""

import numpy as np


# ---------------------------------------------------------------------------
# mask <-> counts
# ---------------------------------------------------------------------------

def encode_counts(mask):
    """mask: (H, W) binary -> run-length counts (column-major, leading 0s)."""
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(bool)
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [n]])
    counts = np.diff(bounds).tolist()
    if flat[0]:  # counts must start with a zero-run
        counts = [0] + counts
    return counts


def decode_counts(counts, h, w):
    """Run-length counts -> (H, W) uint8 mask."""
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    assert n == h * w, "RLE does not match shape"
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F")


# ---------------------------------------------------------------------------
# counts <-> compressed string
# ---------------------------------------------------------------------------

def counts_to_string(counts):
    """COCO compressed RLE: delta + base-48 varint with 5 data bits/char."""
    s = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def string_to_counts(s):
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask):
    """(H, W) binary mask -> COCO RLE dict with compressed counts."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": counts_to_string(encode_counts(mask))}


def encode_crop(crop, x0, y0, h, w):
    """RLE-encode a binary crop pasted at (y0, x0) into an all-zero (h, w)
    image, without materializing the image: O(crop) instead of O(h*w).

    Run boundaries can only occur inside the crop's columns, at value
    flips down each column and at the crop's top/bottom edges; the flip
    positions, taken in column-major order, are the run boundaries of the
    virtual full image. Bit-identical to encode(paste(crop))."""
    crop = np.asarray(crop, bool)
    ch, cw = crop.shape
    assert 0 <= y0 and 0 <= x0 and y0 + ch <= h and x0 + cw <= w, \
        "crop must be pre-clipped to the image"
    n = h * w
    if ch == 0 or cw == 0 or not crop.any():
        return {"size": [int(h), int(w)],
                "counts": counts_to_string([n])}
    # change[t, j]: the virtual image value flips at row y0+t of column
    # x0+j (t == ch marks a 1-run ending at the crop's bottom edge).
    change = np.empty((ch + 1, cw), bool)
    change[0] = crop[0]
    np.not_equal(crop[1:], crop[:-1], out=change[1:ch])
    change[ch] = crop[-1]
    idx = np.nonzero(change.reshape(-1, order="F"))[0]
    t = idx % (ch + 1)
    j = idx // (ch + 1)
    pos = (x0 + j).astype(np.int64) * h + y0 + t
    # Full-height crops (y0 == 0, ch == h): a 1-run crossing a column
    # boundary puts a bottom-edge flip and the next column's top-edge flip
    # at the same position; the virtual value doesn't change there, and
    # the coincident pair (never a triple) must cancel.
    if y0 == 0 and ch == h:
        same = np.nonzero(pos[1:] == pos[:-1])[0]
        keep = np.ones(pos.size, bool)
        keep[same] = False
        keep[same + 1] = False
        pos = pos[keep]
    bounds = np.empty(pos.size + 2, np.int64)
    bounds[0] = 0
    bounds[1:-1] = pos
    bounds[-1] = n
    counts = np.diff(bounds).tolist()
    if len(counts) > 1 and counts[-1] == 0:
        counts.pop()  # mask touches the last pixel: no trailing zero run
    return {"size": [int(h), int(w)], "counts": counts_to_string(counts)}


def decode(rle):
    """COCO RLE dict (compressed string or raw counts) -> (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return decode_counts(counts, h, w)


# ---------------------------------------------------------------------------
# polygon -> RLE (COCO scanline scheme)
# ---------------------------------------------------------------------------

def poly_to_counts(xy, h, w):
    """One polygon [x0, y0, x1, y1, ...] -> RLE counts over an (h, w) grid,
    using the COCO 5x-upsampled boundary-trace + parity-fill algorithm."""
    scale = 5.0
    xy = np.asarray(xy, dtype=np.float64)
    k = len(xy) // 2
    x = np.floor(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.floor(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    # Trace integer boundary points along each edge.
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx = abs(int(xe - xs))
        dy = abs(int(ys - ye))
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1)
            t = (xe - d) if flip else (xs + d)
            us.append(t)
            vs.append(np.floor(ys + s * (t - xs) + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1)
            t = (ye - d) if flip else (ys + d)
            vs.append(t)
            us.append(np.floor(xs + s * (t - ys) + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # Downsample: keep vertical-boundary crossings at pixel granularity.
    xs_out, ys_out = [], []
    for j in range(1, len(u)):
        if u[j] != u[j - 1]:
            xd = float(min(u[j], u[j - 1]))
            xd = (xd + 0.5) / scale - 0.5
            if np.floor(xd) != xd or xd < 0 or xd > w - 1:
                continue
            yd = float(min(v[j], v[j - 1]))
            yd = (yd + 0.5) / scale - 0.5
            yd = min(max(yd, 0.0), float(h))
            ys_out.append(int(np.ceil(yd)))
            xs_out.append(int(xd))

    # Parity fill: sorted crossing positions (in column-major pixel index)
    # alternate inside/outside.
    a = np.array([xx * h + yy for xx, yy in zip(xs_out, ys_out)]
                 + [h * w], dtype=np.int64)
    a.sort()
    a = np.diff(np.concatenate([[0], a]))
    # Merge zero-length runs (double crossings cancel).
    counts = [int(a[0])]
    j = 1
    while j < len(a):
        if a[j] > 0:
            counts.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < len(a):
                counts[-1] += int(a[j])
                j += 1
    return counts


def polys_to_mask(polys, h, w):
    """List of polygons -> merged (union) binary mask (H, W) uint8."""
    mask = np.zeros((h, w), np.uint8)
    for p in polys:
        mask |= decode_counts(poly_to_counts(p, h, w), h, w)
    return mask


def frPyObjects(obj, h, w):
    """pycocotools-compatible conversion: polygons | uncompressed RLE ->
    compressed RLE dict(s)."""
    if isinstance(obj, dict):
        counts = obj["counts"]
        if isinstance(counts, (list, tuple)):
            return {"size": list(obj["size"]),
                    "counts": counts_to_string(counts)}
        return obj
    if isinstance(obj, (list, tuple)) and len(obj) and \
            isinstance(obj[0], (list, tuple, np.ndarray)):
        return [
            {"size": [h, w], "counts": counts_to_string(poly_to_counts(p, h, w))}
            for p in obj
        ]
    # single polygon
    return {"size": [h, w],
            "counts": counts_to_string(poly_to_counts(obj, h, w))}


def merge(rles):
    """Union of RLEs -> RLE dict."""
    if not rles:
        return {"size": [0, 0], "counts": ""}
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m |= decode(r).astype(bool)
    return encode(m.astype(np.uint8))


def area(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(np.sum(np.asarray(counts[1::2], dtype=np.int64)))


def to_bbox(rle):
    """RLE -> [x, y, w, h] bounding box (xywh, COCO convention)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4, np.float64)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)


def iou(dt_rles, gt_rles, iscrowd):
    """Pairwise mask IoU matrix (D, G). For crowd gt, the denominator is the
    detection area (pycocotools semantics)."""
    D, G = len(dt_rles), len(gt_rles)
    out = np.zeros((D, G), np.float64)
    dms = [decode(r).astype(bool) for r in dt_rles]
    gms = [decode(r).astype(bool) for r in gt_rles]
    d_areas = [int(m.sum()) for m in dms]
    g_areas = [int(m.sum()) for m in gms]
    for i, dm in enumerate(dms):
        for j, gm in enumerate(gms):
            inter = int(np.logical_and(dm, gm).sum())
            if iscrowd[j]:
                denom = d_areas[i]
            else:
                denom = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out
