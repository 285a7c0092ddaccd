"""The port's training data layer against the JAX package's, on the same
inputs:

- data/rle.py's polys_to_mask and to_bbox, and every function of
  utils/segms.py (flips of polygons, compressed and uncompressed RLEs
  included), on random polygons and masks: equal, exactly;
- on a tiny COCO-format training set written here (PPM images in both
  orientations, polygon, RLE and crowd annotations, a degenerate box, and
  a proposals pkl): combined_roidb_for_training entry by entry, with
  ratio_list / ratio_index, with the RPN on and in Fast R-CNN mode
  (precomputed proposals and the crowd filter), exactly; add_proposals
  (method and module function) likewise;
- make_minibatch from the same RandomState, key by key: boxes, classes,
  valid masks, proposals and polygon masks exactly, images within 1e-3
  (the port resizes in numpy, the JAX loader with cv2), masks resized from
  RLE crops within 1e-5;
- the first 6 TrainLoader batches against the JAX loader's, at 1 and 3
  worker threads, and start_batch=k against skipping k batches.

The set's writer (write_train_set) serves tests/test_torch_train_net.py
too.
"""

import json
import pickle

import numpy as np
import pytest

from detectron_tpu.data import json_dataset as jax_json_dataset
from detectron_tpu.data import loader as jax_loader
from detectron_tpu.data import rle as jax_rle
from detectron_tpu.data import roidb as jax_roidb
from detectron_tpu.utils import segms as jax_segms
from detectron_tpu_torch.data import json_dataset
from detectron_tpu_torch.data import loader
from detectron_tpu_torch.data import rle
from detectron_tpu_torch.data import roidb as port_roidb
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import segms
from test_torch_util import set_cfgs

SIZES = [(60, 80), (80, 60), (64, 96), (96, 64), (72, 72), (56, 100),
         (100, 56), (64, 80)]
CATS = (1, 5, 9)
PIXEL_MEANS = np.array([102.9801, 115.9465, 122.7717])

# The data keys of both cfgs: two train scales (so the scale draw counts),
# an 8-box gt pad, 28 x 28 gt masks, 16 padded proposals.
DATA_KEYS = ["TRAIN.SCALES", "(64, 80)", "TRAIN.MAX_SIZE", "128",
             "TPU.MAX_GT_BOXES", "8", "TPU.GT_MASK_SIZE", "28",
             "TPU.MAX_TRAIN_PROPOSALS", "16"]
# Fast R-CNN mode: no RPN (MODEL.FASTER_RCNN would turn it back on).
FAST_RCNN_KEYS = ["MODEL.FASTER_RCNN", "False", "RPN.RPN_ON", "False"]


def _random_polygon(rng, h, w, n=None):
    n = n or rng.randint(3, 8)
    cx, cy = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(3, min(h, w) / 3, n)
    xs = np.clip(cx + r * np.cos(ang), 0, w - 1)
    ys = np.clip(cy + r * np.sin(ang), 0, h - 1)
    return np.stack([xs, ys], 1).reshape(-1).tolist()


def _blob_mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
    m[y0:y0 + rng.randint(6, h // 2), x0:x0 + rng.randint(6, w // 2)] = 1
    m[rng.rand(h, w) > 0.97] ^= 1
    return m


def _bbox_of(mask):
    ys, xs = np.nonzero(mask)
    return [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]


def write_train_set(root, split="train2017", contrast=255.0):
    """A COCO-format set under root/coco (coco_2017_train with the default
    split): 8 PPM images (PIXEL_MEANS + N(0, contrast / 4) pixels, both
    orientations), per image 2-3 polygon objects (some of two polygons), on
    even images an RLE object and a crowd (uncompressed RLE) region, on
    image 3 a zero-area box, 3 categories with ids 1, 5, 9; and root/
    props.pkl with 24 proposals per image, in shuffled image order.
    Returns the number of annotations."""
    img_dir = root / "coco" / split
    img_dir.mkdir(parents=True, exist_ok=True)
    (root / "coco" / "annotations").mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    props = {"ids": [], "boxes": [], "scores": []}

    def add(image_id, cat, bbox, segm, crowd=0, area=None):
        anns.append({"id": len(anns) + 1, "image_id": image_id,
                     "category_id": cat, "bbox": bbox, "segmentation": segm,
                     "area": bbox[2] * bbox[3] if area is None else area,
                     "iscrowd": crowd})

    for i, (h, w) in enumerate(SIZES):
        name = "{:012d}.ppm".format(i + 1)
        im = np.clip(np.round(PIXEL_MEANS + rng.randn(h, w, 3)
                              * contrast / 4), 0, 255)
        image_io.write_ppm(str(img_dir / name), im.astype(np.uint8))
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": name})
        for k in range(2 + i % 2):
            polys = [_random_polygon(rng, h, w)
                     for _ in range(1 + (k == 1))]
            xs = np.concatenate([p[0::2] for p in polys])
            ys = np.concatenate([p[1::2] for p in polys])
            add(i + 1, CATS[(i + k) % 3],
                [float(xs.min()), float(ys.min()),
                 float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                polys)
        xy = rng.uniform(0, min(h, w) / 2, (24, 2))
        boxes = np.concatenate(
            [xy, xy + rng.uniform(4, min(h, w) / 2, (24, 2))], 1)
        if i % 2 == 0:
            m = _blob_mask(rng, h, w)
            add(i + 1, CATS[i % 3], _bbox_of(m), rle.encode(m))
            # The crowd region fills the box [w/4, w/2) x [h/4, h/2).
            c = np.zeros((h, w), np.uint8)
            c[h // 4:h // 2, w // 4:w // 2] = 1
            c[h // 4 + 1:h // 2 - 1, w // 4 + 1:w // 2 - 1] = \
                rng.rand(h // 2 - h // 4 - 2, w // 2 - w // 4 - 2) > 0.3
            cb = _bbox_of(c)
            add(i + 1, CATS[1], cb,
                {"size": [h, w], "counts": rle.encode_counts(c)}, crowd=1)
            # Proposals over the crowd region with an intersection over
            # their own area of 1, 0.75 (past CROWD_FILTER_THRESH 0.7) and
            # 0.35 (short of it).
            x0, y0, cw, ch = cb
            for k, f in enumerate((0.0, 0.25, 0.65)):
                boxes[k] = [x0 + f * cw, y0, x0 + (1 + f) * cw - 1,
                            y0 + ch - 1]
        if i == 3:
            add(i + 1, CATS[2], [10.0, 10.0, 0.0, 5.0], [], area=0.0)
        props["boxes"].append(boxes.astype(np.float32))
        props["ids"].append(i + 1)
        props["scores"].append(rng.rand(24).astype(np.float32))
    order = rng.permutation(len(SIZES))
    props = {k: [v[j] for j in order] for k, v in props.items()}
    cats = [{"id": c, "name": "c{}".format(c), "supercategory": "thing"}
            for c in CATS]
    (root / "coco" / "annotations" / "instances_{}.json".format(split)
     ).write_text(json.dumps({"images": images, "annotations": anns,
                              "categories": cats}))
    with open(root / "props.pkl", "wb") as f:
        pickle.dump(props, f)
    return len(anns)


def _equal(a, b, path=""):
    """Deep equality of roidb values and batches (numpy arrays by value,
    dtype and shape)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], path + "." + str(k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, path + "[{}]".format(i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ---------------------------------------------------------------------------
# rle and segms
# ---------------------------------------------------------------------------

def test_polys_to_mask_and_to_bbox_match_jax():
    rng = np.random.RandomState(0)
    for h, w in ((40, 60), (64, 48), (1, 9)):
        polys = [_random_polygon(rng, max(h, 17), max(w, 17))
                 for _ in range(3)]
        got = rle.polys_to_mask(polys, h, w)
        ref = jax_rle.polys_to_mask(polys, h, w)
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        r = rle.encode(got)
        np.testing.assert_array_equal(rle.to_bbox(r), jax_rle.to_bbox(r))
        assert rle.to_bbox(r).dtype == np.float64
    empty = rle.encode(np.zeros((5, 7), np.uint8))
    np.testing.assert_array_equal(rle.to_bbox(empty),
                                  jax_rle.to_bbox(empty))


def test_segms_functions_match_jax():
    rng = np.random.RandomState(1)
    h, w = 48, 64
    polys = [[_random_polygon(rng, h, w) for _ in range(1 + k % 2)]
             for k in range(4)]
    masks = [_blob_mask(rng, h, w) for _ in range(5)]
    rles = [rle.encode(m) for m in masks]
    raw = {"size": [h, w], "counts": rle.encode_counts(masks[0])}
    dets = np.concatenate([rng.rand(5, 4) * 40, rng.rand(5, 1)], 1)

    for p in polys:
        for fn, args in ((segms.polys_to_mask, (h, w)),
                         (segms.polys_to_mask_wrt_box,
                          (np.array([3.5, 2.0, 41.0, 30.5]), 28))):
            got = fn(p, *args)
            ref = getattr(jax_segms, fn.__name__)(p, *args)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
        assert segms.is_poly(p) and jax_segms.is_poly(p)
    assert not segms.is_poly(rles[0])
    np.testing.assert_array_equal(segms.polys_to_boxes(polys),
                                  jax_segms.polys_to_boxes(polys))
    mixed = polys + rles[:2] + [raw]
    _equal(segms.flip_segms(mixed, h, w), jax_segms.flip_segms(mixed, h, w))
    _equal(segms.rle_masks_to_boxes(rles + [rle.encode(0 * masks[0])]),
           jax_segms.rle_masks_to_boxes(rles + [rle.encode(0 * masks[0])]))
    for mode in ("IOU", "IOMA"):
        assert segms.rle_mask_nms(rles, dets, 0.3, mode) == \
            jax_segms.rle_mask_nms(rles, dets, 0.3, mode)
    for method in ("AVG", "UNION"):
        _equal(segms.rle_mask_voting(rles[:2], rles, dets, 0.2, 0.4, method),
               jax_segms.rle_mask_voting(rles[:2], rles, dets, 0.2, 0.4,
                                         method))
    cls_boxes = [[], dets[:2], np.zeros((0, 5)), dets[2:]]
    cls_segms = [[], rles[:2], [], rles[2:]]
    _equal(segms.convert_from_cls_format(cls_boxes, cls_segms, None),
           jax_segms.convert_from_cls_format(cls_boxes, cls_segms, None))


# ---------------------------------------------------------------------------
# roidb, minibatch, loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_set")
    write_train_set(root)
    return root


def _set(root, fast_rcnn):
    extra = DATA_KEYS + ["DATA_DIR", str(root)]
    if fast_rcnn:
        extra += FAST_RCNN_KEYS + ["TRAIN.PROPOSAL_FILES",
                                   "('{}',)".format(root / "props.pkl")]
    set_cfgs(mask_on=True, extra=extra)


def _roidbs(root, fast_rcnn):
    _set(root, fast_rcnn)
    got = port_roidb.combined_roidb_for_training(("coco_2017_train",), (
        str(root / "props.pkl"),) if fast_rcnn else ())
    ref = jax_roidb.combined_roidb_for_training(("coco_2017_train",), (
        str(root / "props.pkl"),) if fast_rcnn else ())
    return got, ref


@pytest.mark.parametrize("fast_rcnn", [False, True], ids=["rpn", "props"])
def test_training_roidb_matches_jax(train_set, fast_rcnn):
    (got, g_ratio, g_index), (ref, r_ratio, r_index) = _roidbs(train_set,
                                                               fast_rcnn)
    assert len(got) == len(ref) == 2 * len(SIZES)
    np.testing.assert_array_equal(g_ratio, r_ratio)
    np.testing.assert_array_equal(g_index, r_index)
    for g, r in zip(got, ref):
        assert g["dataset"].name == r["dataset"].name == "coco_2017_train"
        _equal({k: v for k, v in g.items() if k != "dataset"},
               {k: v for k, v in r.items() if k != "dataset"})
    flipped = [e for e in got if e["flipped"]]
    assert len(flipped) == len(SIZES)
    assert any(isinstance(s, dict) for e in got for s in e["segms"])
    assert any(e["is_crowd"].any() for e in got)
    if fast_rcnn:
        # The crowd filter marked some proposals -1.
        assert any((e["gt_overlaps"] < 0).all(1)[e["gt_classes"] == 0].any()
                   for e in got)


@pytest.mark.parametrize("method", [True, False], ids=["method", "module"])
def test_add_proposals_matches_jax(train_set, method):
    """Runtime proposals (rows [image, x1, y1, x2, y2] in scaled
    coordinates) merged into a gt roidb, with the crowd filter and the
    class assignments (max_classes, max_overlaps)."""
    _set(train_set, False)
    rng = np.random.RandomState(9)
    scales = rng.uniform(1.0, 2.0, len(SIZES))
    rows = []
    for i, (h, w) in enumerate(SIZES):
        xy = rng.uniform(0, min(h, w) / 2, (10, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, min(h, w) / 2,
                                                      (10, 2))], 1)
        rows.append(np.concatenate([np.full((10, 1), i), boxes * scales[i]],
                                   1))
    rois = np.concatenate(rows).astype(np.float32)
    got_ds = json_dataset.JsonDataset("coco_2017_train")
    ref_ds = jax_json_dataset.JsonDataset("coco_2017_train")
    got, ref = got_ds.get_roidb(gt=True), ref_ds.get_roidb(gt=True)
    if method:
        got_ds.add_proposals(got, rois, scales, 0.7)
        ref_ds.add_proposals(ref, rois, scales, 0.7)
    else:
        json_dataset.add_proposals(got, rois, scales, 0.7)
        jax_json_dataset.add_proposals(ref, rois, scales, 0.7)
    for g, r in zip(got, ref):
        assert "max_classes" in g and len(g["boxes"]) > 10
        _equal({k: v for k, v in g.items() if k != "dataset"},
               {k: v for k, v in r.items() if k != "dataset"})


@pytest.mark.parametrize("fast_rcnn", [False, True], ids=["rpn", "props"])
def test_make_minibatch_matches_jax(train_set, fast_rcnn):
    roidb, _, _ = _roidbs(train_set, fast_rcnn)[0]
    landscape = [e for e in roidb if e["width"] >= e["height"]]
    portrait = [e for e in roidb if e["width"] < e["height"]]
    n_rle = 0
    for entries, seed in ((landscape[:3], 0), (landscape[3:5], 1),
                          (portrait[:2], 2), (portrait[-2:], 3)):
        got = loader.make_minibatch(entries, np.random.RandomState(seed))
        ref = jax_loader.make_minibatch(entries, np.random.RandomState(seed))
        assert list(got) == list(ref)
        assert ("proposals" in got) == fast_rcnn
        for k in ref:
            assert got[k].dtype == ref[k].dtype and \
                got[k].shape == ref[k].shape, k
            if k == "images":
                np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                           atol=1e-3)
            elif k != "gt_masks":
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        # Polygon masks exactly, masks resized from RLE crops to 1e-5.
        for i, e in enumerate(entries):
            gt_inds = np.where((e["gt_classes"] > 0) & ~e["is_crowd"])[0]
            for j, gi in enumerate(gt_inds[:8]):
                if isinstance(e["segms"][gi], dict):
                    n_rle += 1
                    np.testing.assert_allclose(
                        got["gt_masks"][i, j], ref["gt_masks"][i, j],
                        rtol=0, atol=1e-5)
                else:
                    np.testing.assert_array_equal(got["gt_masks"][i, j],
                                                  ref["gt_masks"][i, j])
        assert got["gt_valid"].any() and got["gt_masks"].any()
    assert n_rle > 0


def _first_batches(make, n):
    tl = make()
    try:
        return [next(tl) for _ in range(n)]
    finally:
        tl.close()


@pytest.mark.parametrize("num_threads", [1, 3])
def test_train_loader_stream_matches_jax(train_set, num_threads):
    roidb, _, _ = _roidbs(train_set, False)[0]
    got = _first_batches(lambda: loader.TrainLoader(
        roidb, 2, seed=3, prefetch=2, num_threads=num_threads), 6)
    ref = _first_batches(lambda: jax_loader.TrainLoader(
        roidb, 2, seed=3, prefetch=2, num_threads=2), 6)
    # 16 entries make 8 batches an epoch: 6 in, the stream has drawn two
    # canvases (two scales, both orientations).
    assert len({b["images"].shape for b in got}) > 1
    for g, r in zip(got, ref):
        for k in r:
            if k == "images":
                np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-3)
            elif k == "gt_masks":
                np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    # start_batch fast-forwards exactly, past the epoch's end too.
    for k in (3, 9):
        rest = _first_batches(lambda: loader.TrainLoader(
            roidb, 2, seed=3, prefetch=2, num_threads=num_threads,
            start_batch=k), 2)
        full = _first_batches(lambda: loader.TrainLoader(
            roidb, 2, seed=3, prefetch=2, num_threads=1), k + 2)[k:]
        for g, r in zip(rest, full):
            _equal(g, r)
