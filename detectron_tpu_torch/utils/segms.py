"""Segmentation mask utilities on the host (the port's copy of
detectron_tpu/utils/segms.py :14-159; reference: lib/utils/segms.py):
polys_to_mask, polys_to_mask_wrt_box, polys_to_boxes, flip_segms,
rle_masks_to_boxes, rle_mask_nms, rle_mask_voting and
convert_from_cls_format, on the port's RLE codec (data/rle.py, numpy
paths: the masks are the same bytes as the JAX package's).
"""

import numpy as np

from detectron_tpu_torch.data import rle as mask_util


def is_poly(segm):
    return isinstance(segm, (list, tuple)) and (
        len(segm) == 0 or isinstance(segm[0], (list, tuple, np.ndarray)))


def polys_to_mask(polygons, height, width):
    """Polygon list -> (H, W) float32 {0,1} mask."""
    return mask_util.polys_to_mask(polygons, height, width).astype(np.float32)


def polys_to_mask_wrt_box(polygons, box, M):
    """Rasterize polygons inside `box` at MxM resolution (the reference's
    mask-target rasterizer, lib/utils/segms.py :: polys_to_mask_wrt_box)."""
    w = box[2] - box[0]
    h = box[3] - box[1]
    w = np.maximum(w, 1)
    h = np.maximum(h, 1)
    polygons_norm = []
    for poly in polygons:
        p = np.array(poly, dtype=np.float64).copy()
        p[0::2] = (p[0::2] - box[0]) * M / w
        p[1::2] = (p[1::2] - box[1]) * M / h
        polygons_norm.append(p)
    return mask_util.polys_to_mask(polygons_norm, M, M).astype(np.float32)


def polys_to_boxes(polys):
    """Polygon instance list -> (N, 4) xyxy boxes."""
    boxes_from_polys = np.zeros((len(polys), 4), dtype=np.float64)
    for i, poly in enumerate(polys):
        xs = np.concatenate([np.array(p[0::2]) for p in poly])
        ys = np.concatenate([np.array(p[1::2]) for p in poly])
        boxes_from_polys[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes_from_polys


def flip_segms(segms, height, width):
    """Left/right flip each mask in a list of COCO segmentations."""
    flipped = []
    for segm in segms:
        if is_poly(segm):
            out = []
            for poly in segm:
                p = np.array(poly, dtype=np.float64).copy()
                p[0::2] = width - p[0::2] - 1
                out.append(p.tolist())
            flipped.append(out)
        else:  # RLE
            mask = mask_util.decode(
                segm if isinstance(segm["counts"], str)
                else mask_util.frPyObjects(segm, height, width))
            flipped.append(mask_util.encode(
                np.asfortranarray(mask[:, ::-1]).astype(np.uint8)))
    return flipped


def rle_masks_to_boxes(masks):
    """RLE list -> ((N, 4) xyxy boxes, keep indices of nonempty masks)."""
    if len(masks) == 0:
        return np.zeros((0, 4), np.float64), []
    boxes = np.zeros((len(masks), 4), np.float64)
    keep = []
    for i, r in enumerate(masks):
        x, y, w, h = mask_util.to_bbox(r)
        if w > 0 and h > 0:
            keep.append(i)
        boxes[i] = [x, y, x + w - 1, y + h - 1]
    return boxes, keep


def rle_mask_nms(masks, dets, thresh, mode="IOU"):
    """Greedy NMS on RLE masks (used by mask TTA). mode: IOU | IOMA."""
    if len(masks) == 0:
        return []
    if len(masks) == 1:
        return [0]
    all_not_crowd = [0] * len(masks)
    if mode == "IOU":
        ious = mask_util.iou(masks, masks, all_not_crowd)
    elif mode == "IOMA":
        all_crowds = [1] * len(masks)
        ious = np.maximum(
            mask_util.iou(masks, masks, all_crowds),
            mask_util.iou(masks, masks, all_crowds).T)
    else:
        raise NotImplementedError(mode)
    scores = dets[:, 4]
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(masks), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= ious[i] > thresh
        suppressed[i] = True
    return keep


def rle_mask_voting(top_masks, all_masks, all_dets, iou_thresh, binarize_thresh,
                    method="AVG"):
    """Refine each top mask by averaging overlapping candidate masks
    (reference: lib/utils/segms.py :: rle_mask_voting, used by MASK_AUG)."""
    if len(top_masks) == 0:
        return []
    all_not_crowd = [0] * len(all_masks)
    overlaps = mask_util.iou(top_masks, all_masks, all_not_crowd)
    out = []
    for k in range(len(top_masks)):
        inds = np.where(overlaps[k] >= iou_thresh)[0]
        if len(inds) == 0:
            out.append(top_masks[k])
            continue
        masks = [mask_util.decode(all_masks[i]).astype(np.float32)
                 for i in inds]
        ws = all_dets[inds, 4]
        if method == "AVG":
            soft = np.average(np.stack(masks), axis=0, weights=ws)
        elif method == "UNION":
            soft = np.max(np.stack(masks), axis=0)
        else:
            raise NotImplementedError(method)
        out.append(mask_util.encode(
            np.asfortranarray(soft >= binarize_thresh).astype(np.uint8)))
    return out


def convert_from_cls_format(cls_boxes, cls_segms, cls_keyps):
    """Per-class result lists -> flat (boxes, segms, keyps, classes)."""
    box_list = [b for b in cls_boxes if len(b) > 0]
    if len(box_list) > 0:
        boxes = np.concatenate(box_list)
    else:
        boxes = None
    if cls_segms is not None:
        segms = [s for slist in cls_segms for s in slist]
    else:
        segms = None
    if cls_keyps is not None:
        keyps = [k for klist in cls_keyps for k in klist]
    else:
        keyps = None
    classes = []
    for j in range(len(cls_boxes)):
        classes += [j] * len(cls_boxes[j])
    return boxes, segms, keyps, classes
