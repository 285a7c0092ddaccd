"""Host-side (numpy) box geometry for the data layer, the engine and the
evaluator and test-time augmentation (the port's copy of
detectron_tpu/utils/boxes.py :24-352, less the decode/encode helpers,
which the port's engine does not run on the host; reference:
lib/utils/boxes.py).

Boxes are [x1, y1, x2, y2] with the Detectron convention that a box
includes its far edge pixel: width = x2 - x1 + 1. nms runs the port's
native host op (detectron_tpu_torch/native, C++ built with g++ at the
first call), as the JAX package's does; its numpy body stays as nms_plain,
the plain version the tests and chip_smoke hold it against, bit for bit.
bbox_overlaps, soft_nms and box_voting are numpy, as in the JAX package.
"""

import numpy as np

from detectron_tpu_torch import native


def unique_boxes(boxes, scale=1.0):
    """Return indices of unique boxes (used by DEDUP_BOXES hashing)."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def xywh_to_xyxy(xywh):
    """Convert [x1 y1 w h] box format to [x1 y1 x2 y2] format."""
    if isinstance(xywh, (list, tuple)):
        assert len(xywh) == 4
        x1, y1 = xywh[0], xywh[1]
        x2 = x1 + np.maximum(0.0, xywh[2] - 1.0)
        y2 = y1 + np.maximum(0.0, xywh[3] - 1.0)
        return (x1, y1, x2, y2)
    elif isinstance(xywh, np.ndarray):
        return np.hstack(
            (xywh[:, 0:2], xywh[:, 0:2] + np.maximum(0, xywh[:, 2:4] - 1)))
    else:
        raise TypeError("Argument xywh must be a list, tuple, or numpy array.")


def xyxy_to_xywh(xyxy):
    """Convert [x1 y1 x2 y2] box format to [x1 y1 w h] format."""
    if isinstance(xyxy, (list, tuple)):
        assert len(xyxy) == 4
        x1, y1 = xyxy[0], xyxy[1]
        w = xyxy[2] - x1 + 1
        h = xyxy[3] - y1 + 1
        return (x1, y1, w, h)
    elif isinstance(xyxy, np.ndarray):
        return np.hstack((xyxy[:, 0:2], xyxy[:, 2:4] - xyxy[:, 0:2] + 1))
    else:
        raise TypeError("Argument xyxy must be a list, tuple, or numpy array.")


def filter_small_boxes(boxes, min_size):
    """Keep boxes with width and height both >= min_size."""
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    keep = np.where((w >= min_size) & (h >= min_size))[0]
    return keep


def clip_boxes_to_image(boxes, height, width):
    """Clip an array of boxes to an image with the given height and width."""
    boxes[:, [0, 2]] = np.minimum(width - 1.0, np.maximum(0.0, boxes[:, [0, 2]]))
    boxes[:, [1, 3]] = np.minimum(height - 1.0, np.maximum(0.0, boxes[:, [1, 3]]))
    return boxes


def clip_xyxy_to_image(x1, y1, x2, y2, height, width):
    x1 = np.minimum(width - 1.0, np.maximum(0.0, x1))
    y1 = np.minimum(height - 1.0, np.maximum(0.0, y1))
    x2 = np.minimum(width - 1.0, np.maximum(0.0, x2))
    y2 = np.minimum(height - 1.0, np.maximum(0.0, y2))
    return x1, y1, x2, y2


def expand_boxes(boxes, scale):
    """Expand boxes around their center by `scale` (used by paste_mask)."""
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5

    w_half *= scale
    h_half *= scale

    boxes_exp = np.zeros(boxes.shape, dtype=boxes.dtype)
    boxes_exp[:, 0] = x_c - w_half
    boxes_exp[:, 2] = x_c + w_half
    boxes_exp[:, 1] = y_c - h_half
    boxes_exp[:, 3] = y_c + h_half
    return boxes_exp


def bbox_overlaps(boxes, query_boxes):
    """Pairwise IoU matrix (N, K), +1 edge convention, zero for
    non-overlapping pairs (cython_bbox.bbox_overlaps semantics)."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    query_boxes = np.ascontiguousarray(query_boxes, dtype=np.float64)
    if boxes.size == 0 or query_boxes.size == 0:
        return np.zeros((boxes.shape[0], query_boxes.shape[0]), dtype=np.float64)

    areas_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    areas_q = (query_boxes[:, 2] - query_boxes[:, 0] + 1) * (
        query_boxes[:, 3] - query_boxes[:, 1] + 1)

    ix1 = np.maximum(boxes[:, None, 0], query_boxes[None, :, 0])
    iy1 = np.maximum(boxes[:, None, 1], query_boxes[None, :, 1])
    ix2 = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
    iy2 = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])

    iw = np.maximum(ix2 - ix1 + 1, 0.0)
    ih = np.maximum(iy2 - iy1 + 1, 0.0)
    inter = iw * ih
    union = areas_b[:, None] + areas_q[None, :] - inter
    overlaps = np.where(inter > 0, inter / union, 0.0)
    return overlaps


def nms(dets, thresh):
    """Greedy NMS on the host. dets: (N, 5) [x1,y1,x2,y2,score], float32 or
    float64. Returns the kept indices in descending-score order
    (cython_nms.nms semantics), through the native nms."""
    return native.nms(dets, thresh)


def nms_plain(dets, thresh):
    """The numpy version of nms."""
    if dets.shape[0] == 0:
        return []
    x1 = dets[:, 0]
    y1 = dets[:, 1]
    x2 = dets[:, 2]
    y2 = dets[:, 3]
    scores = dets[:, 4]

    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]

    keep = []
    suppressed = np.zeros(dets.shape[0], dtype=bool)
    for _i in range(dets.shape[0]):
        i = order[_i]
        if suppressed[i]:
            continue
        keep.append(int(i))
        rest = order[_i + 1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        suppressed[rest[ovr > thresh]] = True
    return keep


def soft_nms(dets, sigma=0.5, overlap_thresh=0.3, score_thresh=0.001,
             method="linear"):
    """Soft-NMS (Bodla et al.): decay scores of overlapping boxes instead of
    suppressing. Matches cython_nms.soft_nms semantics ('linear'|'gaussian'|
    'hard'). Returns (new_dets, kept_original_indices)."""
    methods = {"hard": 0, "linear": 1, "gaussian": 2}
    assert method in methods, "Unknown soft_nms method: {}".format(method)
    method_id = methods[method]

    dets = dets.copy().astype(np.float32)
    N = dets.shape[0]
    inds = np.arange(N)

    i = 0
    while i < N:
        # Move the max-scoring remaining box to position i
        max_pos = i + np.argmax(dets[i:, 4])
        dets[[i, max_pos]] = dets[[max_pos, i]]
        inds[[i, max_pos]] = inds[[max_pos, i]]

        box = dets[i]
        area_i = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)

        rest = dets[i + 1:N]
        if rest.shape[0] > 0:
            xx1 = np.maximum(box[0], rest[:, 0])
            yy1 = np.maximum(box[1], rest[:, 1])
            xx2 = np.minimum(box[2], rest[:, 2])
            yy2 = np.minimum(box[3], rest[:, 3])
            w = np.maximum(0.0, xx2 - xx1 + 1)
            h = np.maximum(0.0, yy2 - yy1 + 1)
            inter = w * h
            areas_r = (rest[:, 2] - rest[:, 0] + 1) * (rest[:, 3] - rest[:, 1] + 1)
            ov = inter / (area_i + areas_r - inter)

            if method_id == 1:  # linear
                weight = np.where(ov > overlap_thresh, 1.0 - ov, 1.0)
            elif method_id == 2:  # gaussian
                weight = np.exp(-(ov * ov) / sigma)
            else:  # hard (classic nms)
                weight = np.where(ov > overlap_thresh, 0.0, 1.0)
            rest[:, 4] *= weight

            # Drop boxes that fell below the score threshold: swap to the end
            keep_mask = rest[:, 4] >= score_thresh
            n_keep = int(keep_mask.sum())
            order_keep = np.concatenate(
                [np.where(keep_mask)[0], np.where(~keep_mask)[0]])
            dets[i + 1:N] = rest[order_keep]
            inds[i + 1:N] = inds[i + 1:N][order_keep]
            N = i + 1 + n_keep
        i += 1

    return dets[:N], inds[:N]


def box_voting(top_dets, all_dets, thresh, scoring_method="ID", beta=1.0):
    """Bounding-box voting (Gidaris & Komodakis): refine each surviving box
    by the score-weighted average of all boxes that overlap it >= thresh."""
    top_dets_out = top_dets.copy()
    top_boxes = top_dets[:, :4]
    all_boxes = all_dets[:, :4]
    all_scores = all_dets[:, 4]
    top_to_all_overlaps = bbox_overlaps(top_boxes, all_boxes)
    for k in range(top_dets_out.shape[0]):
        inds_to_vote = np.where(top_to_all_overlaps[k] >= thresh)[0]
        boxes_to_vote = all_boxes[inds_to_vote, :]
        ws = all_scores[inds_to_vote]
        top_dets_out[k, :4] = np.average(boxes_to_vote, axis=0, weights=ws)
        if scoring_method == "ID":
            pass
        elif scoring_method == "TEMP_AVG":
            # Temperature hyper-parameter beta softmax average
            P = np.exp(ws / beta)
            P /= P.sum()
            top_dets_out[k, 4] = (P * ws).sum()
        elif scoring_method == "AVG":
            top_dets_out[k, 4] = ws.mean()
        elif scoring_method == "IOU_AVG":
            P = top_to_all_overlaps[k, inds_to_vote]
            top_dets_out[k, 4] = np.average(ws, weights=P)
        elif scoring_method == "GENERALIZED_AVG":
            top_dets_out[k, 4] = np.mean(ws**beta) ** (1.0 / beta)
        elif scoring_method == "QUASI_SUM":
            top_dets_out[k, 4] = ws.sum() / float(len(ws)) ** beta
        else:
            raise NotImplementedError(
                "Unknown scoring method {}".format(scoring_method))
    return top_dets_out


def flip_boxes(boxes, im_width):
    """Flip boxes (N, 4k) horizontally in an image im_width wide."""
    boxes_flipped = boxes.copy()
    boxes_flipped[:, 0::4] = im_width - boxes[:, 2::4] - 1
    boxes_flipped[:, 2::4] = im_width - boxes[:, 0::4] - 1
    return boxes_flipped


def aspect_ratio(boxes, aspect_ratio_):
    """Scale the x coordinates of boxes (N, 4k) by aspect_ratio_ (the
    width-relative aspect-ratio transform of test-time augmentation)."""
    boxes_ar = boxes.copy()
    boxes_ar[:, 0::4] = aspect_ratio_ * boxes[:, 0::4]
    boxes_ar[:, 2::4] = aspect_ratio_ * boxes[:, 2::4]
    return boxes_ar
