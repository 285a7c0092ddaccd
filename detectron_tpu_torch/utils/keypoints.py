"""COCO keypoint utilities on the host (the port's copy of
detectron_tpu/utils/keypoints.py; reference: lib/utils/keypoints.py):
get_keypoints (names and flip pairs), get_person_class_index,
flip_keypoints, keypoints_to_heatmap_labels, heatmaps_to_keypoints (argmax
and the sub-bin offset back to image coordinates), scores_to_probs,
compute_oks and nms_oks.

heatmaps_to_keypoints resizes each RoI's heatmaps to its box with a numpy
copy of cv2.resize's INTER_CUBIC (resize_cubic), so the engine needs no
OpenCV.
"""

import numpy as np

from detectron_tpu_torch.core.config import cfg

# cv2's bicubic coefficient (imgproc/src/resize.cpp, interpolateCubic).
_CUBIC_A = -0.75


def get_keypoints():
    """COCO keypoint names and horizontal flip correspondence."""
    keypoints = [
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
        "right_knee", "left_ankle", "right_ankle",
    ]
    keypoint_flip_map = {
        "left_eye": "right_eye",
        "left_ear": "right_ear",
        "left_shoulder": "right_shoulder",
        "left_elbow": "right_elbow",
        "left_wrist": "right_wrist",
        "left_hip": "right_hip",
        "left_knee": "right_knee",
        "left_ankle": "right_ankle",
    }
    return keypoints, keypoint_flip_map


def get_person_class_index():
    return 1


def flip_keypoints(keypoints, keypoint_flip_map, keypoint_coords, width):
    """Left/right flip keypoint coords (N, 3, K) for a width-`width` image."""
    flipped_kps = keypoint_coords.copy()
    for lkp, rkp in keypoint_flip_map.items():
        lid = keypoints.index(lkp)
        rid = keypoints.index(rkp)
        flipped_kps[:, :, lid] = keypoint_coords[:, :, rid]
        flipped_kps[:, :, rid] = keypoint_coords[:, :, lid]
    flipped_kps[:, 0, :] = width - flipped_kps[:, 0, :] - 1
    inds = np.where(flipped_kps[:, 2, :] == 0)
    flipped_kps[inds[0], 0, inds[1]] = 0
    return flipped_kps


def keypoints_to_heatmap_labels(keypoints, rois):
    """Discretize gt keypoints (N, 3, K) into per-RoI heatmap bin labels.
    Returns (heats (N, K) int, weights (N, K))."""
    M = cfg.KRCNN.HEATMAP_SIZE
    shape = (len(rois), cfg.KRCNN.NUM_KEYPOINTS)
    heatmaps = np.zeros(shape)
    weights = np.zeros(shape)
    offset_x = rois[:, 0]
    offset_y = rois[:, 1]
    scale_x = M / np.maximum(rois[:, 2] - rois[:, 0], 1e-3)
    scale_y = M / np.maximum(rois[:, 3] - rois[:, 1], 1e-3)
    for kp in range(keypoints.shape[2]):
        vis = keypoints[:, 2, kp] > 0
        x = keypoints[:, 0, kp].astype(np.float64)
        y = keypoints[:, 1, kp].astype(np.float64)
        x_boundary_inds = np.where(x == rois[:, 2])[0]
        y_boundary_inds = np.where(y == rois[:, 3])[0]
        x = np.floor((x - offset_x) * scale_x)
        x[x_boundary_inds] = M - 1
        y = np.floor((y - offset_y) * scale_y)
        y[y_boundary_inds] = M - 1
        valid_loc = np.logical_and.reduce((x >= 0, y >= 0, x < M, y < M))
        valid = np.logical_and(valid_loc, vis)
        weights[:, kp] = valid
        heatmaps[:, kp] = y * M + x
    return heatmaps.astype(np.int32), weights


def _cubic_matrix(n_in, n_out):
    """(n_out, n_in) float32 matrix of cv2's INTER_CUBIC along one axis:
    output d samples the source at (d + 0.5) * scale - 0.5, rounded to
    float32 as OpenCV's resize does, with scale = 1 / (n_out / n_in); the
    four taps around it take A = -0.75 weights (computed in float32), and a
    tap past an edge takes the edge pixel. The same rule up and down."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(
        np.float32)
    s = np.floor(f)
    t = f - s
    a = np.float32(_CUBIC_A)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    c3 = 1 - c0 - c1 - c2
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(w, (rows, np.clip(s.astype(np.int64) - 1 + k, 0,
                                    n_in - 1)), c)
    return w


def resize_cubic(maps, width, height):
    """cv2.resize(maps.transpose(1, 2, 0), (width, height),
    interpolation=cv2.INTER_CUBIC).transpose(2, 0, 1) of float32 maps
    (K, H, W), as two float32 matrix products: along x, then along y.
    Their sums run in another order than cv2's four taps, so values agree
    to float32 rounding (tests/test_torch_keypoint_data.py)."""
    maps = np.asarray(maps, np.float32)
    wx = _cubic_matrix(maps.shape[2], width)
    wy = _cubic_matrix(maps.shape[1], height)
    return np.matmul(wy, np.matmul(maps, wx.T))


def heatmaps_to_keypoints(maps, rois):
    """Extract predicted keypoint locations from heatmaps (N, K, S, S).

    Returns (N, 4, K): x, y, logit, prob. Keypoints decode back to image
    coordinates; argmax with the sub-bin half-cell offset (Detectron's
    heatmaps_to_keypoints, including the per-roi ceil-based resize scale).
    """
    offset_x = rois[:, 0]
    offset_y = rois[:, 1]
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    widths_ceil = np.ceil(widths)
    heights_ceil = np.ceil(heights)

    num_keypoints = cfg.KRCNN.NUM_KEYPOINTS
    xy_preds = np.zeros((len(rois), 4, num_keypoints), np.float32)
    for i in range(len(rois)):
        roi_map_width = int(widths_ceil[i])
        roi_map_height = int(heights_ceil[i])
        width_correction = widths[i] / roi_map_width
        height_correction = heights[i] / roi_map_height
        roi_map = resize_cubic(maps[i], roi_map_width, roi_map_height)
        roi_map_probs = scores_to_probs(roi_map.copy())
        for k in range(num_keypoints):
            pos = roi_map[k].argmax()
            x_int = pos % roi_map_width
            y_int = (pos - x_int) // roi_map_width
            x = (x_int + 0.5) * width_correction
            y = (y_int + 0.5) * height_correction
            xy_preds[i, 0, k] = x + offset_x[i]
            xy_preds[i, 1, k] = y + offset_y[i]
            xy_preds[i, 2, k] = roi_map[k, y_int, x_int]
            xy_preds[i, 3, k] = roi_map_probs[k, y_int, x_int]
    return xy_preds


def scores_to_probs(scores):
    """Per-keypoint spatial softmax over (K, H, W) score maps."""
    channels = scores.shape[0]
    for c in range(channels):
        temp = scores[c, :, :]
        max_score = temp.max()
        temp = np.exp(temp - max_score) / np.sum(np.exp(temp - max_score))
        scores[c, :, :] = temp
    return scores


def compute_oks(src_keypoints, src_roi, dst_keypoints, dst_roi):
    """Object keypoint similarity between a source and destination set."""
    sigmas = np.array([
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089])
    vars_ = (sigmas * 2) ** 2
    src_area = (src_roi[2] - src_roi[0] + 1) * (src_roi[3] - src_roi[1] + 1)
    dx = dst_keypoints[:, 0] - src_keypoints[0]
    dy = dst_keypoints[:, 1] - src_keypoints[1]
    e = (dx**2 + dy**2) / vars_ / (src_area + np.spacing(1)) / 2
    return np.sum(np.exp(-e), axis=1) / e.shape[1]


def nms_oks(kp_predictions, rois, thresh):
    """Greedy NMS by object keypoint similarity."""
    scores = np.mean(kp_predictions[:, 2, :], axis=1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ovr = compute_oks(
            kp_predictions[i], rois[i], kp_predictions[order[1:]],
            rois[order[1:]])
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
