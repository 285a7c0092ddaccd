"""Detection visualization (the port's copy of detectron_tpu/utils/vis.py;
reference: lib/utils/vis.py): vis_one_image (matplotlib's Agg backend:
boxes, labels, mask contours, keypoint skeleton -> pdf or png) and
vis_one_image_opencv (an array drawn with OpenCV).

OpenCV and matplotlib are imported by the functions that draw, so the
engine, which imports neither, does not need them.
"""

import os

import numpy as np

from detectron_tpu_torch.data import rle as mask_util
from detectron_tpu_torch.utils import keypoints as keypoint_utils
from detectron_tpu_torch.utils.colormap import colormap
from detectron_tpu_torch.utils.segms import convert_from_cls_format

_GRAY = (218, 227, 218)
_GREEN = (18, 127, 15)
_WHITE = (255, 255, 255)


def kp_connections(keypoints):
    kp_lines = [
        [keypoints.index("left_eye"), keypoints.index("right_eye")],
        [keypoints.index("left_eye"), keypoints.index("nose")],
        [keypoints.index("right_eye"), keypoints.index("nose")],
        [keypoints.index("right_eye"), keypoints.index("right_ear")],
        [keypoints.index("left_eye"), keypoints.index("left_ear")],
        [keypoints.index("right_shoulder"), keypoints.index("right_elbow")],
        [keypoints.index("right_elbow"), keypoints.index("right_wrist")],
        [keypoints.index("left_shoulder"), keypoints.index("left_elbow")],
        [keypoints.index("left_elbow"), keypoints.index("left_wrist")],
        [keypoints.index("right_hip"), keypoints.index("right_knee")],
        [keypoints.index("right_knee"), keypoints.index("right_ankle")],
        [keypoints.index("left_hip"), keypoints.index("left_knee")],
        [keypoints.index("left_knee"), keypoints.index("left_ankle")],
        [keypoints.index("right_shoulder"), keypoints.index("left_shoulder")],
        [keypoints.index("right_hip"), keypoints.index("left_hip")],
    ]
    return kp_lines


def get_class_string(class_index, score, dataset):
    class_text = dataset.classes[class_index] if dataset is not None \
        else "id{:d}".format(class_index)
    return class_text + " {:0.2f}".format(score).lstrip("0")


def vis_one_image_opencv(im, boxes, segms=None, keypoints=None, thresh=0.9,
                         kp_thresh=2, show_box=False, dataset=None,
                         show_class=False):
    """Constructs a numpy array with the detections visualized."""
    if isinstance(boxes, list):
        boxes, segms, keypoints, classes = convert_from_cls_format(
            boxes, segms, keypoints)
    else:
        classes = None

    if boxes is None or boxes.shape[0] == 0 or max(boxes[:, 4]) < thresh:
        return im

    masks = None
    if segms is not None and len(segms) > 0:
        masks = np.stack([mask_util.decode(s) for s in segms], axis=2)
    color_list = colormap()
    mask_color_id = 0

    sorted_inds = np.argsort(-boxes[:, 4])
    for i in sorted_inds:
        bbox = boxes[i, :4]
        score = boxes[i, -1]
        if score < thresh:
            continue
        if show_box:
            im = vis_bbox(
                im, (bbox[0], bbox[1], bbox[2] - bbox[0],
                     bbox[3] - bbox[1]))
        if show_class and classes is not None:
            im = vis_class(im, (int(bbox[0]), int(bbox[1]) - 2),
                           get_class_string(classes[i], score, dataset))
        if masks is not None:
            color_mask = color_list[mask_color_id % len(color_list), 0:3]
            mask_color_id += 1
            im = vis_mask(im, masks[..., i], color_mask)
        if keypoints is not None:
            im = vis_keypoints(im, keypoints[i], kp_thresh)
    return im


def vis_bbox(img, bbox, thick=1):
    import cv2

    img = img.astype(np.uint8)
    (x0, y0, w, h) = bbox
    x1, y1 = int(x0 + w), int(y0 + h)
    x0, y0 = int(x0), int(y0)
    cv2.rectangle(img, (x0, y0), (x1, y1), _GREEN, thickness=thick)
    return img


def vis_class(img, pos, class_str, font_scale=0.35):
    import cv2

    img = img.astype(np.uint8)
    x0, y0 = int(pos[0]), int(pos[1])
    font = cv2.FONT_HERSHEY_SIMPLEX
    ((txt_w, txt_h), _) = cv2.getTextSize(class_str, font, font_scale, 1)
    back_tl = x0, y0 - int(1.3 * txt_h)
    back_br = x0 + txt_w, y0
    cv2.rectangle(img, back_tl, back_br, _GREEN, -1)
    txt_tl = x0, y0 - int(0.3 * txt_h)
    cv2.putText(img, class_str, txt_tl, font, font_scale, _GRAY,
                lineType=cv2.LINE_AA)
    return img


def vis_mask(img, mask, col, alpha=0.4, show_border=True, border_thick=1):
    import cv2

    img = img.astype(np.float32)
    idx = np.nonzero(mask)
    img[idx[0], idx[1], :] *= 1.0 - alpha
    img[idx[0], idx[1], :] += alpha * col
    if show_border:
        contours, _ = cv2.findContours(
            mask.copy().astype(np.uint8), cv2.RETR_CCOMP,
            cv2.CHAIN_APPROX_NONE)[-2:]
        cv2.drawContours(img, contours, -1, _WHITE, border_thick,
                         cv2.LINE_AA)
    return img.astype(np.uint8)


def vis_keypoints(img, kps, kp_thresh=2, alpha=0.7):
    """kps: (4, K) [x; y; logit; prob]."""
    import cv2

    dataset_keypoints, _ = keypoint_utils.get_keypoints()
    kp_lines = kp_connections(dataset_keypoints)
    cmap_ = colormap(rgb=True)
    colors = [tuple(int(c) for c in cmap_[i % len(cmap_)])
              for i in range(len(kp_lines) + 2)]
    kp_mask = np.copy(img)

    mid_shoulder = (
        kps[:2, dataset_keypoints.index("right_shoulder")]
        + kps[:2, dataset_keypoints.index("left_shoulder")]) / 2.0
    sc_mid_shoulder = np.minimum(
        kps[2, dataset_keypoints.index("right_shoulder")],
        kps[2, dataset_keypoints.index("left_shoulder")])
    mid_hip = (
        kps[:2, dataset_keypoints.index("right_hip")]
        + kps[:2, dataset_keypoints.index("left_hip")]) / 2.0
    sc_mid_hip = np.minimum(
        kps[2, dataset_keypoints.index("right_hip")],
        kps[2, dataset_keypoints.index("left_hip")])
    nose_idx = dataset_keypoints.index("nose")
    if sc_mid_shoulder > kp_thresh and kps[2, nose_idx] > kp_thresh:
        cv2.line(kp_mask, tuple(mid_shoulder.astype(np.int32)),
                 tuple(kps[:2, nose_idx].astype(np.int32)),
                 color=colors[len(kp_lines)], thickness=2,
                 lineType=cv2.LINE_AA)
    if sc_mid_shoulder > kp_thresh and sc_mid_hip > kp_thresh:
        cv2.line(kp_mask, tuple(mid_shoulder.astype(np.int32)),
                 tuple(mid_hip.astype(np.int32)),
                 color=colors[len(kp_lines) + 1], thickness=2,
                 lineType=cv2.LINE_AA)

    for l in range(len(kp_lines)):
        i1 = kp_lines[l][0]
        i2 = kp_lines[l][1]
        p1 = kps[0, i1].astype(np.int32), kps[1, i1].astype(np.int32)
        p2 = kps[0, i2].astype(np.int32), kps[1, i2].astype(np.int32)
        if kps[2, i1] > kp_thresh and kps[2, i2] > kp_thresh:
            cv2.line(kp_mask, p1, p2, color=colors[l], thickness=2,
                     lineType=cv2.LINE_AA)
        if kps[2, i1] > kp_thresh:
            cv2.circle(kp_mask, p1, radius=3, color=colors[l], thickness=-1,
                       lineType=cv2.LINE_AA)
        if kps[2, i2] > kp_thresh:
            cv2.circle(kp_mask, p2, radius=3, color=colors[l], thickness=-1,
                       lineType=cv2.LINE_AA)
    return cv2.addWeighted(img, 1.0 - alpha, kp_mask, alpha, 0)


def vis_one_image(im, im_name, output_dir, boxes, segms=None, keypoints=None,
                  thresh=0.9, kp_thresh=2, dpi=200, box_alpha=0.0,
                  dataset=None, show_class=False, ext="pdf"):
    """Visual debugging of detections (matplotlib -> file)."""
    import cv2

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    os.makedirs(output_dir, exist_ok=True)
    if isinstance(boxes, list):
        boxes, segms, keypoints, classes = convert_from_cls_format(
            boxes, segms, keypoints)
    else:
        classes = None
    if boxes is None or boxes.shape[0] == 0 or max(boxes[:, 4]) < thresh:
        return

    color_list = colormap(rgb=True) / 255
    dataset_keypoints, _ = keypoint_utils.get_keypoints()
    masks = None
    if segms is not None and len(segms) > 0:
        masks = np.stack([mask_util.decode(s) for s in segms], axis=2)

    fig = plt.figure(frameon=False)
    fig.set_size_inches(im.shape[1] / dpi, im.shape[0] / dpi)
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.axis("off")
    fig.add_axes(ax)
    ax.imshow(im[:, :, ::-1])  # BGR -> RGB

    sorted_inds = np.argsort(-boxes[:, 4])
    mask_color_id = 0
    for i in sorted_inds:
        bbox = boxes[i, :4]
        score = boxes[i, -1]
        if score < thresh:
            continue
        ax.add_patch(
            plt.Rectangle((bbox[0], bbox[1]), bbox[2] - bbox[0],
                          bbox[3] - bbox[1], fill=False, edgecolor="g",
                          linewidth=0.5, alpha=box_alpha))
        if show_class and classes is not None:
            ax.text(bbox[0], bbox[1] - 2,
                    get_class_string(classes[i], score, dataset),
                    fontsize=3, family="serif",
                    bbox=dict(facecolor="g", alpha=0.4, pad=0,
                              edgecolor="none"), color="white")
        if masks is not None:
            e = masks[:, :, i]
            color_mask = color_list[mask_color_id % len(color_list), 0:3]
            mask_color_id += 1
            contours, _ = cv2.findContours(
                e.copy().astype(np.uint8), cv2.RETR_CCOMP,
                cv2.CHAIN_APPROX_NONE)[-2:]
            for c in contours:
                ax.add_patch(
                    Polygon(c.reshape((-1, 2)), fill=True,
                            facecolor=color_mask, edgecolor="w",
                            linewidth=1.2, alpha=0.5))
        if keypoints is not None:
            kps = keypoints[i]
            plt.autoscale(False)
            for l, (i1, i2) in enumerate(
                    kp_connections(dataset_keypoints)):
                if kps[2, i1] > kp_thresh and kps[2, i2] > kp_thresh:
                    x = [kps[0, i1], kps[0, i2]]
                    y = [kps[1, i1], kps[1, i2]]
                    ax.plot(x, y, linewidth=1.0, alpha=0.7,
                            color=color_list[l % len(color_list)])

    output_name = os.path.basename(im_name) + "." + ext
    fig.savefig(os.path.join(output_dir, output_name), dpi=dpi)
    plt.close("all")
