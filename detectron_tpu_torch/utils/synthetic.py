"""Numpy twin of detectron_tpu.utils.synthetic.calibrate_detector_params.

Random-init heads give a pathological work mix (a uniform 81-way softmax
sends every proposal over TEST.SCORE_THRESH; rpn_bbox_pred deltas rail at
the decode clip). The calibration moves the tree toward a trained
detector's output statistics, the same way and with the same random draws
as the JAX version, on a numpy params tree (models/init.init_model, or a
JAX tree after np.asarray on each leaf).
"""

import numpy as np


def calibrate_detector_params(params, rng=None):
    """cls_score bias: background +4.5 plus N(0, 0.5) fg noise;
    rpn_bbox_pred w and b scaled by 0.005. Updates and returns `params`."""
    if rng is None:
        rng = np.random.RandomState(0)
    b = np.asarray(params["box_outs"]["cls_score"]["b"]).copy()
    b[0] += 4.5
    b[1:] += rng.randn(b.size - 1).astype(np.float32) * 0.5
    params["box_outs"]["cls_score"]["b"] = b
    for k in ("w", "b"):
        params["rpn"]["rpn_bbox_pred"][k] = (
            np.asarray(params["rpn"]["rpn_bbox_pred"][k]) * 0.005)
    return params
