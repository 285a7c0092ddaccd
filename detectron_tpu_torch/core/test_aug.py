"""Test-time input preparation (the port's copy of _prep from
detectron_tpu/core/test_aug.py :19-28). im_detect_all needs it even without
test-time augmentation; the augmentations themselves (TEST.BBOX_AUG,
TEST.MASK_AUG, TEST.KPS_AUG) wait for ROADMAP Queue A, A9.
"""

import numpy as np

from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.utils import blob as blob_utils


def _prep(im, target_size, max_size, hflip=False):
    img = im[:, ::-1, :] if hflip else im
    prepped, scale = blob_utils.prep_im_for_blob(
        img, cfg.PIXEL_MEANS, target_size, max_size)
    landscape = prepped.shape[1] >= prepped.shape[0]
    canvas = blob_utils.static_canvas(target_size, max_size, landscape)
    blob = blob_utils.im_to_canvas(prepped, canvas)[None]
    im_info = np.array([[prepped.shape[0], prepped.shape[1], scale]],
                       np.float32)
    return blob, scale, im_info
