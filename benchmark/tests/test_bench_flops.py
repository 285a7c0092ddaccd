"""The benchmark's FLOP count (flops.py) against torch's FlopCounterMode
over the plain reference at a tiny canvas: convolutions, transposed
convolutions and matrix products, the parts aten counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check, flops
from benchmark.reference.model import Model
from benchmark.tests import tiny
from benchmark.weights import make_weights

COUNTED = ("convolution", "mm", "addmm", "bmm")


@pytest.mark.parametrize("config", ["mask_r50fpn", "mask_r50c4"])
def test_flops_match_the_counter(config):
    c = tiny.tiny_config(config, "float32")
    H, W = 128, 160
    gen = torch.Generator().manual_seed(5)
    image = torch.randn(H, W, 3, generator=gen) * 20.0
    info = [120.0, 150.0, 1.0]
    traffic = {"canvas": [H, W], "pixel_std": 20.0, "im_info": info}
    params = make_weights(c, traffic, "cpu", torch.float32)
    ref = Model(check.model_cfg(c), params)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        feats, scales = ref.features(image)
        rois, valid = ref.proposals(feats, info)
        probs, boxes = ref.candidates(feats, scales, rois, valid, info)
        b, _, cls, _ = ref.detections(probs, boxes)
        ref.mask_probs(feats, scales, b, cls)
    counts = counter.get_flop_counts()["Global"]
    got = sum(v for k, v in counts.items()
              if str(k).split(".")[1] in COUNTED)
    assert got == flops.inference_per_image(c["cfg"], (H, W))
