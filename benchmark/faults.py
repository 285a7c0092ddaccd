"""Faults planted in the program's timed path, for the CPU tests and for
the readings on the card (control.py --fault): each breaks one thing that
the check has to catch. The benchmark's own runs never import this.

    with planted("nms_keeps_all"):
        ...  # detect_graph runs with the fault

- moved_boxes: each batch's first image's boxes moved by 12 pixels where
  detect_graph returns them;
- half_left_out: the second half of the batch returned with no detection;
- nms_keeps_all: K1 keeps every box, in the proposals' NMS and in the
  per-class NMS alike;
- inverted_topk: the tail's top-100 over all classes takes the lowest
  scores instead of the highest, and returns them in descending order.
"""

import contextlib
import math

import torch


def _moved_boxes(out):
    out["boxes"][0] += 12.0


def _half_left_out(out):
    out["valid"][out["valid"].shape[0] // 2:] = False


@contextlib.contextmanager
def planted(name):
    from detectron_tpu_torch.core import test as test_ops
    from detectron_tpu_torch.ops import nms as nms_ops

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name in ("moved_boxes", "half_left_out"):
        real = test_ops.detect_graph
        fault = {"moved_boxes": _moved_boxes,
                 "half_left_out": _half_left_out}[name]

        def broken(*args):
            out = real(*args)
            fault(out)
            return out

        patch(test_ops, "detect_graph", broken)
    elif name == "nms_keeps_all":
        patch(nms_ops, "nms_keep_mask", lambda boxes, valid, thr: valid)
    elif name == "inverted_topk":
        real_top_k = test_ops.top_k

        def lowest(x, k):
            key = torch.where(torch.isfinite(x), -x, -math.inf)
            _, idx = real_top_k(key, k)
            v, order = torch.sort(torch.gather(x, -1, idx), dim=-1,
                                  descending=True, stable=True)
            return v, torch.gather(idx, -1, order)

        patch(test_ops, "top_k", lowest)
    else:
        raise ValueError("no fault {!r}".format(name))
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


NAMES = ("moved_boxes", "half_left_out", "nms_keeps_all", "inverted_topk")
