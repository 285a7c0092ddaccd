"""The port's spans and host-sync counters (detectron_tpu_torch/utils/
tracing.py).

On the CPU, at the tiny sizes of the other port tests (a 64 x 64 canvas,
float32):

- with no profiler recording, span and spanned enter no profiler range;
- under torch.profiler, one detect_graph of a tiny FPN and a tiny C4
  model emits every dt.* span of its path, each nested in the one the
  module's table puts it in;
- the sync.* counters of one call are the inventory of its sites;
- a tiny training step nests dt.backward and dt.optimizer in
  dt.train_step beside the forward spans;
- the kernel wrappers' launch counters read and reset as before, and
  through counts() and reset().

On the card, tests/test_torch_sync_inventory.py holds the counters to
the syncs themselves.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core import test as test_ops
from detectron_tpu_torch.core.configs_presets import (mask_rcnn_r50_c4_keys,
                                                      mask_rcnn_r50_fpn)
from detectron_tpu_torch.models import train_graph
from detectron_tpu_torch.ops import cuda as cuda_ops
from detectron_tpu_torch.parallel import optimizer as opt
from detectron_tpu_torch.parallel import train_step as ts
from detectron_tpu_torch.tools import measure, trace_summary
from detectron_tpu_torch.utils import tracing
from detectron_tpu_torch.utils.synthetic import synthetic_train_batch
from test_torch_util import TINY_KEYS, TRAIN_KEYS

torch.set_num_threads(2)

CANVAS = 64
# R = 200 proposals, over the 128 per class that the tail keeps before its
# per-class NMS, so its overflow test runs (K = max(4 D, 128) < R).
KEYS = TINY_KEYS + ["TPU.COMPUTE_DTYPE", "float32",
                    "FAST_RCNN.MLP_HEAD_DIM", "32",
                    "TEST.RPN_POST_NMS_TOP_N", "200"]

# Where each span sits: the innermost dt.* span around it. The tail holds
# the box head's RoI transform and the mask branch.
PARENT = {"dt.body": "dt.detect_graph", "dt.fpn": "dt.detect_graph",
          "dt.rpn": "dt.detect_graph", "dt.proposals": "dt.detect_graph",
          "dt.tail": "dt.detect_graph", "dt.roi_xform": "dt.tail",
          "dt.box_head": "dt.tail", "dt.mask_head": "dt.tail"}

# One call's syncs by site. FPN: an anchor field per RPN level (P2-P6);
# the ladder (box RoIs, then the detections' mask RoIs) copies 3 scales
# and per-level tensors for its base window (5) and rung routing (3),
# reads one nonzero per fix-up rung (3) and one for the gather's slivers,
# and at these sizes no RoI needs a fix-up rung or the gather; the tail
# reads its overflow test once. C4: one anchor field; RoIAlign on the
# 4 x 4 res4 map takes the whole map as its window, no read.
SYNCS = {
    "fpn": {"rpn.anchors": 5, "windowed_roi.geometry": 16,
            "windowed_roi.fixup": 6, "windowed_roi.gather": 2,
            "test.class_overflow": 1},
    "c4": {"rpn.anchors": 1, "test.class_overflow": 1},
}


def set_cfg(body, extra=()):
    port_config.reset_cfg()
    if body == "fpn":
        mask_rcnn_r50_fpn()
        keys = KEYS
    else:
        keys = mask_rcnn_r50_c4_keys() + KEYS
    port_config.merge_cfg_from_list(list(keys) + list(extra))
    port_config.assert_and_infer_cfg(make_immutable=False)


def ranges(prof):
    """The profile's dt.* host ranges as (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(tracing.PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]


def parent_of(spans, span):
    """The innermost other span holding `span`."""
    name, s, e = span
    outer = [x for x in spans if x is not span
             and x[1] <= s and e <= x[2] and x[2] - x[1] > e - s]
    return min(outer, key=lambda x: x[2] - x[1])[0] if outer else None


@pytest.fixture(scope="module", params=["fpn", "c4"])
def detected(request, tmp_path_factory):
    """One profiled detect_graph of the tiny model: (body, its profile,
    the counters it moved, its Chrome trace's events)."""
    body = request.param
    set_cfg(body)
    rng = np.random.RandomState(0)
    params = measure.seeded_params(torch.device("cpu"), torch.float32, True,
                                   rng)
    images = torch.from_numpy(
        rng.randn(1, CANVAS, CANVAS, 3).astype(np.float32) * 20)
    im_info = torch.tensor([measure.im_info_for((CANVAS, CANVAS))])
    test_ops.detect_graph(params, images, im_info)
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        test_ops.detect_graph(params, images, im_info)
    after = tracing.counts()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    path = tmp_path_factory.mktemp(body)
    prof.export_chrome_trace(str(path / "t.json"))
    _, events, _ = trace_summary.load_events(str(path / "t.json"))
    return body, prof, moved, events


def test_span_enters_nothing_without_a_profiler(monkeypatch):
    def enter(*args):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", enter)
    traced = tracing.spanned("y")(lambda x: x + 1)
    before = tracing.counts().get("sync.a.site", 0)
    with tracing.span("x"):
        tracing.sync("a.site")
        assert traced(1) == 2
    assert tracing.counts()["sync.a.site"] == before + 1
    with profile(activities=[ProfilerActivity.CPU]):
        for enters in (lambda: tracing.span("x"), lambda: traced(1)):
            with pytest.raises(AssertionError, match="range was opened"):
                enters()


def test_detect_graph_emits_its_spans_nested(detected):
    body, prof, _, _ = detected
    spans = ranges(prof)
    names = {n for n, _, _ in spans}
    want = set(PARENT) | {"dt.detect_graph"}
    if body == "c4":
        want -= {"dt.fpn"}
    assert names == want
    for span in spans:
        assert parent_of(spans, span) == PARENT.get(span[0]), span
    # The box and the mask RoIs each take the RoI transform.
    assert sum(n == "dt.roi_xform" for n, _, _ in spans) == 2


def test_sync_counters_are_the_inventory(detected):
    body, _, moved, events = detected
    assert moved.pop("call.detect_graph") == 1
    assert {k[5:]: v for k, v in moved.items()} == SYNCS[body]
    by_span = trace_summary.summarize(events, "cpu")["by_span"]
    assert by_span["dt.body"]["device_ms"] > 0
    assert by_span["dt.body"]["host_ms"] > 0
    assert by_span["dt.tail"]["host_ms"] > 0


def test_train_step_spans():
    set_cfg("fpn", TRAIN_KEYS + ["TPU.GT_MASK_SIZE", "28"])
    rng = np.random.RandomState(0)
    dev = torch.device("cpu")
    params = measure.seeded_params(dev, torch.float32, False, rng)
    state = opt.init_opt_state(params)
    batch = synthetic_train_batch(1, CANVAS, CANVAS, dev, rng)
    draws = train_graph.make_draws(torch.Generator().manual_seed(1), 1,
                                   (CANVAS, CANVAS),
                                   port_config.cfg.TPU.MAX_GT_BOXES,
                                   dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts.train_step(params, state, batch, draws)
    spans = ranges(prof)
    parents = {n: parent_of(spans, (n, s, e)) for n, s, e in spans}
    assert parents["dt.train_step"] is None
    for name in ("dt.body", "dt.fpn", "dt.rpn", "dt.proposals",
                 "dt.roi_xform", "dt.box_head", "dt.mask_head",
                 "dt.backward", "dt.optimizer"):
        assert parents[name] == "dt.train_step", name


def test_launch_counters_read_as_before():
    wrappers = cuda_ops.reset_launches()
    assert set(wrappers) == set(cuda_ops.wrappers())
    assert cuda_ops.launch_counts() == dict.fromkeys(wrappers, 0)
    assert cuda_ops.reset_launches(["nms_keep_mask"]) == {
        "nms_keep_mask": wrappers["nms_keep_mask"]}
    wrappers["roi_window_pool"].launches += 3
    assert cuda_ops.launch_counts(["roi_window_pool"]) == {
        "roi_window_pool": 3}
    counts = tracing.counts()
    assert counts["launch.roi_window_pool"] == 3
    assert {k for k in counts if k.startswith("launch.")} == {
        "launch." + k for k in wrappers}
    tracing.count("call.detect_graph")
    tracing.reset()
    assert cuda_ops.launch_counts()["roi_window_pool"] == 0
    assert tracing.counts() == {"launch." + k: 0 for k in wrappers}
