"""The traced stretch: torch.profiler over a few batches after the window,
read from its Chrome trace.

Two profiles. The first, without Python stacks, gives the device's busy
and window seconds, the device operations that took most time and the
longest idle gaps, each named by the host operation in flight. The
second, with stacks, ties each kernel to the stage that launched it:
kernels carry no stack, so each is linked by its `correlation` id to the
runtime call that launched it, and that call's enclosing Python frames of
the program are the ones open on its thread at its start (a frozen copy
of the program's tools/trace_summary.py arithmetic: self_times,
SpanIndex, place, _union_ms). Stacks slow the host, so nothing host-timed
is read from the second profile.

STAGES gives each stage's rule, first match wins, over the program's
frames enclosing the launch (file relative to the package, function):
a frame in one of the files, or of one of the functions, listed.
"""

import collections
import gzip
import json
import os
import tempfile

PACKAGE = "detectron_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BATCH_SPAN = "benchmark batch"
# Kernel names are C++ template instances of hundreds of characters.
NAME_CHARS = 160

STAGES = (
    ("heads", ("models/fast_rcnn_heads.py", "models/mask_rcnn_heads.py"),
     ("apply_roi_conv5_head",)),
    ("roi_xform", ("ops/windowed_roi.py", "ops/multilevel_roi.py",
                   "ops/roi_align.py", "ops/roi_pool.py", "ops/roi_crop.py"),
     ("roi_feature_transform",)),
    ("body", ("models/resnet.py", "models/fpn.py"), ("forward_features",)),
    ("proposals", ("models/rpn.py", "ops/anchors.py"),
     ("forward_rpn", "generate_proposals")),
)
OTHER = "tail"


def frame(name):
    """(file, function) of a python_function event named
    '.../detectron_tpu_torch/ops/nms.py(20): fn', or None."""
    if PACKAGE not in name or "(" not in name:
        return None
    rest = name.split(PACKAGE, 1)[1]
    return rest.split("(", 1)[0], rest.rsplit(": ", 1)[-1]


def stage_of(frames):
    files = {f for f, _ in frames}
    funcs = {fn for _, fn in frames}
    for stage, stage_files, stage_funcs in STAGES:
        if files.intersection(stage_files) or funcs.intersection(stage_funcs):
            return stage
    return OTHER


def self_times(events):
    """[(event, self us)] per lane (pid, tid): duration less nested
    children."""
    lanes = collections.defaultdict(list)
    for e in events:
        lanes[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for lane_events in lanes.values():
        lane_events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in lane_events:
            while stack and e["ts"] >= stack[-1][0] - 1e-9:
                _, pe, child = stack.pop()
                out.append((pe, pe["dur"] - child))
            if stack:
                stack[-1][2] += e["dur"]
            stack.append([e["ts"] + e["dur"], e, 0.0])
        while stack:
            _, pe, child = stack.pop()
            out.append((pe, pe["dur"] - child))
    return out


class SpanIndex:
    """The labels of every span open at a host time point, innermost last,
    per host thread."""

    def __init__(self, spans):
        self.lanes = collections.defaultdict(list)
        for e, label in spans:
            self.lanes[(e.get("pid"), e.get("tid"))].append((e, label))
        for fr in self.lanes.values():
            fr.sort(key=lambda x: (x[0]["ts"], -x[0]["dur"]))

    def lookup(self, lane, points):
        spans = self.lanes.get(lane, [])
        out = {}
        stack, i = [], 0
        for t in sorted(set(points)):
            while i < len(spans) and spans[i][0]["ts"] <= t:
                e, label = spans[i]
                while stack and stack[-1][0] <= e["ts"]:
                    stack.pop()
                stack.append((e["ts"] + e["dur"], label))
                i += 1
            while stack and stack[-1][0] < t:
                stack.pop()
            out[t] = tuple(label for _, label in stack)
        return out


def place(index, host_events):
    points = collections.defaultdict(list)
    for e in host_events:
        points[(e.get("pid"), e.get("tid"))].append(e["ts"])
    return {(lane, t): labels for lane, pts in points.items()
            for t, labels in index.lookup(lane, pts).items()}


def union_intervals(intervals, lo, hi):
    """The union of (start, end) intervals cut to [lo, hi], sorted."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def load_trace(prof):
    """The profile's complete events, through a Chrome trace written to a
    temporary file and removed."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json.gz")
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and "ts" in e]


def _window(X):
    spans = [e for e in X if e.get("name") == BATCH_SPAN
             and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no '{}' span".format(BATCH_SPAN))
    return (min(e["ts"] for e in spans),
            max(e["ts"] + e["dur"] for e in spans), len(spans))


def summarize_device(X, top=10):
    """busy_s, window_s, the top device operations [(name, s)] and the
    longest idle gaps [(host op in flight, s)] of a trace without stacks."""
    lo, hi, n = _window(X)
    dev = [e for e in X if e.get("cat") in DEVICE_CATS]
    busy = union_intervals([(e["ts"], e["ts"] + e["dur"]) for e in dev],
                           lo, hi)
    by_op = collections.Counter()
    for e, self_us in self_times(dev):
        if e["ts"] >= lo and e["ts"] <= hi:
            by_op[e.get("name", "?")] += self_us / 1e6
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    host = [ev for ev in X if ev.get("cat") in ("cpu_op",) + LAUNCH_CATS]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = [ev for ev in host if ev["ts"] <= mid <= ev["ts"] + ev["dur"]]
        label = min(inside, key=lambda ev: ev["dur"])["name"] if inside \
            else "(host, no operation)"
        named.append([label, (e - s) / 1e6])
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (hi - lo) / 1e6, "batches": n,
            "device_ops": [[k[:NAME_CHARS], v]
                           for k, v in by_op.most_common(top)],
            "idle_gaps": named}


def stage_device_s(X):
    """{stage: device seconds} of a trace with stacks, and the batches."""
    lo, hi, n = _window(X)
    frames = []
    for e in X:
        if e.get("cat") == "python_function":
            fr = frame(e.get("name", ""))
            if fr is not None:
                frames.append((e, fr))
    index = SpanIndex(frames)
    launches = {}
    for e in X:
        a = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in a:
            launches[a["correlation"]] = e
    dev = [e for e in X if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] <= hi]
    anchor = {id(e): launches.get((e.get("args") or {}).get("correlation"))
              for e in dev}
    where = place(index, [h for h in anchor.values() if h is not None])
    out = collections.Counter()
    for e, self_us in self_times(dev):
        h = anchor[id(e)]
        stage = "(unlinked)" if h is None else stage_of(
            where[((h.get("pid"), h.get("tid")), h["ts"])])
        out[stage] += self_us / 1e6
    return dict(out), n
