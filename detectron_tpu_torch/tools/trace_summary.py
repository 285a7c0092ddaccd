"""Summarize a torch.profiler trace written by tools/profile_net.py (the
port's twin of tools/trace_summary.py).

    python -m detectron_tpu_torch.tools.trace_summary OUT_DIR_OR_TRACE \\
        [--steps 3] [--top 30] [--like roi]

Reads the Chrome-trace JSON (<out>/*.trace.json.gz, the newest, or the
file given) and prints, in ms per step:

  1. device self time by kernel class: cuDNN convolution, GEMM, the port's
     kernels (csrc/, by the names in ops/cuda's PORT_KERNELS), elementwise,
     reduction, copy/transpose, sort/top-k, index/gather/scatter, other;
  2. device self time by STAGE, beside each stage's host self time and
     its host syncs. A kernel carries no stack: it is linked by its
     `correlation` id to the runtime call that launched it, and the stage
     is the file of the innermost detectron_tpu_torch/ Python frame on
     that host thread whose span holds the launch, with the kernel
     wrappers (ops/cuda/) and the layer library (models/layers.py) taken
     as part of their caller. A kernel of the backward (launched inside
     an autograd evaluate_function) is marked "(backward)": its stage is
     the frame of a Python autograd Function's backward where one runs,
     else (on the card, autograd's thread runs no Python frame) the
     stage of the forward op that made the node. Host self time is the
     time inside a stage's frames and not inside a deeper stage's; a
     host sync is a
     cudaStreamSynchronize / cudaDeviceSynchronize / cudaEventSynchronize
     under the stage (the ladder's torch.nonzero shows up this way).
     This table needs a trace with stacks (profile_net's default);
  3. by SPAN, in a trace with or without stacks: the program's own
     ranges (utils/tracing.py), the innermost dt.* range open at each
     kernel's launch (on a thread with none open, the main thread's),
     beside each span's host self time (its duration less its child
     spans), the device's idle time while it was the main thread's
     innermost span, and the host syncs (as in 2) under it;
     "(no span)" holds what ran outside the program's entry points;
  4. the top kernels, merged across steps, with TF/s where the trace
     gives FLOPs for the op that launched them.

The device's idle share is taken over the profiled steps' spans (one
"profile_net step" span a step; the whole trace without them). --device
picks whose time is summarized: cuda (default) the card's device events,
cuda:N card N's, cpu the host ops' self time; a trace with no device
event (a CPU run) falls back to the host ops, as the JAX tool falls back
when no lane names a device. Reading a trace needs no GPU, so cuda does
not raise here. The trace carries no
byte counts for kernels, so no GB/s is printed, and the port's kernels,
launched through ctypes, carry no FLOPs.
"""

import argparse
import collections
import glob
import gzip
import json
import os

from detectron_tpu_torch.ops.cuda import PORT_KERNELS


# Kernel classes, matched by name in this order (the first match wins).
NAME_CATEGORIES = (
    ("port kernels", PORT_KERNELS),
    ("copy/transpose", ("nchwtonhwc", "nhwctonchw", "transpose", "copy",
                        "memcpy", "memset", "catarray")),
    ("cuDNN convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                           "implicit_gemm", "xmma")),
    ("GEMM", ("gemm", "cublas", "cutlass", "aten::mm", "aten::addmm",
              "aten::bmm", "aten::matmul", "aten::linear")),
    ("sort/top-k", ("sort", "radix", "topk", "bitonic")),
    ("index/gather/scatter", ("index", "gather", "scatter", "nonzero",
                              "masked", "put_", "take", "embedding")),
    ("reduction", ("reduce", "softmax", "moments", "_norm", "sum", "mean",
                   "max_pool", "argmax", "scan")),
    ("elementwise", ("elementwise", "functor", "fill", "aten::add",
                     "aten::mul", "aten::sub", "aten::div", "aten::relu",
                     "aten::where", "aten::clamp", "aten::sigmoid",
                     "aten::exp")),
)

# Python frames of these files run inside a stage for every stage: their
# time and launches go to the caller's file.
HELPER_FILES = ("ops/cuda/", "models/layers.py", "utils/collections.py",
                "utils/tracing.py")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
STEP_SPAN = "profile_net step"
NO_FRAME = "(no repo frame)"
# The program's own ranges (utils/tracing.py).
SPAN_PREFIX = "dt."
NO_SPAN = "(no span)"
PACKAGE = "detectron_tpu_torch/"


def categorize(name):
    low = name.lower()
    for cat, keys in NAME_CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def frame_file(name):
    """'ops/windowed_roi.py' of a python_function event named
    '.../detectron_tpu_torch/ops/windowed_roi.py(170): fn', or None."""
    if PACKAGE not in name or "(" not in name:
        return None
    return name.split(PACKAGE, 1)[1].split("(", 1)[0]


def stage_file(name):
    """The stage of a repo frame: None for a helper, "(driver)" for the
    tools that drive a run."""
    f = frame_file(name)
    if f is None or f.startswith(HELPER_FILES):
        return None
    return "(driver)" if f.startswith("tools/") else f


def load_events(path):
    """(trace path, events, the walls dict profile_net wrote beside it or
    None). `path` is a trace file or a directory holding some."""
    if os.path.isdir(path):
        paths = glob.glob(os.path.join(path, "**", "*trace.json*"),
                          recursive=True)
        assert paths, "no *trace.json(.gz) under " + path
        path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    walls = None
    wpath = path.split(".trace.json")[0] + ".walls.json"
    if os.path.exists(wpath):
        with open(wpath) as f:
            walls = json.load(f)
    return path, data.get("traceEvents", []), walls


def self_times(events):
    """[(event, self us)]: duration less nested children, per lane (pid,
    tid), from interval stacks; trace spans nest, so inclusive sums would
    double-count."""
    lanes = collections.defaultdict(list)
    for e in events:
        lanes[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for lane_events in lanes.values():
        lane_events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end_ts, event, child time]
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
    """The label of the innermost span holding a host time point, per
    host thread (spans of one thread nest: Python frames, ops)."""

    def __init__(self, spans, default):
        self.default = default
        self.lanes = collections.defaultdict(list)
        for e, label in spans:
            self.lanes[(e.get("pid"), e.get("tid"))].append((e, label))
        for fr in self.lanes.values():
            fr.sort(key=lambda x: (x[0]["ts"], -x[0]["dur"]))

    def lookup(self, lane, points):
        """{point: label} for host time points on `lane`: a sweep with a
        stack of open spans."""
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
            out[t] = stack[-1][1] if stack else self.default
        return out


def place(index, host_events):
    """{(lane, ts): label} of `index` for each host event's start."""
    points = collections.defaultdict(list)
    for e in host_events:
        points[(e.get("pid"), e.get("tid"))].append(e["ts"])
    return {(lane, t): label for lane, pts in points.items()
            for t, label in index.lookup(lane, pts).items()}


def _lane_ts(e):
    return ((e.get("pid"), e.get("tid")), e["ts"])


def backward_stages(X, index, host_events):
    """{(lane, ts): "<stage> (backward)"} for the host events inside an
    autograd evaluate_function. The stage is that of the innermost stage
    frame opened inside the evaluate_function (a Python autograd
    Function's backward), else, as on the autograd engine's thread, where
    no Python frame runs, the stage of the forward op that made the
    node: the last forward op carrying the evaluate_function's sequence
    number (ops that make no node carry the counter's current value
    too)."""
    evals = [(e, (e.get("args") or {}).get("Sequence number", -1),
              e["ts"]) for e in X if e.get("cat") == "cpu_op"
             and e.get("name", "").startswith(
                 "autograd::engine::evaluate_function")]
    if not evals or not host_events:
        return {}
    fwd = {}
    for e in sorted(X, key=lambda e: e["ts"]):
        a = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "Sequence number" in a and \
                a.get("Fwd thread id", 0) == 0 and \
                not e.get("name", "").startswith("autograd::"):
            fwd[a["Sequence number"]] = e
    inside = place(SpanIndex([(e, (seq, ts)) for e, seq, ts in evals],
                             None), host_events)
    frames = place(index, host_events)
    ops = {k: fwd.get(v[0]) for k, v in inside.items() if v is not None}
    stage_of_op = place(index, [e for e in ops.values() if e is not None])
    out = {}
    for k, v in inside.items():
        if v is None:
            continue
        stage, frame_ts = frames[k]
        if frame_ts is None or frame_ts < v[1]:
            op = ops[k]
            stage = NO_FRAME if op is None else stage_of_op[_lane_ts(op)][0]
        out[k] = stage + " (backward)"
    return out


def _union_ms(intervals, lo, hi):
    """Length in ms of the union of (start, end) us intervals cut to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1000.0


def summarize(events, device="cuda"):
    """The tables of a trace's events, in ms over the whole trace, for
    `device`: "cuda" the card's kernels, copies and fills (all cards'),
    "cuda:N" card N's, "cpu" the host ops (as where the trace has no
    device event): {"device": bool (device events summarized), "total",
    "by_cat", "by_stage",
    "host_by_stage", "sync_by_stage", "by_op" {merge key: ms},
    "n_instances", "op_meta", "kernel_stages" {kernel name: Counter of
    stages}, "window_ms", "busy_ms", "idle_share", "steps_seen"}."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e
         and "ts" in e]
    frames = [(e, stage_file(e.get("name", ""))) for e in X
              if e.get("cat") == "python_function"]
    frames = [(e, st) for e, st in frames if st is not None]
    index = SpanIndex([(e, (st, e["ts"])) for e, st in frames],
                      (NO_FRAME, None))

    dev, measured, anchor = measured_events(X, device)
    flops_of = {}
    for e in X:
        a = e.get("args") or {}
        if e.get("cat") == "cpu_op" and a.get("flops"):
            flops_of[a.get("External id")] = float(a["flops"])

    # Host time points to place: each device event's launch, each sync,
    # and (host fallback) each host op's start.
    syncs = [e for e in X if e.get("cat") in LAUNCH_CATS
             and e.get("name") in SYNC_NAMES]
    hosts = [e for e in list(anchor.values()) + syncs if e is not None]
    where = {k: st for k, (st, _) in place(index, hosts).items()}
    where.update(backward_stages(X, index, hosts))

    def stage_at(host_event):
        if host_event is None:
            return "(unlinked)"
        return where[_lane_ts(host_event)]

    by_op = collections.Counter()
    by_cat = collections.Counter()
    by_stage = collections.Counter()
    n_instances = collections.Counter()
    op_meta = {}
    kernel_stages = collections.defaultdict(collections.Counter)
    total = 0.0
    for e, self_us in self_times(measured):
        name = e.get("name", "?")
        base, dot, suf = name.rpartition(".")
        if dot and suf.isdigit():
            name = base
        ms = self_us / 1000.0
        cat = categorize(name)
        stage = stage_at(anchor[id(e)])
        key = (name, cat, stage)
        by_op[key] += ms
        n_instances[key] += 1
        by_cat[cat] += ms
        by_stage[stage] += ms
        total += ms
        if e.get("cat") == "kernel":
            kernel_stages[name][stage] += 1
        if key not in op_meta:
            op_meta[key] = flops_of.get((e.get("args") or {})
                                        .get("External id"), 0.0)

    host_by_stage = collections.Counter()
    for e, self_us in self_times([e for e, _ in frames]):
        host_by_stage[stage_file(e["name"])] += self_us / 1000.0
    sync_by_stage = collections.Counter()
    for e in syncs:
        sync_by_stage[stage_at(e)] += e["dur"] / 1000.0

    spans = [e for e in X if e.get("name") == STEP_SPAN
             and e.get("cat") != "gpu_user_annotation"]
    if spans:
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e["dur"] for e in spans)
    else:
        lo = min((e["ts"] for e in X), default=0.0)
        hi = max((e["ts"] + e["dur"] for e in X), default=0.0)
    window_ms = (hi - lo) / 1000.0
    busy_ms = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev],
                        lo, hi)
    return {"device": bool(dev), "total": total, "by_cat": by_cat,
            "by_stage": by_stage, "host_by_stage": host_by_stage,
            "sync_by_stage": sync_by_stage, "by_op": by_op,
            "n_instances": n_instances, "op_meta": op_meta,
            "kernel_stages": kernel_stages, "window_ms": window_ms,
            "busy_ms": busy_ms,
            "idle_share": (1.0 - busy_ms / window_ms) if dev and window_ms
            else None,
            "steps_seen": len(spans),
            "by_span": span_table(X, measured, anchor, dev, lo, hi)}


def measured_events(X, device="cuda"):
    """(dev, measured, anchor) for `device` as summarize() takes it: the
    device events (every card's for "cuda", card N's for "cuda:N", none
    for "cpu"); the events measured, those or, where there are none, the
    host ops; {id(event): the host event that places it}, a device
    event's launch found by its correlation id (None where the trace
    lacks it), a host op itself."""
    card = None if device in ("cuda", "cpu") else int(device.split(":")[1])
    dev = [] if device == "cpu" else [
        e for e in X if e.get("cat") in DEVICE_CATS and card in (
            None, (e.get("args") or {}).get("device"))]
    if not dev:
        measured = [e for e in X if e.get("cat") == "cpu_op"]
        return dev, measured, {id(e): e for e in measured}
    launches = {}
    for e in X:
        a = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in a:
            launches[a["correlation"]] = e
    return dev, dev, {id(e): launches.get((e.get("args") or {})
                                          .get("correlation"))
                      for e in dev}


def innermost_segments(spans, lo, hi):
    """[(start, end, name)]: [lo, hi] cut where the innermost of `spans`
    (one thread's ranges, which nest) changes, each piece named by it,
    NO_SPAN where none is open."""
    out, stack, t = [], [], lo

    def upto(x):
        nonlocal t
        x = min(max(x, lo), hi)
        if x > t:
            out.append((t, x, stack[-1][1] if stack else NO_SPAN))
            t = x

    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1][0] <= e["ts"]:
            upto(stack[-1][0])
            stack.pop()
        upto(e["ts"])
        stack.append((e["ts"] + e["dur"], e["name"]))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(hi)
    return out


def idle_intervals(dev, lo, hi):
    """The gaps in [lo, hi] where no event of `dev` runs, sorted."""
    out, t = [], lo
    for start, end in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if start > t:
            out.append((t, min(start, hi)))
        t = max(t, end)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def span_table(X, measured, anchor, dev, lo, hi):
    """{innermost dt.* span (or NO_SPAN): {"device_ms", "host_ms",
    "idle_ms", "syncs"}} from the program's ranges, with or without
    stacks: the measured events' self time by the innermost stage span
    open at their launch (on a thread that has none open, as autograd's
    on the card, the span open then on the main thread: the one that
    holds the longest span), each span's host self time (its duration
    less its child stage spans), the device's idle time in [lo, hi] by
    the span open on the main thread, and the host syncs (SYNC_NAMES
    runtime calls) by the span open at them. {} for a trace without the
    program's ranges."""
    spans = [e for e in X if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX)]
    if not spans:
        return {}
    main = _lane_ts(max(spans, key=lambda e: e["dur"]))[0]
    index = SpanIndex([(e, e["name"]) for e in spans], NO_SPAN)
    syncs = [e for e in X if e.get("cat") in LAUNCH_CATS
             and e.get("name") in SYNC_NAMES]
    hosts = [h for h in anchor.values() if h is not None] + syncs
    where = place(index, hosts)
    stray = [k for k, name in where.items()
             if name == NO_SPAN and k[0] != main]
    on_main = index.lookup(main, [ts for _, ts in stray])
    for lane, ts in stray:
        where[(lane, ts)] = on_main[ts]
    rows = collections.defaultdict(lambda: {
        "device_ms": 0.0, "host_ms": 0.0, "idle_ms": 0.0, "syncs": 0})
    for e, self_us in self_times(measured):
        h = anchor[id(e)]
        name = "(unlinked)" if h is None else where[_lane_ts(h)]
        rows[name]["device_ms"] += self_us / 1000.0
    for e, self_us in self_times(spans):
        rows[e["name"]]["host_ms"] += self_us / 1000.0
    for e in syncs:
        rows[where[_lane_ts(e)]]["syncs"] += 1
    if dev:
        segs = innermost_segments(
            [e for e in spans if _lane_ts(e)[0] == main], lo, hi)
        gaps = idle_intervals(dev, lo, hi)
        i = 0
        for s, e, name in segs:
            while i < len(gaps) and gaps[i][1] <= s:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < e:
                rows[name]["idle_ms"] += (min(e, gaps[j][1])
                                          - max(s, gaps[j][0])) / 1000.0
                j += 1
    return dict(rows)


def report(s, steps, top=30, like=None, walls=None, path=None):
    """Print the tables of summarize()'s dict, per step."""
    per = 1.0 / max(steps, 1)
    total = s["total"]
    what = "device" if s["device"] else "host op (no device lane: CPU run)"
    if path:
        print("trace:", path)
    if walls:
        print("{}; step walls: unprofiled {} ms, profiled (stacks {}) {} "
              "ms".format(walls.get("card"), walls.get("unprofiled_ms"),
                          "on" if walls.get("stacks", True) else "off",
                          walls.get("profiled_ms")))
    print("{} self time: {:.3f} ms total, {:.3f} ms/step over {} steps"
          .format(what, total, total * per, steps))
    if s["device"]:
        print("device busy {:.3f} ms of the {:.3f} ms profiled window "
              "({} step spans): idle share {:.4f}".format(
                  s["busy_ms"], s["window_ms"], s["steps_seen"],
                  s["idle_share"]))
    print("\nby kernel class (ms/step):")
    for cat, ms in s["by_cat"].most_common():
        print("  {:<26s} {:>9.3f}  ({:4.1f}%)".format(
            cat, ms * per, 100.0 * ms / max(total, 1e-9)))
    print("\nby stage (deepest detectron_tpu_torch/ frame, ms/step): "
          "{} self, host self, host syncs".format(
              "device" if s["device"] else "host op"))
    stages = set(s["by_stage"]) | set(s["host_by_stage"])
    for st in sorted(stages, key=lambda k: (-s["by_stage"].get(k, 0.0),
                                            -s["host_by_stage"].get(k, 0.0))):
        print("  {:<34s} {:>9.3f}  ({:4.1f}%)  host {:>9.3f}  syncs "
              "{:>8.3f}".format(
                  st, s["by_stage"].get(st, 0.0) * per,
                  100.0 * s["by_stage"].get(st, 0.0) / max(total, 1e-9),
                  s["host_by_stage"].get(st, 0.0) * per,
                  s["sync_by_stage"].get(st, 0.0) * per))

    if s["by_span"]:
        print("\nby span (innermost dt.* range of utils/tracing.py, ms/step; "
              "no stacks needed): {} self, host self, device idle, host "
              "syncs a step".format("device" if s["device"] else "host op"))
        for name, row in sorted(s["by_span"].items(),
                                key=lambda kv: -kv[1]["device_ms"]):
            print("  {:<34s} {:>9.3f}  host {:>9.3f}  idle {:>9.3f}  syncs "
                  "{:>6.2f}".format(name, row["device_ms"] * per,
                                    row["host_ms"] * per,
                                    row["idle_ms"] * per,
                                    row["syncs"] * per))

    def oprow(key, ms):
        name, cat, stage = key
        n = max(s["n_instances"].get(key, 1), 1)
        flops = s["op_meta"].get(key, 0.0)
        dt = ms / n / 1000.0
        perf = " {:6.1f} TF/s".format(flops / dt / 1e12) if flops and dt \
            else ""
        label = name if n <= steps else \
            "{} [x{}]".format(name, (n + steps - 1) // steps)
        return "  {:>9.3f}  {:<48s} {:<24s}{}  {}".format(
            ms * per, label[:48], stage[:24], perf, cat)

    print("\ntop {} (ms/step, instances merged across steps; TF/s a "
          "per-instance mean where the trace gives FLOPs; no GB/s: the "
          "trace has no byte counts for kernels, and the port's ctypes "
          "kernels carry no FLOPs):".format(top))
    for key, ms in s["by_op"].most_common(top):
        print(oprow(key, ms))
    if like:
        print("\nops matching {!r} (ms/step):".format(like))
        for key, ms in sorted(s["by_op"].items(), key=lambda kv: -kv[1]):
            if like.lower() in key[0].lower():
                print(oprow(key, ms))


def main(argv=None):
    """Print the summary; returns summarize()'s dict."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="profile_net's --out directory or a "
                   "trace file")
    p.add_argument("--steps", type=int, default=3,
                   help="number of profiled steps (durations are reported "
                        "per step)")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--like", default=None,
                   help="also list every op whose name contains this "
                        "substring")
    p.add_argument("--device", default="cuda",
                   help="whose time to summarize: cuda (default; the "
                        "card's kernels), cuda:N (card N's) or cpu (the "
                        "host ops). It reads a file, so it needs no GPU")
    args = p.parse_args(argv)
    path, events, walls = load_events(args.trace)
    s = summarize(events, args.device)
    report(s, args.steps, args.top, args.like, walls, path)
    return s


if __name__ == "__main__":
    main()
