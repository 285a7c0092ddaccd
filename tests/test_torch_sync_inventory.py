"""The port's host-sync counters (detectron_tpu_torch/utils/tracing.py)
held to the syncs themselves, on the card: one detect_graph of each
benchmark cell's configuration at its batch and canvas, and one training
step of the FPN configuration at batch 2, each run under
torch.cuda.set_sync_debug_mode("warn") and a profile without stacks. The
sync-debug warnings raised inside the call, the growth of the sync.*
counters and the trace's runtime sync calls inside the call's span are
one number, which tools/trace_summary.py's table by span also finds, and
each warning comes from the module that its counted site names. So a new sync left uncounted, or a count left where no sync is
any more, fails here. Every test skips where no CUDA device is present.
On a machine with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest tests/test_torch_sync_inventory.py
"""

import collections
import json
import os
import pathlib
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core import test as test_ops
from detectron_tpu_torch.models import train_graph
from detectron_tpu_torch.parallel import optimizer as opt
from detectron_tpu_torch.parallel import train_step as ts
from detectron_tpu_torch.tools import measure, trace_summary
from detectron_tpu_torch.utils import tracing
from detectron_tpu_torch.utils.synthetic import synthetic_train_batch

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
# The benchmark's cells: (configuration file, traffic file).
CELLS = {"mask_r50fpn.infer_b64": ("mask_r50fpn", "infer_b64"),
         "mask_r50c4.infer_b16": ("mask_r50c4", "infer_b16")}


def sync_moves(before, after):
    """{site: count} of the sync.* counters that moved."""
    return {k[5:]: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("sync.") and v != before.get(k, 0)}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def load(kind, name):
    with open(REPO / "benchmark" / kind / (name + ".json")) as f:
        return json.load(f)


def set_cell_cfg(config):
    """The port's cfg as the benchmark sets it for a configuration."""
    port_config.reset_cfg()
    flat = []
    for k, v in config["cfg"].items():
        flat += [k, v]
    port_config.merge_cfg_from_list(flat)
    port_config.assert_and_infer_cfg(make_immutable=False)


def syncs_of(fn, outer, tmp_path):
    """fn() once under sync-debug warnings and a profile without stacks:
    (the warnings' modules, Counter by file stem; the sync.* counters'
    moves by site; the runtime sync calls inside the range dt.<outer>;
    trace_summary's table by span)."""
    torch.cuda.synchronize()
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    moved = sync_moves(before, tracing.counts())
    where = collections.Counter(
        os.path.splitext(os.path.basename(w.filename))[0] for w in caught
        if "called a synchronizing" in str(w.message))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    _, events, _ = trace_summary.load_events(str(tmp_path / "t.json"))
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = max((e for e in X if e.get("name") == tracing.PREFIX + outer
                and e.get("cat") == "user_annotation"),
               key=lambda e: e["dur"])
    runtime = collections.Counter(
        e["name"] for e in X if e.get("cat") in trace_summary.LAUNCH_CATS
        and e["name"] in trace_summary.SYNC_NAMES
        and span["ts"] <= e["ts"] <= span["ts"] + span["dur"])
    return where, moved, runtime, trace_summary.summarize(events)["by_span"]


def assert_one_count(where, moved, runtime, by_span):
    info = "warnings by module {}, counters {}, runtime calls {}".format(
        dict(where), moved, dict(runtime))
    print(info)
    n = sum(where.values())
    assert n > 0, info
    assert sum(moved.values()) == n, info
    assert sum(runtime.values()) == n, info
    assert sum(row["syncs"] for name, row in by_span.items()
               if name != trace_summary.NO_SPAN) == n, info
    by_module = collections.Counter()
    for site, k in moved.items():
        by_module[site.split(".")[0]] += k
    assert where == by_module, info


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_syncs_are_the_counted_sites(cell, tmp_path):
    """One detect_graph of the cell's configuration, batch and canvas
    (seeded, calibrated weights; N(0, pixel_std) images), after a call
    that builds the kernels."""
    dev = card()
    config = load("configs", CELLS[cell][0])
    traffic = load("traffic", CELLS[cell][1])
    set_cell_cfg(config)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config["cfg"]["TPU.COMPUTE_DTYPE"]]
    params = measure.seeded_params(dev, dtype, True,
                                   np.random.RandomState(0))
    B, (H, W) = traffic["batch"], traffic["canvas"]
    gen = torch.Generator(device=dev).manual_seed(traffic["image_seed"])
    images = (torch.randn(B, H, W, 3, generator=gen, device=dev)
              * traffic["pixel_std"]).to(dtype)
    im_info = torch.tensor([traffic["im_info"]] * B, device=dev)
    test_ops.detect_graph(params, images, im_info)
    where, moved, runtime, by_span = syncs_of(
        lambda: test_ops.detect_graph(params, images, im_info),
        "detect_graph", tmp_path)
    assert_one_count(where, moved, runtime, by_span)
    del params, images
    torch.cuda.empty_cache()


def test_card_train_step_syncs_are_counted(tmp_path):
    """One train_step of the FPN configuration at batch 2 on the 832 x
    1344 canvas (synthetic batch), after a step that builds the kernels;
    the ladder's backward reads count too."""
    dev = card()
    set_cell_cfg(load("configs", "mask_r50fpn"))
    rng = np.random.RandomState(0)
    params = measure.seeded_params(dev, torch.bfloat16, False, rng)
    state = opt.init_opt_state(params)
    H, W = measure.CANVAS
    batch = synthetic_train_batch(2, H, W, dev, rng)
    draws = train_graph.make_draws(torch.Generator().manual_seed(1), 2,
                                   (H, W), port_config.cfg.TPU.MAX_GT_BOXES,
                                   dev)
    ts.train_step(params, state, batch, draws)
    where, moved, runtime, by_span = syncs_of(
        lambda: ts.train_step(params, state, batch, draws), "train_step",
        tmp_path)
    assert_one_count(where, moved, runtime, by_span)
    assert moved["windowed_roi.fixup_backward"] > 0, moved
