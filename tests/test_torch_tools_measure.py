"""The port's measuring and parity tools (detectron_tpu_torch/tools/
golden_compare, profile_net, trace_summary, stage_bench, roi_bench,
multiscale_bench) on the CPU at tiny shapes.

- golden_compare: the port's stage dump against the JAX tool's
  (tools/golden_compare.py) on the same seeded params and image, diffed
  with the port's diff_dumps, at tests/test_golden_compare.py's tiny cfg
  (float32; both cfgs set from one list of keys, the JAX side on its
  plain gather RoIAlign and XLA NMS instead of that cfg's TPU.ROI_IMPL
  'windowed', whose route tests/test_torch_roi_routes.py holds on its
  own; the port runs its default ladder). Tolerance, diff_dumps'
  own rel (max abs difference over max |JAX value|): 1e-4 on every stage,
  1e-3 on the mask probabilities, as tests/test_torch_detect.py holds
  them on its low-contrast (x0.3) images. The image here is low-contrast
  too, pixel means plus N(0, 1): with random weights and no trained BN
  statistics the body is linear in the input's scale, and a full-contrast
  image (0-255 noise) makes the mask logits ~100x larger, so their float32
  rounding differences pass through the sigmoid near 0.5 as ~100x larger
  probability differences (1.7e-2 measured there; every stage before the
  tail stays within 4e-5 either way). A perturbed FPN weight fails first
  at its fpn_p stage; the NCHW auto-transpose has its own case; --pkl and
  --image go through main.
- trace_summary on a hand-built Chrome trace (two host threads, nested
  Python frames, runtime launches, kernels with correlation ids on a
  device lane, 2 steps): exact self times by class and by stage, host
  self time and syncs by stage, instances merged across steps, the idle
  share; on a second one, the program's dt.* spans without stacks: exact
  device, host self and idle ms and syncs by span. Then profile_net
  --device cpu (inference and a training step; inference again with
  --no_stack) and trace_summary on its trace: the host-op fallback.
- roi_bench at a tiny pyramid: the ladder, the level sweep and the gather
  agree within 1e-5 in float32.
- stage_bench and multiscale_bench print their lines / JSON rows.
- Every tool that runs a model defaults to --device cuda, which raises
  here.
"""

import gzip
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.tools import (golden_compare, multiscale_bench,
                                       profile_net, roi_bench, stage_bench,
                                       trace_summary)
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import image_io
from test_torch_util import TINY_KEYS, TRAIN_KEYS, jax_plain_paths, set_cfgs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

# tests/test_golden_compare.py::_tiny_cfg's keys, less TPU.ROI_IMPL
# 'windowed' (see the module docstring).
GOLDEN_KEYS = [
    "MODEL.CONV_BODY", "FPN.fpn_ResNet50_conv5_body",
    "MODEL.FASTER_RCNN", "True",
    "MODEL.MASK_ON", "True",
    "MODEL.NUM_CLASSES", "4",
    "FPN.FPN_ON", "True",
    "FPN.MULTILEVEL_ROIS", "True",
    "FPN.MULTILEVEL_RPN", "True",
    "FAST_RCNN.ROI_BOX_HEAD", "fast_rcnn_heads.roi_2mlp_head",
    "FAST_RCNN.ROI_XFORM_METHOD", "RoIAlign",
    "FAST_RCNN.ROI_XFORM_RESOLUTION", "7",
    "FAST_RCNN.ROI_XFORM_SAMPLING_RATIO", "2",
    "FAST_RCNN.MLP_HEAD_DIM", "32",
    "MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs",
    "MRCNN.RESOLUTION", "14",
    "MRCNN.ROI_XFORM_RESOLUTION", "7",
    "MRCNN.ROI_XFORM_SAMPLING_RATIO", "2",
    "TEST.SCALE", "96",
    "TEST.MAX_SIZE", "128",
    "TEST.RPN_PRE_NMS_TOP_N", "64",
    "TEST.RPN_POST_NMS_TOP_N", "16",
    "TEST.DETECTIONS_PER_IM", "8",
    "TEST.SCORE_THRESH", "0.0",
    "TPU.NMS_TILE_SIZE", "32",
    "TPU.ROI_WINDOW", "16",
    "TPU.ROI_CHUNK", "16",
    "TPU.COMPUTE_DTYPE", "float32",
]
MASK_KEY = "det_mask_probs"
GOLDEN_REL, MASK_REL = 1e-4, 1e-3

# The port's tiny inference and training keys for the tools that merge
# their own cfg (the mask_rcnn_r50_fpn preset, bf16, then --set).
TINY_SET = TINY_KEYS + ["TPU.COMPUTE_DTYPE", "float32",
                        "FAST_RCNN.MLP_HEAD_DIM", "32"]
TRAIN_SET = TINY_SET + TRAIN_KEYS + ["TPU.GT_MASK_SIZE", "28",
                                     "SOLVER.CLIP_GRADIENTS", "10"]


def _jax_golden():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import golden_compare as jax_golden
    finally:
        sys.path.pop(0)
    return jax_golden


def _image():
    """A low-contrast 60 x 80 BGR image: the pixel means plus N(0, 1)."""
    means = np.array([102.9801, 115.9465, 122.7717])
    rng = np.random.RandomState(7)
    return np.clip(np.round(means + rng.randn(60, 80, 3)), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def golden():
    """(numpy params tree, image, the JAX tool's stages), one JAX compile
    for the module."""
    from detectron_tpu.models import model_builder as jax_mb

    set_cfgs(extra=GOLDEN_KEYS)
    jax_plain_paths()
    tree = jax.tree.map(np.array, jax_mb.init_model(jax.random.PRNGKey(0)))
    im = _image()
    stages = _jax_golden().dump_stages(jax.tree.map(jnp.asarray, tree), im)
    return tree, im, stages


def _port_dump(tree, im):
    set_cfgs(extra=GOLDEN_KEYS)
    return golden_compare.dump_stages(bridge.to_torch(tree, "cpu"), im)


def _rels(a, b):
    return {k: float(np.abs(a[k] - b[k]).max()) /
            max(float(np.abs(a[k]).max()), 1e-12) for k in a}


def test_golden_dump_matches_the_jax_dump(golden, tmp_path):
    tree, im, ref = golden
    got = _port_dump(tree, im)
    assert set(got) == set(ref)
    for k in ref:
        assert np.asarray(ref[k]).shape == got[k].shape, k
    np.savez(tmp_path / "jax.npz", **ref)
    np.savez(tmp_path / "port.npz", **got)
    assert golden_compare.diff_dumps(str(tmp_path / "jax.npz"),
                                     str(tmp_path / "port.npz"),
                                     MASK_REL) == 0
    np.savez(tmp_path / "jax_nomask.npz",
             **{k: v for k, v in ref.items() if k != MASK_KEY})
    np.savez(tmp_path / "port_nomask.npz",
             **{k: v for k, v in got.items() if k != MASK_KEY})
    assert golden_compare.diff_dumps(str(tmp_path / "jax_nomask.npz"),
                                     str(tmp_path / "port_nomask.npz"),
                                     GOLDEN_REL) == 0
    rels = _rels(ref, got)
    assert rels[MASK_KEY] <= MASK_REL
    assert max(v for k, v in rels.items() if k != MASK_KEY) <= GOLDEN_REL
    assert got["det_valid"].sum() > 0


def test_perturbed_fpn_weight_fails_first_at_its_stage(golden, tmp_path,
                                                       capsys):
    tree, im, _ = golden
    np.savez(tmp_path / "a.npz", **_port_dump(tree, im))
    perturbed = jax.tree.map(lambda x: x, tree)
    w = np.array(perturbed["fpn"]["fpn_res2"]["w"])
    w[..., 3] += 0.5
    perturbed["fpn"]["fpn_res2"]["w"] = w
    c = _port_dump(perturbed, im)
    with np.load(tmp_path / "a.npz") as a:
        for k in ("res2", "res5", "fpn_p3", "fpn_p6"):
            np.testing.assert_array_equal(a[k], c[k])
        assert np.abs(a["fpn_p2"] - c["fpn_p2"]).max() > 1e-3
    np.savez(tmp_path / "c.npz", **c)
    capsys.readouterr()
    assert golden_compare.diff_dumps(str(tmp_path / "a.npz"),
                                     str(tmp_path / "c.npz"), 1e-5) == 1
    out = capsys.readouterr().out
    assert "first failing stage = 'fpn_p2'" in out


@pytest.mark.parametrize("layout", ["nchw", "mismatched"])
def test_diff_dumps_nchw_auto_transpose(tmp_path, layout):
    x = np.random.RandomState(0).rand(1, 8, 10, 3).astype(np.float32)
    other = np.transpose(x, (0, 3, 1, 2)) if layout == "nchw" else \
        np.transpose(x, (0, 3, 2, 1))
    np.savez(tmp_path / "nhwc.npz", t=x)
    np.savez(tmp_path / "other.npz", t=other)
    assert golden_compare.diff_dumps(
        str(tmp_path / "nhwc.npz"), str(tmp_path / "other.npz"),
        rtol=1e-6) == (0 if layout == "nchw" else 1)


def test_golden_main_reads_pkl_and_image(golden, tmp_path):
    """main --pkl --image --device cpu: the tree written as a Detectron
    .pkl and the image as PPM give the in-process dump exactly; --diff of
    the two exits 0."""
    tree, im, _ = golden
    ref = _port_dump(tree, im)
    with open(tmp_path / "w.pkl", "wb") as f:
        import pickle
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f)
    image_io.write_ppm(str(tmp_path / "im.ppm"), im)
    (tmp_path / "tiny.yaml").write_text("MODEL:\n  NUM_CLASSES: 4\n")
    got = golden_compare.main([
        "--cfg", str(tmp_path / "tiny.yaml"), "--pkl",
        str(tmp_path / "w.pkl"), "--image", str(tmp_path / "im.ppm"),
        "--out", str(tmp_path / "b.npz"), "--device", "cpu",
        "--seed", "3"])
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.savez(tmp_path / "a.npz", **ref)
    assert golden_compare.main(["--diff", str(tmp_path / "a.npz"),
                                str(tmp_path / "b.npz")]) == 0


# ---------------------------------------------------------------------------
# trace_summary on a hand-built trace
# ---------------------------------------------------------------------------

HOST, DEV, STREAM = 100, 0, 7
K2 = ("void (anonymous namespace)::roi_window_pool_kernel<float, 8>"
      "(float const*, int const*)")
K1 = "(anonymous namespace)::nms_iou_mask_kernel(float const*, int, int)"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_f32_nhwckrsc"
DGRAD = "sm90_xmma_dgrad_implicit_gemm_bf16bf16_f32_nhwckrsc"
PKG = "/repo/detectron_tpu_torch/"


def _x(cat, name, tid, ts, dur, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _step(t, corr):
    """One step of the hand-built trace starting at t (us): thread 1 runs
    the driver frame, the ladder (its wrapper launches K2) and NMS (K1,
    then a sync); thread 2 runs the body (a conv); thread 3, autograd's,
    runs the conv's backward (no Python frame), which launches a dgrad
    kernel."""
    py = "python_function"
    return [
        _x("cpu_op", "aten::convolution", 2, t + 30, 80,
           **{"Sequence number": corr + 4}),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ConvolutionBackward0", 3, t + 800, 100,
           **{"Sequence number": corr + 4, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 3, t + 850, 10,
           correlation=corr + 3),
        _x("kernel", DGRAD, STREAM, t + 900, 30, pid=DEV,
           correlation=corr + 3, device=0),
        _x("user_annotation", "profile_net step", 1, t, 1000),
        _x(py, PKG + "tools/profile_net.py(60): step", 1, t, 1000),
        _x(py, PKG + "ops/windowed_roi.py(170): multilevel_roi_align_ladder",
           1, t + 100, 400),
        _x(py, PKG + "ops/cuda/roi_align_kernel.py(124): roi_window_pool",
           1, t + 150, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 1, t + 200, 10,
           correlation=corr),
        _x(py, PKG + "ops/nms.py(16): nms_batched_sorted_mask", 1, t + 600,
           200),
        _x("cuda_runtime", "cudaLaunchKernel", 1, t + 650, 10,
           correlation=corr + 1),
        _x("cuda_runtime", "cudaStreamSynchronize", 1, t + 700, 50),
        _x(py, PKG + "models/resnet.py(188): apply_body", 2, t, 400),
        _x(py, PKG + "models/layers.py(27): conv2d", 2, t + 20, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 2, t + 50, 10,
           correlation=corr + 2),
        _x("kernel", K2, STREAM, t + 300, 100, pid=DEV, correlation=corr,
           device=0),
        _x("kernel", K1, STREAM, t + 700, 40, pid=DEV,
           correlation=corr + 1, device=0),
        _x("kernel", CONV, STREAM, t + 100, 200, pid=DEV,
           correlation=corr + 2, device=0),
    ]


def test_trace_summary_on_a_hand_built_trace(tmp_path):
    events = [{"ph": "M", "name": "process_name", "pid": DEV,
               "args": {"name": "python3"}}]
    events += _step(0.0, 1) + _step(1000.0, 11)
    with gzip.open(tmp_path / "p.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    s = trace_summary.main([str(tmp_path), "--steps", "2"])
    assert s["device"]
    assert s["total"] == pytest.approx(0.74)
    assert dict(s["by_cat"]) == pytest.approx(
        {"port kernels": 0.28, "cuDNN convolution": 0.46})
    assert dict(s["by_stage"]) == pytest.approx(
        {"ops/windowed_roi.py": 0.2, "ops/nms.py": 0.08,
         "models/resnet.py": 0.4, "models/resnet.py (backward)": 0.06})
    # Host self time: the helper frames (ops/cuda/, models/layers.py)
    # count for their caller; the driver frame keeps what the stages
    # below it leave.
    assert dict(s["host_by_stage"]) == pytest.approx(
        {"(driver)": 0.8, "ops/windowed_roi.py": 0.8, "ops/nms.py": 0.4,
         "models/resnet.py": 0.8})
    assert dict(s["sync_by_stage"]) == pytest.approx({"ops/nms.py": 0.1})
    assert {k[0]: n for k, n in s["n_instances"].items()} == \
        {K2: 2, K1: 2, CONV: 2, DGRAD: 2}
    assert s["steps_seen"] == 2
    assert s["window_ms"] == pytest.approx(2.0)
    assert s["busy_ms"] == pytest.approx(0.74)
    assert s["idle_share"] == pytest.approx(0.63)
    assert dict(s["kernel_stages"][K2]) == {"ops/windowed_roi.py": 2}
    # --device picks whose time: cpu the host ops (two a step here);
    # card 1, which has no event in this trace, falls back to them too.
    for device in ("cpu", "cuda:1"):
        host = trace_summary.main([str(tmp_path), "--device", device])
        assert not host["device"]
        assert host["total"] == pytest.approx(0.36)
    assert trace_summary.main([str(tmp_path), "--device", "cuda:0"])[
        "total"] == pytest.approx(0.74)


def test_trace_summary_by_span_on_a_hand_built_trace(tmp_path):
    """The table by span from the program's own ranges, no stacks: thread
    1 runs a detection (body, proposals with an anchor sync, the RoI
    transform with a fix-up sync, each sync a cudaStreamSynchronize
    runtime call, the tail in dt.detect_graph itself),
    then the readback outside every span; thread 2 opens no span and
    launches a kernel while thread 1 is in dt.proposals; the device lane
    carries the spans' own device-side copies too (ignored). Exact device
    and host self ms, idle ms by the span open on the main thread (the
    idle times sum to the window's), syncs by the span open at them."""
    ua = "user_annotation"
    events = [
        _x(ua, "profile_net step", 1, 0, 1000),
        _x(ua, "dt.detect_graph", 1, 0, 900),
        _x(ua, "dt.body", 1, 10, 290),
        _x(ua, "dt.proposals", 1, 300, 200),
        _x("cuda_runtime", "cudaStreamSynchronize", 1, 350, 50),
        _x(ua, "dt.roi_xform", 1, 500, 200),
        _x("cuda_runtime", "cudaStreamSynchronize", 1, 600, 50),
        _x("gpu_user_annotation", "dt.detect_graph", STREAM, 50, 800,
           pid=DEV),
    ]
    for corr, (tid, launch, start, dur) in enumerate(
            [(1, 20, 50, 230), (1, 310, 320, 20), (1, 510, 520, 80),
             (1, 710, 720, 130), (2, 400, 410, 40)], 1):
        events += [_x("cuda_runtime", "cudaLaunchKernel", tid, launch, 5,
                      correlation=corr),
                   _x("kernel", CONV, STREAM, start, dur, pid=DEV,
                      correlation=corr, device=0)]
    with gzip.open(tmp_path / "p.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    s = trace_summary.main([str(tmp_path), "--steps", "1"])
    rows = s["by_span"]
    assert set(rows) == {"dt.detect_graph", "dt.body", "dt.proposals",
                         "dt.roi_xform", "(no span)"}

    def col(key):
        return {k: v[key] for k, v in rows.items() if v[key]}

    assert col("device_ms") == pytest.approx(
        {"dt.body": 0.23, "dt.proposals": 0.06, "dt.roi_xform": 0.08,
         "dt.detect_graph": 0.13})
    assert col("host_ms") == pytest.approx(
        {"dt.detect_graph": 0.21, "dt.body": 0.29, "dt.proposals": 0.2,
         "dt.roi_xform": 0.2})
    assert col("idle_ms") == pytest.approx(
        {"dt.detect_graph": 0.08, "dt.body": 0.06, "dt.proposals": 0.14,
         "dt.roi_xform": 0.12, "(no span)": 0.1})
    assert sum(col("idle_ms").values()) == pytest.approx(
        s["window_ms"] - s["busy_ms"])
    assert col("syncs") == {"dt.proposals": 1, "dt.roi_xform": 1}


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_profile_net_on_the_cpu_then_trace_summary(tmp_path, mode, capsys):
    port_config.reset_cfg()
    keys = TINY_SET if mode == "infer" else TRAIN_SET
    got = profile_net.main([
        "--device", "cpu", "--mode", mode, "--batch_size", "1", "--steps",
        "1", "--canvas", "64", "64", "--out", str(tmp_path), "--set"]
        + keys)
    assert got["trace"].endswith("profile_net_{}.trace.json.gz".format(mode))
    with open(str(tmp_path / "profile_net_{}.walls.json".format(mode))) as f:
        walls = json.load(f)
    assert walls["card"] == "device: cpu (no card)"
    assert len(walls["profiled_ms"]) == 1
    s = trace_summary.main([str(tmp_path), "--steps", "1", "--like",
                            "nonzero"])
    out = capsys.readouterr().out
    assert not s["device"] and s["idle_share"] is None
    assert "no device lane" in out and "no GB/s" in out
    assert s["total"] > 0
    for stage in ("models/resnet.py", "models/fpn.py", "ops/nms.py",
                  "ops/windowed_roi.py"):
        assert s["by_stage"][stage] > 0, stage
        assert s["host_by_stage"][stage] > 0, stage
    # The ladder's host syncs on the card are its torch.nonzero calls.
    assert any(k[0] == "aten::nonzero" and k[2] == "ops/windowed_roi.py"
               for k in s["by_op"])


def test_profile_net_without_stacks_then_trace_summary_by_span(tmp_path):
    """profile_net --no_stack --device cpu: no Python frame in the trace,
    so the table by stage has only "(no repo frame)", and the table by
    span ties the host ops to the program's spans: the body's, the
    proposals' and the ladder's; a CPU trace has no runtime sync call,
    so no span counts a sync."""
    port_config.reset_cfg()
    got = profile_net.main([
        "--device", "cpu", "--batch_size", "1", "--steps", "1", "--canvas",
        "64", "64", "--no_stack", "--out", str(tmp_path), "--set"]
        + TINY_SET)
    assert got["walls"]["stacks"] is False
    s = trace_summary.main([str(tmp_path), "--steps", "1"])
    assert set(s["by_stage"]) == {trace_summary.NO_FRAME}
    rows = s["by_span"]
    assert rows["dt.body"]["device_ms"] > 0
    assert rows["dt.proposals"]["device_ms"] > 0
    assert rows["dt.roi_xform"]["device_ms"] > 0
    assert not any(row["syncs"] for row in rows.values())


# ---------------------------------------------------------------------------
# roi_bench, stage_bench, multiscale_bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooled,rois,canvas", [
    (7, 60, (192, 256)), (14, 10, (192, 256)),
    # The full canvas: P4 is 84 wide, 36 past a 48-wide window, not a
    # multiple of the x alignment; the ladder's windows reach its last
    # columns (before the repair of window_params' x bound, 20 RoIs at
    # its right edge were 1.86 off the gather).
    (7, 1000, (832, 1344))])
def test_roi_bench_variants_agree(pooled, rois, canvas):
    port_config.reset_cfg()
    got = roi_bench.main([
        "--device", "cpu", "--batch", "2", "--rois", str(rois), "--pooled",
        str(pooled), "--canvas", str(canvas[0]), str(canvas[1]),
        "--channels", "8", "--dtype", "float32", "--iters", "1"])
    assert len(got) == 4
    ref = got["gather (exact, plain)"]["out"]
    assert ref.shape == (2, rois, pooled, pooled, 8)
    for name in ("ladder (K2 + K3 rungs + gather)",
                 "level sweep (K2 a level)"):
        assert got[name]["max_abs_diff"] <= 1e-5, name
        assert float((got[name]["out"] - ref).abs().max()) <= 1e-5
    assert got["dense top P5 (K2)"]["max_abs_diff"] is None
    assert got["dense top P5 (K2)"]["out"].shape == ref.shape


def test_stage_bench_prints_its_lines(capsys):
    port_config.reset_cfg()
    got = stage_bench.main(["--device", "cpu", "--batch_size", "1",
                            "--iters", "1", "--canvas", "64", "64",
                            "--set"] + TINY_SET)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (no card)"
    assert re.fullmatch(r"dispatch floor: \d+\.\d{3} ms", out[1])
    names = ["body only (s2d=False)", "features (body+FPN)", "+ rpn heads",
             "+ proposals", "+ box head", "+ decode/NMS (no mask)",
             "full detect"]
    for name, line in zip(names, out[2:9]):
        assert re.fullmatch(re.escape("{:<22}".format(name))
                            + r" +-?\d+\.\d{3} ms  \(\+-?\d+\.\d{3}\)",
                            line), line
    assert re.fullmatch(r"RPN NMS 1000->1000 x1 \(K1\): -?\d+\.\d{3} ms",
                        out[9])
    assert re.fullmatch(r"tail NMS 80x400->100 \(K1\): -?\d+\.\d{3} ms",
                        out[10])
    assert re.fullmatch(r"topk 0k->1000 x1: topk_chunked -?\d+\.\d{3} ms",
                        out[11])
    assert set(got) == set(names) | {"dispatch floor", "RPN NMS",
                                     "tail NMS", "topk"}
    assert port_config.cfg.MODEL.MASK_ON


def test_multiscale_bench_prints_json_rows(capsys):
    port_config.reset_cfg()
    rows = multiscale_bench.main([
        "--device", "cpu", "--cfg",
        str(REPO / "configs/baselines/e2e_mask_rcnn_R-50-FPN_1x.yaml"),
        "--scales", "64", "96", "--iters", "1", "--set",
        "TRAIN.SCALES", "(64, 96)", "TRAIN.MAX_SIZE", "128"] + TRAIN_KEYS
        + ["FAST_RCNN.MLP_HEAD_DIM", "32", "TPU.MAX_GT_BOXES", "8",
           "TPU.GT_MASK_SIZE", "28", "SOLVER.CLIP_GRADIENTS", "10"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (no card)"
    printed = [json.loads(line) for line in out[1:]]
    assert printed == rows and len(rows) == 3
    for row, s in zip(rows, (64, 96)):
        assert set(row) == {"scale", "canvas", "first_step_s",
                            "s_per_step", "img_per_s", "loss0"}
        assert row["scale"] == s and row["canvas"] == [s, 128]
        assert np.isfinite(row["loss0"]) and row["s_per_step"] > 0
    assert set(rows[-1]) == {"interleave_total_s", "scales"}
    assert port_config.cfg.TPU.REMAT_BODY


@pytest.mark.parametrize("tool,argv", [
    (golden_compare, ["--cfg", "x.yaml", "--out", "x.npz"]),
    (profile_net, []), (stage_bench, []), (roi_bench, []),
    (multiscale_bench, [])])
def test_tools_default_to_the_card(tool, argv):
    assert tool.parse_args(argv).device == "cuda"
    port_config.reset_cfg()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main(argv)
