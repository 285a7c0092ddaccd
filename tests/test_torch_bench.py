"""The twin of bench.py (detectron_tpu_torch/tools/bench.py) and its spread
runner (tools/bench_spread.py) on the CPU, at TINY_KEYS through BENCH_SET,
a 128 x 128 canvas, batch 2, one window of one call.

- main() prints exactly one line on stdout, a JSON record with bench.py's
  metric name for its mode and the keys metric, value, unit, median, mfu,
  tflops_per_image and device; the FLOP note and the "# run" line (the
  window rates, the launches over the timed calls only) go to stderr. A
  fresh process (bench_spread.run_once) prints the same single line.
- Its inputs are bench.py's: the calibrated tree and the images equal, leaf
  by leaf and bit for bit, what bench.py builds from the same numpy
  init_model(0) tree with the JAX package's calibrate_detector_params on
  its own RandomState(0) and the same image draw after it (and with
  TPU.S2D_INPUT, JAX's utils.blob.space_to_depth); the bf16 device images
  and their + 1 twin equal JAX's bf16 casts. The training batch equals the
  JAX package's synthetic_train_batch from RandomState(0), bench.py's draw
  order.
- The FLOP count (FlopCounterMode) per image is the same at batch 1 and 2,
  and smaller without the mask head.
- The default --device cuda raises without a GPU; BENCH_AUTO_LAYOUT, which
  has no counterpart in eager PyTorch, raises when set.

The detections that the timed calls produce are not compared with JAX
here: tests/test_torch_detect.py::test_detect_graph_end_to_end holds
detect_graph against the JAX package's on calibrated params already.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.utils import blob as jax_blob
from detectron_tpu.utils import synthetic as jax_synthetic
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.models import init as init_mod
from detectron_tpu_torch.ops import cuda as cuda_ops
from detectron_tpu_torch.tools import bench, bench_spread
from test_torch_util import TINY_KEYS, set_cfgs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CANVAS = (128, 128)
ARGS = ["--device", "cpu", "--canvas", *map(str, CANVAS), "--iters", "1"]
RECORD_KEYS = {"metric", "value", "unit", "median", "mfu",
               "tflops_per_image", "device"}
BF16 = ["TPU.COMPUTE_DTYPE", "bfloat16"]


@pytest.fixture
def bench_env(monkeypatch):
    """The BENCH_* variables the tests run the twin under, and no other."""
    for k in ("BENCH_MODE", "BENCH_SET", "BENCH_BS", "BENCH_CALIB",
              "BENCH_WINDOWS", "BENCH_TRAIN_BS", "BENCH_PEAK_FLOPS",
              "BENCH_AUTO_LAYOUT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_SET", " ".join(TINY_KEYS))
    monkeypatch.setenv("BENCH_BS", "2")
    monkeypatch.setenv("BENCH_TRAIN_BS", "2")
    monkeypatch.setenv("BENCH_WINDOWS", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    return monkeypatch


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")


def _check_record(rec, mode):
    assert set(rec) == RECORD_KEYS
    metric = bench.TRAIN_METRIC if mode == "train" else bench.INFER_METRIC
    assert rec["metric"] == metric
    assert '"{}"'.format(metric) in (ROOT / "bench.py").read_text()
    assert rec["unit"] == "images/sec/chip" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["median"] > 0
    assert rec["tflops_per_image"] > 0 and rec["mfu"] is None


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_stdout_is_one_json_record(bench_env, capsys, mode):
    if mode == "train":
        bench_env.setenv("BENCH_MODE", "train")
        bench_env.setattr(bench, "TRAIN_WARMUP", 2)   # 50 on the card
    rec = bench.main(ARGS)
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    _check_record(rec, mode)
    assert "# flops: " in err
    run = bench.parse_stderr(err)
    assert len(run["windows"]) == 1
    assert round(run["windows"][0], 2) == rec["value"]
    assert run["card"] == "device: cpu (no card)"
    assert run["peak_gib"] is None and run["calls"] == 1
    assert set(run["timed"]) == set(cuda_ops.wrappers())
    if mode == "train":
        assert cfg.SOLVER.CLIP_GRADIENTS == 10.0
        assert err.count("# warm-up steps ms: ") == 1


def test_fresh_process_prints_one_line(bench_env):
    """bench_spread's runner: the twin in its own process, its stdout one
    JSON record, its stderr's window rates read back."""
    args = bench_spread.parse_args(ARGS)
    row = bench_spread.run_once(args, 2)
    assert row["rc"] == 0, row.get("error")
    _check_record(row["record"], "infer")
    assert len(row["windows"]) == 1 and row["card"] == "device: cpu (no card)"
    s = bench_spread.summary([row, dict(row, record=dict(
        row["record"], value=2 * row["record"]["value"]))])
    assert s["runs"] == 2 and s["failed"] == 0
    assert s["value_max"] == 2 * s["value_min"]
    assert s["process_spread"] == pytest.approx(
        s["value_min"] / s["value_median"])


def test_window_counts_only_its_calls(monkeypatch):
    """A window issues two untimed calls before its clock starts; the
    launches it adds up are those of its n_iters timed calls."""
    nms = cuda_ops.wrappers()["nms_keep_mask"]
    monkeypatch.setattr(nms, "launches", 0)

    def fn(images):
        nms.launches += 1
        return {"scores": images}

    timed = dict.fromkeys(cuda_ops.wrappers(), 0)
    for _ in range(2):
        assert bench._window(fn, torch.zeros(1), torch.ones(1), 3,
                             timed) > 0
    assert timed["nms_keep_mask"] == 6
    assert sum(timed.values()) == 6


def test_parse_stderr():
    run = {"card": "card: NVIDIA H100 80GB HBM3, 700.00 W",
           "windows": [10.5, 12.0], "peak_gib": 3.25,
           "peak_reserved_gib": 4.0, "timed": {"nms_keep_mask": 24},
           "calls": 24, "per_call": {"nms_keep_mask": 1}}
    text = ("# card: NVIDIA H100 80GB HBM3, 700.00 W\n# flops: none\n"
            + bench.RUN_PREFIX + json.dumps(run) + "\n")
    assert bench.parse_stderr(text) == run
    for bad in ("# flops: none\n", text + text):
        with pytest.raises(ValueError, match="run"):
            bench.parse_stderr(bad)


def _jax_calibrated(B, rng_seed=0):
    """bench.py:80-103 on the port's numpy init tree: the JAX package's
    calibration from its own RandomState(0), then the image draw."""
    tree = init_mod.init_model(0)
    rng = np.random.RandomState(rng_seed)
    tree = jax_synthetic.calibrate_detector_params(tree, rng)
    images = rng.randn(B, *CANVAS, 3).astype(np.float32) * 20.0
    if cfg.TPU.S2D_INPUT:
        images = jax_blob.space_to_depth(images)
    return tree, images


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("s2d", [False, True])
def test_inputs_equal_bench_py(s2d):
    set_cfgs(extra=BF16 + ["TPU.S2D_INPUT", str(s2d)])
    tree, images = bench.inference_arrays(2, CANVAS)
    ref_tree, ref_images = _jax_calibrated(2)
    got, ref = list(_leaves(tree)), list(_leaves(ref_tree))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert images.shape == ((2, 68, 68, 12) if s2d else (2, *CANVAS, 3))
    assert np.array_equal(images, ref_images)

    _, dev_images, dev_images2, im_info = bench.inference_inputs(
        2, CANVAS, torch.device("cpu"))
    ref_bf16 = jnp.asarray(ref_images, dtype=jnp.bfloat16)
    assert dev_images.dtype == torch.bfloat16
    for got_t, ref_j in ((dev_images, ref_bf16), (dev_images2,
                                                  ref_bf16 + 1.0)):
        assert np.array_equal(got_t.float().numpy(),
                              np.asarray(ref_j.astype(jnp.float32)))
    assert np.array_equal(im_info.numpy(),
                          np.array([[128.0, 128.0, 1.6]] * 2, np.float32))


def test_train_batch_equals_bench_py():
    set_cfgs(extra=BF16)
    _, opt_state, batch = bench.train_inputs(2, CANVAS, torch.device("cpu"))
    ref = jax_synthetic.synthetic_train_batch(2, *CANVAS,
                                              np.random.RandomState(0))
    assert set(batch) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(batch[k].numpy(), np.asarray(v)), k
    assert opt_state["step"] == 0


def test_flops_per_image():
    """The same per image at batch 1 and 2 (every counted operation is
    per image), and smaller without the mask head."""
    def per_image(B):
        params, images, _, im_info = bench.inference_inputs(
            B, CANVAS, torch.device("cpu"))
        from detectron_tpu_torch.core import test as test_ops

        flops, _ = bench.step_flops(
            lambda: test_ops.detect_graph(params, images, im_info))
        return flops / B

    set_cfgs(extra=BF16)
    one, two = per_image(1), per_image(2)
    assert one > 0 and one == two
    set_cfgs(mask_on=False, extra=BF16)
    assert 0 < per_image(2) < one


def test_default_device_raises_without_a_card(bench_env, no_card, capsys):
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_auto_layout_raises(bench_env, capsys):
    bench_env.setenv("BENCH_AUTO_LAYOUT", "0")
    with pytest.raises(RuntimeError, match="BENCH_AUTO_LAYOUT"):
        bench.main(ARGS)
    assert capsys.readouterr().out == ""
