"""The port's remaining single-device entry points on the CPU, and the
JAX package's own tools (tools/infer_simple.py, tools/train_net.py, loaded
in this process) on the same inputs:

- tools/infer_simple.main (--device cpu) on the tiny cfg
  (test_torch_util.TINY_KEYS) over two 96 x 128 PPM images and files it
  cannot read (skipped): one png per image, drawn by matplotlib and, with
  matplotlib hidden, by OpenCV; each image's detections equal to the
  port's engine (test_engine.test_net, batch 1) on the same image,
  exactly. The JAX tool, its model replaced by the port's detect_graph
  outputs for the same images, skips the same files, sets the same
  MODEL.NUM_CLASSES (81, or 2 for --dataset keypoints_coco), turns the
  outputs into the same cls_boxes / cls_segms / cls_keyps and writes the
  same files with the same pixels, exactly. TPU.S2D_INPUT raises, as the
  JAX tool cannot run it.
- tools/train_net.main, the epoch trainer: the JAX tool's cfg (the
  --dataset rules, SOLVER.STEPS / MAX_ITER / LR_POLICY / WARM_UP_ITERS,
  BASE_LR, GAMMA, the batch) on the same arguments and roidb sizes, exact;
  at 2 epochs of 2 steps on test_torch_train_data's tiny set, params (and
  momentum) equal to train_net_step's after the same 4 steps on the same
  schedule, exactly in float32, --resume from model_epoch1 ending equal to
  the uninterrupted run (torch's deterministic algorithms, as
  test_torch_train_net's resume test); and against the JAX tool, its
  train step replaced by one that only counts steps and reads the lr
  (JAX's model is held against the port's by the other test files): the
  same steps, the same minibatches (images within 1e-3 and masks within
  1e-5, as test_torch_train_data's loader stream; the rest exactly), the
  same lr (within 1e-6),
  the same model_epoch{N} checkpoints at the same steps, and the same
  epoch to resume from. The multi-host flags and a --device list make
  the world the JAX tools' flags describe (one rank per device;
  tests/test_torch_multihost.py runs one).
"""

import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from detectron_tpu.core.config import cfg as jax_cfg
from detectron_tpu_torch.core import test_engine
from detectron_tpu_torch.core.config import cfg
from detectron_tpu_torch.parallel import launch
from detectron_tpu_torch.parallel import optimizer as opt
from detectron_tpu_torch.tools import infer_simple, train_net, train_net_step
from detectron_tpu_torch.utils import image_io
from detectron_tpu_torch.utils import net as net_utils
from test_torch_train_data import DATA_KEYS, write_train_set
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
PIXEL_MEANS = np.array([102.9801, 115.9465, 122.7717])
DEMO_KEYS = ["TEST.SCALE", "96", "TEST.MAX_SIZE", "128",
             "TEST.SCORE_THRESH", "0.0"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tool(monkeypatch, name, argv):
    """The repo-root tools/<name>.py, the JAX package's own tool, loaded in
    this process with sys.argv set to argv. Its _init_paths (which pins
    JAX's platform and turns on a compile cache) is replaced by an empty
    module; tools/train_net_step.py is registered for train_net's import
    of DATASET_MAP. All of it is undone at the end of the test."""
    monkeypatch.setitem(sys.modules, "_init_paths",
                        types.ModuleType("_init_paths"))
    monkeypatch.setitem(sys.modules, "train_net_step", _load(
        "train_net_step", REPO / "tools" / "train_net_step.py"))
    monkeypatch.setattr(sys, "argv", [name + ".py"] + list(argv))
    return _load("jax_tool_" + name, REPO / "tools" / (name + ".py"))


def _one_jax_device(monkeypatch):
    """The JAX tools on one device, as the port runs (the tests' JAX has 8
    virtual CPU devices)."""
    import jax

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:1])


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(96, 128), (128, 96)]):
        im = np.clip(np.round(PIXEL_MEANS + rng.randn(h, w, 3) * 20), 0, 255)
        image_io.write_ppm(str(d / "im{}.ppm".format(i)), im.astype(np.uint8))
    (d / "notes.txt").write_text("not an image\n")
    (d / "empty.yaml").write_text("{}\n")
    return d


def _hide_matplotlib(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else real(name, *a)))


def _infer(demo_dir, out, *flags, extra=()):
    set_cfgs(extra=DEMO_KEYS + list(extra))
    return infer_simple.main([
        "--cfg", str(demo_dir / "empty.yaml"), "--image_dir", str(demo_dir),
        "--output_dir", str(out), "--device", "cpu", "--thresh", "0.0",
        "--ext", "png"] + list(flags))


@pytest.mark.parametrize("backend", ["matplotlib", "opencv"])
def test_infer_simple_writes_a_png_per_image(demo_dir, tmp_path, backend,
                                             monkeypatch):
    import cv2

    if backend == "opencv":
        _hide_matplotlib(monkeypatch)
    res = _infer(demo_dir, tmp_path)
    assert [r["image"].rsplit("/", 1)[1] for r in res] == ["im0.ppm",
                                                           "im1.ppm"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["im0.png",
                                                          "im1.png"]
    for r in res:
        assert r["output"] == str(tmp_path / (r["image"].rsplit("/", 1)[1]
                                              [:-4] + ".png"))
        im = cv2.imread(r["output"])
        h, w = image_io.imread(r["image"]).shape[:2]
        assert im is not None and im.shape[2] == 3
        if backend == "opencv":
            assert im.shape[:2] == (h, w)
        assert sum(len(b) for b in r["cls_boxes"][1:]) > 0


def test_infer_simple_equals_the_engine(demo_dir, tmp_path):
    res = _infer(demo_dir, tmp_path)
    params = test_engine.initialize_model_from_cfg(None, device="cpu")
    C = cfg.MODEL.NUM_CLASSES
    assert C == 81
    entries = []
    for r in res:
        h, w = image_io.imread(r["image"]).shape[:2]
        entries.append({"image": r["image"], "height": h, "width": w})
    boxes, segms, _ = test_engine.test_net(params, entries, None,
                                           batch_size=1, device="cpu")
    for i, r in enumerate(res):
        for j in range(1, C):
            np.testing.assert_array_equal(r["cls_boxes"][j], boxes[j][i])
            assert r["cls_segms"][j] == segms[j][i]
        assert r["cls_keyps"] is None


@pytest.mark.parametrize("dataset,sets", [
    ("coco", []), ("keypoints_coco", ["MODEL.MASK_ON", "False"])])
def test_infer_simple_equals_the_jax_tool(demo_dir, tmp_path, monkeypatch,
                                          dataset, sets):
    import cv2
    import jax

    from detectron_tpu.core import test as jax_test
    from detectron_tpu.core import test_engine as jax_engine
    from detectron_tpu_torch.core import test as port_test

    outs = []
    port_detect = port_test.detect_graph

    def spy(*a):
        out = port_detect(*a)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return out

    monkeypatch.setattr(port_test, "detect_graph", spy)
    argv = ["--cfg", str(demo_dir / "empty.yaml"), "--image_dir",
            str(demo_dir), "--thresh", "0.0", "--ext", "png", "--dataset",
            dataset] + (["--set"] + sets if sets else [])
    set_cfgs(extra=DEMO_KEYS)
    res = infer_simple.main(argv + ["--output_dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    num_classes = cfg.MODEL.NUM_CLASSES

    # The JAX tool: no model of its own; detect_graph gives the port's
    # outputs for the same images, in the same order.
    feed = iter(outs)
    got = []
    to_results = jax_engine.device_outputs_to_image_results
    monkeypatch.setattr(jax_engine, "initialize_model_from_cfg",
                        lambda args: None)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(jax_test, "detect_graph",
                        lambda params, blob, im_info: next(feed))
    monkeypatch.setattr(jax_engine, "device_outputs_to_image_results",
                        lambda *a: got.append(to_results(*a)) or got[-1])
    set_cfgs(extra=DEMO_KEYS)
    _jax_tool(monkeypatch, "infer_simple", argv + [
        "--output_dir", str(tmp_path / "jax")]).main()

    assert next(feed, None) is None and len(got) == len(res) == 2
    assert jax_cfg.MODEL.NUM_CLASSES == num_classes == (
        2 if dataset == "keypoints_coco" else 81)
    for r, (boxes, segms, keyps) in zip(res, got):
        assert len(r["cls_boxes"]) == len(boxes)
        for a, b in zip(r["cls_boxes"], boxes):
            np.testing.assert_array_equal(a, b)
        assert r["cls_segms"] == segms and r["cls_keyps"] == keyps
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "im0.png", "im1.png"]
    for name in names:
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / name)),
            cv2.imread(str(tmp_path / "jax" / name)))


def test_infer_simple_keypoints_and_refusals(demo_dir, tmp_path,
                                             monkeypatch):
    set_cfgs(extra=DEMO_KEYS)
    res = infer_simple.main([
        "--cfg", str(demo_dir / "empty.yaml"), "--images",
        str(demo_dir / "im0.ppm"), "--output_dir", str(tmp_path),
        "--device", "cpu", "--dataset", "keypoints_coco", "--thresh", "2",
        "--set", "MODEL.MASK_ON", "False"])
    assert cfg.MODEL.NUM_CLASSES == 2 and len(res[0]["cls_boxes"]) == 2
    assert res[0]["output"] is None and not list(tmp_path.iterdir())
    with pytest.raises(NotImplementedError, match="S2D_INPUT"):
        _infer(demo_dir, tmp_path, extra=["TPU.S2D_INPUT", "True"])
    # Without matplotlib the OpenCV drawer cannot write the default pdf.
    _hide_matplotlib(monkeypatch)
    with pytest.raises(ValueError, match="--ext"):
        _infer(demo_dir, tmp_path, "--ext", "pdf")


# ---------------------------------------------------------------------------
# The epoch trainer
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


class _NoLoader:
    def __init__(self, *a, **k):
        raise _Stop


SCHEDULE_KEYS = ["SOLVER.LR_POLICY", "step", "SOLVER.STEPS",
                 "[0, 7]", "SOLVER.MAX_ITER", "9", "SOLVER.WARM_UP_ITERS",
                 "5", "SOLVER.BASE_LR", "0.01", "SOLVER.GAMMA", "0.5"]


def _cfg_of_the_schedule(c):
    return (tuple(c.SOLVER.STEPS), c.SOLVER.MAX_ITER, c.SOLVER.LR_POLICY,
            c.SOLVER.WARM_UP_ITERS, c.SOLVER.BASE_LR, c.SOLVER.GAMMA,
            tuple(c.TRAIN.DATASETS), c.TRAIN.IMS_PER_BATCH,
            c.MODEL.NUM_CLASSES)


@pytest.mark.parametrize("n_roidb,flags", [
    (5, ["--bs", "2", "--epochs", "2", "--lr_decay_epochs", "1",
         "--dataset", "voc2007"]),
    (35, ["--bs", "4", "--dataset", "coco2017", "--lr", "0.02"]),
    (235, ["--bs", "2", "--epochs", "12", "--lr_decay_epochs", "10", "8",
           "--dataset", "keypoints_coco2017", "--lr_decay_gamma", "0.3"]),
    (1, ["--bs", "2", "--epochs", "1", "--lr_decay_epochs", "3"])])
def test_epoch_schedule_matches_the_jax_tool(n_roidb, flags, tmp_path,
                                             monkeypatch):
    """Both tools up to their loader (which stops them), on a roidb of
    n_roidb entries: the same cfg."""
    import detectron_tpu.data.loader as jax_loader
    import detectron_tpu.data.roidb as jax_roidb
    import detectron_tpu.models.model_builder as jax_mb
    import detectron_tpu.parallel.train_step as jax_ts
    import detectron_tpu_torch.data.loader as port_loader
    import detectron_tpu_torch.data.roidb as port_roidb

    roidb = ([{}] * n_roidb, None, None)
    for mod in (jax_roidb, port_roidb):
        monkeypatch.setattr(mod, "combined_roidb_for_training",
                            lambda *a: roidb)
    for mod in (jax_loader, port_loader):
        monkeypatch.setattr(mod, "TrainLoader", _NoLoader)
    monkeypatch.setattr(jax_mb, "init_model", lambda key: {
        "w": np.zeros(2, np.float32)})
    monkeypatch.setattr(jax_ts, "make_pjit_train_step",
                        lambda mesh, donate=True: None)
    _one_jax_device(monkeypatch)

    set_cfgs(extra=TRAIN_KEYS + SCHEDULE_KEYS + [
        "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(_Stop):
        train_net.main(flags + ["--device", "cpu"])
    with pytest.raises(_Stop):
        _jax_tool(monkeypatch, "train_net", flags).main()
    assert _cfg_of_the_schedule(cfg) == _cfg_of_the_schedule(jax_cfg)
    assert cfg.SOLVER.LR_POLICY == "steps_with_decay"
    assert cfg.SOLVER.WARM_UP_ITERS == 0


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("epochs")
    write_train_set(root, contrast=4.0)
    return root


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


BS = 4   # 8 images, no flips: 2 steps an epoch


def _keys(root, out, extra=()):
    return TRAIN_KEYS + DATA_KEYS + [
        "DATA_DIR", str(root), "OUTPUT_DIR", str(out),
        "TRAIN.DATASETS", "('coco_2017_train',)", "TRAIN.USE_FLIPPED",
        "False", "MODEL.NUM_CLASSES", "4", "NUM_GPUS", "1",
        "TRAIN.IMS_PER_BATCH", str(BS), "SOLVER.BASE_LR", "0.002",
        "SOLVER.GAMMA", "0.1", "SOLVER.CLIP_GRADIENTS", "10"] + list(extra)


# As test_torch_train_data's loader stream: the port resizes images in
# numpy, the JAX loader with cv2; masks resized from RLE crops.
BATCH_ATOL = {"images": 1e-3, "gt_masks": 1e-5}
EPOCH_FLAGS = ["--bs", str(BS), "--nw", "2", "--epochs", "2",
               "--lr_decay_epochs", "1", "--disp_interval", "1"]


@pytest.fixture(scope="module")
def epoch_runs(train_root, tmp_path_factory):
    """The port's epoch trainer at 2 epochs of 2 steps, then resumed from
    its model_epoch1, under torch's deterministic algorithms; each run with
    the step index and the minibatch each of its steps was given."""
    import detectron_tpu_torch.data.loader as port_loader
    import detectron_tpu_torch.parallel.train_step as port_ts

    root = tmp_path_factory.mktemp("epoch_runs")
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for key, flags in (("full", []), ("resumed", None)):
            if flags is None:
                flags = ["--load_ckpt", runs["full"]["ckpts"][0], "--resume"]
            steps, batches = [], []
            real_step, real_next = port_ts.train_step, \
                port_loader.TrainLoader.__next__

            def step_spy(params, opt_state, batch, draws):
                steps.append(int(opt_state["step"]))
                return real_step(params, opt_state, batch, draws)

            def next_spy(self):
                batches.append(real_next(self))
                return batches[-1]

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(port_ts, "train_step", step_spy)
                mp.setattr(port_loader.TrainLoader, "__next__", next_spy)
                set_cfgs(mask_on=True, extra=_keys(train_root, root / key))
                run = train_net.main(EPOCH_FLAGS + ["--device", "cpu"] +
                                     flags)
            run.update(steps=steps, batches=batches)
            runs[key] = run
    finally:
        torch.use_deterministic_algorithms(False)
    return runs


def _tree(ckpt):
    step, payload = net_utils.load_ckpt(ckpt)
    return step, dict(opt.flatten(payload))


def test_epoch_trainer_equals_train_net_step(epoch_runs, train_root,
                                             tmp_path, deterministic):
    run, resumed = epoch_runs["full"], epoch_runs["resumed"]
    assert run["steps_per_epoch"] == 2 and run["start_epoch"] == 0
    assert [c.rsplit("/", 1)[1] for c in run["ckpts"]] == [
        "model_epoch1", "model_epoch2"]
    lrs = [s["lr"] for s in run["stats"]]
    assert lrs[:2] == [pytest.approx(0.002, rel=1e-6)] * 2
    assert lrs[2:] == [pytest.approx(0.0002, rel=1e-6)] * 2
    assert all(np.isfinite(list(s.values())).all() for s in run["stats"])

    set_cfgs(mask_on=True, extra=_keys(train_root, tmp_path / "s", [
        "SOLVER.LR_POLICY", "steps_with_decay", "SOLVER.WARM_UP_ITERS", "0",
        "SOLVER.STEPS", "[0, 2]", "SOLVER.MAX_ITER", "4"]))
    ref = train_net_step.main(["--bs", str(BS), "--nw", "2", "--device",
                               "cpu", "--disp_interval", "1"])
    assert [s["lr"] for s in ref["stats"]] == lrs
    step, got = _tree(run["ckpts"][1])
    ref_step, want = _tree(ref["ckpt"])
    assert step == ref_step == 4 and set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))

    assert resumed["start_epoch"] == 1 and len(resumed["stats"]) == 2
    assert [s["lr"] for s in resumed["stats"]] == lrs[2:]
    step, again = _tree(resumed["ckpts"][-1])
    assert step == 4
    for path, v in got.items():
        np.testing.assert_array_equal(again[path], v, err_msg=str(path))


def test_epoch_trainer_follows_the_jax_tool(epoch_runs, train_root, tmp_path,
                                            monkeypatch):
    import jax
    import jax.numpy as jnp

    import detectron_tpu.models.model_builder as jax_mb
    import detectron_tpu.parallel.optimizer as jax_opt
    import detectron_tpu.parallel.train_step as jax_ts
    from detectron_tpu.utils import net as jax_net

    seen = []

    def step_fn(params, opt_state, batch, key):
        lr = jax_opt.make_lr_fn()(opt_state["step"])
        seen.append((int(opt_state["step"]), jax.tree.map(np.asarray, batch),
                     float(lr)))
        return params, dict(opt_state, step=opt_state["step"] + 1), {
            "loss": jnp.float32(0.0), "lr": lr}

    monkeypatch.setattr(jax_mb, "init_model", lambda key: {
        "w": np.zeros(2, np.float32)})
    monkeypatch.setattr(jax_ts, "make_pjit_train_step",
                        lambda mesh, donate=True: step_fn)
    _one_jax_device(monkeypatch)
    ckpt_dir = tmp_path / "full" / "default" / "ckpt"
    for key, flags in (("full", []), ("resumed", [
            "--load_ckpt", str(ckpt_dir / "model_epoch1"), "--resume"])):
        port = epoch_runs[key]
        seen.clear()
        set_cfgs(mask_on=True, extra=_keys(train_root, tmp_path / key))
        _jax_tool(monkeypatch, "train_net", EPOCH_FLAGS + flags).main()
        assert [s for s, _, _ in seen] == port["steps"] == (
            [0, 1, 2, 3] if key == "full" else [2, 3])
        assert [lr for _, _, lr in seen] == pytest.approx(
            [s["lr"] for s in port["stats"]], rel=1e-6)
        for (_, want, _), got in zip(seen, port["batches"]):
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=0, err_msg=k,
                                           atol=BATCH_ATOL.get(k, 0))
        jax_ckpts = sorted(os.listdir(tmp_path / key / "default" / "ckpt"))
        assert jax_ckpts == [os.path.basename(c) for c in port["ckpts"]]
        for name, c in zip(jax_ckpts, port["ckpts"]):
            assert jax_net.load_ckpt(
                str(tmp_path / key / "default" / "ckpt" / name))[0] == \
                net_utils.load_ckpt(c)[0]
    assert [os.path.basename(c) for c in epoch_runs["full"]["ckpts"]] == [
        "model_epoch1", "model_epoch2"]
    assert [os.path.basename(c) for c in epoch_runs["resumed"]["ckpts"]] == [
        "model_epoch2"]


@pytest.mark.parametrize("flags", [
    ["--multihost"], ["--num_hosts", "2"], ["--host_rank", "0"],
    ["--device", "cuda:0,cuda:1"]])
def test_epoch_trainer_refuses_more_than_one_device(flags, monkeypatch):
    """The world the epoch trainer's flags make, as the JAX tools read
    them: --multihost alone joins the world torchrun describes (env://)
    and raises without it; --num_hosts or --host_rank alone leave one
    process on one device; a --device list starts one rank per device,
    each a device that exists (none of a cuda list on a CPU host)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(train_net, "_train",
                        lambda args, device, mesh: seen.append((device,
                                                                mesh)))
    monkeypatch.setattr(launch, "spawn_cli",
                        lambda *a, **k: seen.append((a, k)))
    if flags == ["--multihost"]:
        with pytest.raises(ValueError, match="env://"):
            train_net.main(["--device", "cpu"] + flags)
        assert not seen
    elif flags[0] == "--device":
        with pytest.raises(RuntimeError, match="is_available"):
            train_net.main(["--device", "cpu"] + flags)
        assert not seen
        assert train_net.main(["--bs", "2", "--device", "cpu,cpu"]) is None
        assert seen == [(("detectron_tpu_torch.tools.train_net",
                          ["--bs", "2"], ["cpu", "cpu"]),
                         {"backend": None})]
    else:
        train_net.main(["--device", "cpu"] + flags)
        (device, mesh), = seen
        assert str(device) == "cpu" and (mesh.n_data, mesh.n_model) == (1, 1)
        assert mesh.data_group is None
    assert not torch.distributed.is_initialized()
