"""The port's multi-process entry points on the CPU (gloo processes on
this host; every subprocess has its own time limit):

- tools/train_net_step in two processes, each started with
  --multihost_coordinator localhost:<free port> --num_hosts 2 --host_rank
  r (as tests/test_multihost.py starts the JAX tool), on
  test_torch_train_data's tiny training set (the mask_rcnn R-50-FPN yaml
  with test_torch_util's TINY_KEYS / TRAIN_KEYS sizes, a global batch of
  2): both join one world of 2 (`multi-host: process r/2`), their loader
  streams are seeded apart (RNG_SEED + rank), both log the same finite
  `json_stats:` (the global batch's; their own step times aside), only
  rank 0 writes checkpoints, and a --resume from rank 0's checkpoint
  continues at its step in both;
- tools/test_net with --device cpu,cpu (one rank per listed device, each
  running its 4 rows of every batch of 8) against the JAX engine's
  mesh-sharded test_net on tests/conftest.py's 8 virtual devices (batch
  8, P("data")), on 6 landscape images of test_torch_test_engine's noise
  dataset and its calibrated weights: rank 0's detections.pkl matched to
  JAX's per class and image with test_torch_test_engine's tolerances
  (box IoU > 0.99, |score diff| < 1e-4, masks equal on >= 99.9% of the
  image), both ranks logging their rows.
"""

import concurrent.futures
import json
import os
import pickle
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

import test_torch_test_engine as engine_tests
from detectron_tpu.core import config as jax_config
from detectron_tpu.core import test_engine as jax_engine
from detectron_tpu.data.json_dataset import JsonDataset as JaxJsonDataset
from detectron_tpu.utils import net as jax_net
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.models import init
from detectron_tpu_torch.parallel import launch
from detectron_tpu_torch.utils import net
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_train_data import DATA_KEYS, write_train_set
from test_torch_util import TINY_KEYS, TRAIN_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "baselines",
                    "e2e_mask_rcnn_R-50-FPN_1x.yaml")
PROC_S = 300


def _env():
    """The subprocesses' environment: loopback for gloo, one OpenMP thread
    a rank (the suite's other workers share the cores)."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_ranks(root, out, steps, extra=()):
    """train_net_step in two processes of one world (launch.spawn_cli:
    --multihost_coordinator localhost:<free port> --num_hosts 2
    --host_rank r); returns their logs."""
    keys = TINY_KEYS + TRAIN_KEYS + DATA_KEYS + [
        "DATA_DIR", str(root), "TRAIN.DATASETS", "('coco_2017_train',)",
        "MODEL.NUM_CLASSES", "4", "NUM_GPUS", "1", "TRAIN.IMS_PER_BATCH",
        "2", "SOLVER.BASE_LR", "0.002", "SOLVER.CLIP_GRADIENTS", "10",
        "SOLVER.MAX_ITER", str(steps)]
    out.mkdir()
    logs = [out / "rank{}.log".format(r) for r in range(2)]
    launch.spawn_cli(
        "detectron_tpu_torch.tools.train_net_step",
        lambda r: ["--cfg", YAML, "--bs", "2", "--nw", "1",
                   "--disp_interval", "1", "--ckpt_num_per_epoch", "1"]
        + list(extra) + ["--set"] + keys + [
            "OUTPUT_DIR", str(out / "out_rank{}".format(r))],
        ["cpu", "cpu"], logs=[str(p) for p in logs], timeout_s=PROC_S,
        env=_env())
    return [p.read_text() for p in logs]


def _stats(text):
    return [json.loads(x) for x in re.findall(r"json_stats: (\{.*\})", text)]


def _train_runs(root):
    """Two steps in a world of 2, then a --resume of one more step."""
    write_train_set(root, contrast=4.0)
    first = _run_ranks(root, root / "first", 2)
    ckpt = root / "first" / "out_rank0" / "e2e_mask_rcnn_R-50-FPN_1x" / \
        "ckpt" / "model_step2"
    resumed = _run_ranks(root, root / "resumed", 3,
                         ["--load_ckpt", str(ckpt), "--resume"])
    return {"root": root, "first": first, "resumed": resumed}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, sharded_eval):
    return sharded_eval["train"].result(timeout=2 * PROC_S)


def test_ranks_join_one_world(two_ranks):
    for r, text in enumerate(two_ranks["first"]):
        assert re.search(r"multi-host: process {}/2, 1 local / 2 global "
                         r"devices \(gloo, cpu\)".format(r), text), text


def test_loader_streams_are_seeded_apart(two_ranks):
    t0, t1 = two_ranks["first"]
    s0 = re.search(r"loader stream seed (\d+) \(host 0/2, local batch 1\)",
                   t0)
    s1 = re.search(r"loader stream seed (\d+) \(host 1/2, local batch 1\)",
                   t1)
    assert s0 and s1 and int(s1.group(1)) == int(s0.group(1)) + 1


def test_ranks_log_the_same_global_stats(two_ranks):
    for run in ("first", "resumed"):
        s0, s1 = [_stats(t) for t in two_ranks[run]]
        assert len(s0) == len(s1) == (2 if run == "first" else 1)
        for a, b in zip(s0, s1):
            mine = ("time", "eta")   # each rank's own step time
            assert {k: v for k, v in a.items() if k not in mine} == \
                {k: v for k, v in b.items() if k not in mine}
            assert all(np.isfinite(v) for k, v in a.items() if k != "eta")
            assert a["loss_mask"] > 0


def test_only_the_chief_writes_checkpoints(two_ranks):
    root = two_ranks["root"]
    # At the end (ckpt_interval, one epoch of 8 steps, is not reached).
    for run, names in (("first", ["model_step2"]),
                       ("resumed", ["model_step3"])):
        ck0 = sorted(p.name for p in (root / run / "out_rank0").rglob(
            "model_step*"))
        ck1 = list((root / run / "out_rank1").rglob("model_step*"))
        assert ck0 == names and not ck1, (run, ck0, ck1)


def test_resume_continues_at_the_checkpoint_step(two_ranks):
    for text in two_ranks["resumed"]:
        assert [s["iter"] for s in _stats(text)] == [2]
    step, payload = jax_net.load_ckpt(str(
        two_ranks["root"] / "resumed" / "out_rank0" /
        "e2e_mask_rcnn_R-50-FPN_1x" / "ckpt" / "model_step3"))
    assert step == 3 and int(payload["opt_state"]["step"]) == 3


# ---------------------------------------------------------------------------
# Sharded evaluation against the JAX engine's
# ---------------------------------------------------------------------------

LANDSCAPE = [(96, 128)] * 6


@pytest.fixture(scope="module")
def sharded_eval(tmp_path_factory):
    """The port's processes (the trainer's two runs, and test_net's) in
    threads while the JAX engine compiles."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    train = pool.submit(_train_runs, tmp_path_factory.mktemp("mh_train"))
    pool.shutdown(wait=False)
    root = tmp_path_factory.mktemp("mh_eval")
    sizes = engine_tests.SIZES
    engine_tests.SIZES = LANDSCAPE
    try:
        engine_tests._write_dataset(root)
    finally:
        engine_tests.SIZES = sizes
    engine_tests._set(port_config, root)
    ckpt = net.save_ckpt(str(root / "train"), 0, calibrate_detector_params(
        init.init_model(0), np.random.RandomState(0)))
    out = root / "port_out"
    port = {}

    def run_port():
        port["proc"] = subprocess.run(
            [sys.executable, "-m", "detectron_tpu_torch.tools.test_net",
             "--device", "cpu,cpu", "--load_ckpt", ckpt, "--batch_size",
             "8", "--output_dir", str(out), "--set"]
            + engine_tests.TINY_INFER_KEYS
            + ["MODEL.MASK_ON", "True", "DATA_DIR", str(root)],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=PROC_S)

    thread = threading.Thread(target=run_port)
    thread.start()
    engine_tests._set(jax_config, root)
    ds = JaxJsonDataset("coco_2017_val")
    ref = jax_engine.test_net(jax_net.load_ckpt_params(ckpt),
                              ds.get_roidb(gt=True), ds, batch_size=8)
    thread.join(PROC_S + 10)
    assert not thread.is_alive()
    proc = port["proc"]
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(out / "detections.pkl", "rb") as f:
        got = pickle.load(f)
    return {"ref": ref, "got": got, "log": proc.stdout + proc.stderr,
            "train": train}


def test_sharded_test_net_matches_jax(sharded_eval):
    ref_boxes, ref_segms, _ = sharded_eval["ref"]
    got = sharded_eval["got"]
    n = engine_tests._assert_results_match(
        got["all_boxes"], ref_boxes, got["all_segms"], ref_segms)
    assert n >= 6


def test_each_rank_runs_its_rows(sharded_eval):
    log = sharded_eval["log"]
    for r in range(2):
        assert re.search(r"6 images in [0-9.]+s \([0-9.]+ img/s end-to-end, "
                         r"rank {} of 2, its rows of each batch\)".format(r),
                         log), log[-3000:]
    # Rank 1 holds images 4-5 and two pad rows of the one batch of 8.
    assert re.search(r"test_net: 2/2 \|", log)
    assert len(re.findall(r"per batch \(1 batches\)", log)) == 2
