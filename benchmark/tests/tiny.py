"""A tiny copy of the benchmark for the CPU tests: the benchmark package and
BENCHMARK.json copied into a temporary root, plus a tiny configuration
(the R-50 FPN cell's published widths on a 128 x 160 canvas, few
proposals and detections), a traffic mix and a cell of their own."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny_fpn.infer_tiny"


def tiny_config(name="mask_r50fpn", dtype="bfloat16"):
    with open(REPO / "benchmark" / "configs" / (name + ".json")) as f:
        c = json.load(f)
    c["cfg"]["TPU.COMPUTE_DTYPE"] = dtype
    c["cfg"].update({"TEST.RPN_PRE_NMS_TOP_N": 200,
                     "TEST.RPN_POST_NMS_TOP_N": 60,
                     "TEST.DETECTIONS_PER_IM": 8})
    return c


TRAFFIC = {"mode": "infer", "batch": 2, "canvas": [128, 160],
           "im_info": [120.0, 150.0, 1.0], "pixel_std": 20.0, "image_seed": 5,
           "pool_batches": 1, "warmup_calls": 1, "check_images": 2,
           "trace_batches": 1, "trace_stack_batches": 1}
# Between the float32 program's readings (about 1e-5) and its bfloat16
# control's (det_gap 0.028, mask_gap 0.025, score_rank_gap 0.079) at this
# size; nms_iou_max is held to the configuration's TEST.NMS (with the
# float32 rounding of an IoU), score_order to 0.
LIMITS = {"det_gap": 0.002, "mask_gap": 0.002, "score_rank_gap": 0.002,
          "nms_iou_max": 0.500001, "score_order": 0.0}


def make_root(tmp, config="mask_r50fpn", dtype="bfloat16"):
    """A checkout at `tmp`: BENCHMARK.json and benchmark/, with the tiny
    configuration, traffic mix and cell added as new files and entries."""
    root = Path(tmp)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cfg_name, traffic = CELL.split(".")
    bench["configs"].append({"name": cfg_name, "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": cfg_name,
                               "traffic": traffic, "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    write(root / "BENCHMARK.json", bench)
    write(root / "benchmark" / "configs" / "tiny.json",
          tiny_config(config, dtype))
    write(root / "benchmark" / "traffic" / (traffic + ".json"), TRAFFIC)
    write(root / "benchmark" / "workloads" / (CELL + ".json"),
          {"limits": LIMITS})
    return root


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root, *extra, seed=7, trace=0):
    """The benchmark's command on the CPU from `root`, the program found
    through PYTHONPATH: (returncode, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", CELL,
           "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
           "--device", "cpu", *extra]
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=900, env=env)
    return p.returncode, p.stdout, p.stderr
