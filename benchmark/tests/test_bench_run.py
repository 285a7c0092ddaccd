"""The harness end to end on the CPU at a tiny size: the result line's
keys, a cell and a per-layer metric added as new files alone, broken
answers, faults planted in the timed path and the control judged not
correct."""

import hashlib
import json

import pytest
import torch

from benchmark import control, faults, infer, spec, weights
from benchmark.tests import tiny

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
PROBE = "tiny_probe.infer"


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny float32 checkout with a throwaway per-layer metric added as a
    new file and a new BENCHMARK.json entry."""
    r = tiny.make_root(tmp_path_factory.mktemp("checkout"), dtype="float32")
    (r / "benchmark" / "metrics" / (PROBE + ".py")).write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": PROBE, "unit": "images", "better": "higher",
        "source": "program_counter", "layer": "tests",
        "moves": "infer_img_per_s", "workloads": [tiny.CELL]})
    tiny.write(r / "BENCHMARK.json", bench)
    return r


def last_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_result_line_has_the_contract_keys(root):
    rc, out, err = tiny.run(root)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert list(res) == TOP_KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if tiny.CELL in m.get("workloads", [tiny.CELL])}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(tiny.LIMITS)
    tail = err.strip().splitlines()[-2:]
    assert all(line.startswith("check ") for line in tail)


def test_added_cell_and_metric_run_without_edits(root):
    repo = digest(tiny.REPO / "benchmark")
    copied = digest(root / "benchmark")
    for rel, h in copied.items():
        if rel.parts[0] != "tests" and rel in repo:
            assert repo[rel] == h, rel
    rc, out, err = tiny.run(root, trace=1, seed=8)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert list(res) == TOP_KEYS + ["breakdown", "checks"]
    assert res["metrics"][PROBE]["value"] == tiny.TRAFFIC["batch"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", faults.NAMES)
def test_broken_timed_path_is_not_correct(root, fault):
    """The harness's run without its look for a card, with the timed path
    broken underneath (faults.py): answers altered where detect_graph
    returns them, half the batch left out, K1's NMS keeping every box,
    the top-100 taking the lowest scores."""
    cell = spec.load_cell(tiny.CELL, root)
    args = type("Args", (), {"seed": 9, "seconds": 1.0, "trace": 0})()
    with faults.planted(fault):
        _, extra = infer.run(cell, args, 0.0, torch.device("cpu"))
    assert extra["correct"] is False, extra["checks"]


def test_reference_restores_tf32_flags(root):
    """Set-up's calibration and the check run the reference without TF32
    and hand the program back the flags it had."""
    cell = spec.load_cell(tiny.CELL, root)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        weights.make_weights(cell.config, cell.traffic, torch.device("cpu"),
                             torch.float32)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_control_is_not_correct(root):
    cell = spec.load_cell(tiny.CELL, root)
    device = torch.device("cpu")
    r = control.readings(cell, control.setup(cell, device), 11, device,
                         control=True)
    limits = cell.data["limits"]
    assert control.check_mod.verdict(r["program"], limits)[0], r
    assert not control.check_mod.verdict(r["control"], limits)[0], r
