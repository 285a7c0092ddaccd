"""Cell mask_r50fpn.infer_b64 for a short window on the card; skips where
there is none (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.mark.cuda
def test_first_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mask_r50fpn.infer_b64", "--seed", "2718281828", "--seconds", "5",
         "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu"
    assert res["correct"] is True, res["checks"]
