"""host_syncs.infer on the CPU at a tiny size: the program's sync
counters read in a traced run's result line (a CPU run counts the sites
that wait for the device on a card), and nothing read from a program
without them."""

import json
import sys

from benchmark import spec
from benchmark.tests import tiny

METRIC = "host_syncs.infer"


def test_traced_tiny_run_reads_host_syncs(tmp_path):
    root = tiny.make_root(tmp_path, dtype="float32")
    rc, out, err = tiny.run(root, trace=1, seed=2147483701)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    got = res["metrics"][METRIC]
    assert got["unit"] == "syncs/batch"
    # The tiny FPN's anchor copies (5) and the two ladder calls' host
    # geometry copies and nonzero reads, at least.
    assert got["value"] >= 29


def test_reads_nothing_without_the_counters(monkeypatch):
    """A program whose detect_graph counts calls reads a number; one
    without the tracing module (the module cannot be imported) reads
    None."""
    from detectron_tpu_torch import utils
    from detectron_tpu_torch.utils import tracing

    read = spec.metric_reader(METRIC, tiny.REPO)
    tracing.count("call.detect_graph")
    tracing.sync("a.site")
    assert read(None) > 0
    monkeypatch.setitem(sys.modules, "detectron_tpu_torch.utils.tracing",
                        None)
    monkeypatch.delattr(utils, "tracing")
    assert read(None) is None
