"""What a run reads: BENCHMARK.json and the files it names.

Each piece is found by its name, so a later change adds a configuration,
a traffic mix, a cell or a per-layer metric by adding files and entries:

- the configuration: the file that its `configs` entry names;
- the traffic mix: benchmark/traffic/<traffic>.json;
- the cell's own data (the limits of its correctness check):
  benchmark/workloads/<cell>.json;
- a per-layer metric: benchmark/metrics/<metric>.py, a module with
  read(ctx) that returns a number, or None where it finds nothing to read;
  its entry lists the cells that read it (`workloads`).
"""

import importlib.util
import json


class Cell:
    """One workload entry of BENCHMARK.json with its files loaded."""

    def __init__(self, bench, name, root):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit("no workload {!r} in BENCHMARK.json (have {})"
                             .format(name, ", ".join(sorted(cells))))
        self.entry = cells[name]
        self.root = root
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / (
            self.entry["traffic"] + ".json"))
        self.data = load_json(root / "benchmark" / "workloads" / (
            name + ".json"))
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]
        self.compute_dtype = self.config["cfg"]["TPU.COMPUTE_DTYPE"]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root):
    """The Cell `name` of root/BENCHMARK.json."""
    return Cell(load_json(root / "BENCHMARK.json"), name, root)


def metric_reader(name, root):
    """read(ctx) of benchmark/metrics/<name>.py under `root`."""
    path = root / "benchmark" / "metrics" / (name + ".py")
    mod_name = "benchmark_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
