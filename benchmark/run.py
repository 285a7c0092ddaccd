"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It reads BENCHMARK.json and the files it
names (benchmark/spec.py), makes the configuration's weights and the
cell's images, in an order drawn from --seed, warms up the cell's own shapes, measures for
--seconds, checks the outputs of a sample against the plain reference,
and prints one JSON object as the last line of standard output: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics read from a traced stretch after the
window), device (and with --trace 1 busy_s, window_s and a breakdown),
and last the numbers compared, each beside its limit, which also end
standard error.

It exits non-zero and prints no result without a card (or with fewer
cards than the cell asks for), and if jax, jaxlib, flax or the JAX
package are loaded once the window has closed. --device cpu runs a cell
on the CPU, for the tests at a tiny size only: its numbers describe no
device.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "detectron_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (detectron_tpu_torch is not detectron_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None):
    args = parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout.
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    from benchmark import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log("error: the cell asks for {} card(s); torch.cuda.is_available"
                "() is {} and torch.cuda.device_count() is {}".format(
                    cell.chips, torch.cuda.is_available(),
                    torch.cuda.device_count()))
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(device)
        log("# card: " + card_line())
    else:
        device = torch.device("cpu")
        kind = "cpu"
    log("# cell {} seed {} seconds {} trace {}".format(
        args.workload, args.seed, args.seconds, args.trace))
    from benchmark import infer

    metrics, extra = infer.run(cell, args, T_START, device)
    found = forbidden_modules()
    if found:
        log("error: loaded in the measuring process: " + ", ".join(found))
        return 3
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    chosen = extra.get("per_layer", {}) if args.trace else {
        m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    result = {
        "correct": bool(extra["correct"]), "attempted": extra["attempted"],
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in chosen.items()},
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": extra["memory_peak_bytes"]},
    }
    if args.trace:
        result["device"]["busy_s"] = extra["busy_s"]
        result["device"]["window_s"] = extra["window_s"]
        result["breakdown"] = extra["breakdown"]
    result["checks"] = extra["checks"]
    if args.trace == 0:
        log("# end-to-end: " + json.dumps(metrics))
    for k, row in extra["checks"].items():
        log("check {} {!r} limit {!r}".format(k, row["value"], row["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
