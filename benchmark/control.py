"""Readings for the limits of an inference cell's check, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... \\
        [--control] [--fault NAME ...] [--every-image] [--device cuda]

The cell's weights are made once. For each seed: the first batch of the
seed's pool, the program's detect_graph on it at the cell's batch size
(after a warm-up call), and the check's numbers (check.py) over as many
images of the batch, drawn from the seed, as a run compares. With
--control, the same numbers for the control in the program's place: the
plain reference computed one precision below the configuration's
(reference/model.py, CONTROL). With --fault, the same numbers for the
program with each named fault planted (faults.py). Prints one JSON line a
seed. With --every-image, first one line for each image of the cell's
pool (the same images in every run): the program's numbers on that image
alone. The benchmark's own runs never run this.
"""

import argparse
import json
import random
import sys
from pathlib import Path

import torch

from benchmark import check as check_mod
from benchmark import faults as faults_mod
from benchmark import infer
from benchmark import spec
from benchmark.reference.model import CONTROL, Precision
from benchmark.weights import make_weights

ROOT = Path(__file__).resolve().parents[1]


def sample_of(seed, B, n):
    return sorted(random.Random(seed).sample(range(B), n))


def setup(cell, device):
    """Configures the program and makes the cell's weights."""
    infer.configure_program(cell.config["cfg"])
    return make_weights(cell.config, cell.traffic, device,
                        infer.DTYPES[cell.compute_dtype])


def program_samples(cell, params, images, picks):
    """The program's outputs of images[picks], run on the whole batch."""
    from detectron_tpu_torch.core import test as test_ops

    B = images.shape[0]
    im_info = torch.tensor([cell.traffic["im_info"]] * B,
                           device=images.device)
    with torch.no_grad():
        test_ops.detect_graph(params, images, im_info)
        out = test_ops.detect_graph(params, images, im_info)
    return [(images[j], cell.traffic["im_info"],
             {k: out[k][j].cpu() for k in infer.OUT_KEYS}) for j in picks]


def readings(cell, params, seed, device, control=False, faults=()):
    """{"seed", "program"[, "control"][, <fault>...]: numbers} of one
    seed."""
    tr = cell.traffic
    images = infer.make_pool(tr, seed, device,
                             infer.DTYPES[cell.compute_dtype])[0]
    picks = sample_of(seed, tr["batch"], tr["check_images"])
    samples = program_samples(cell, params, images, picks)
    result = {"seed": seed, "program": check_mod.check(
        cell.config, params, samples, device)}
    for name in faults:
        with faults_mod.planted(name):
            broken = program_samples(cell, params, images, picks)
        result[name] = check_mod.check(cell.config, params, broken, device)
    if control:
        prec = Precision(CONTROL[cell.compute_dtype])
        ctrl = []
        for img, info, _ in samples:
            out = check_mod.reference_outputs(cell.config, params, img, info,
                                              prec)
            ctrl.append((img, info, {k: v.cpu() for k, v in out.items()}))
        result["control"] = check_mod.check(cell.config, params, ctrl, device)
    return result


def every_image(cell, params, device):
    """The check's numbers of each image of the cell's pool alone: every
    image that any seed's run can sample. Yields (image index, numbers)."""
    tr = cell.traffic
    pool = infer.make_pool(tr, 0, device, infer.DTYPES[cell.compute_dtype])
    B = tr["batch"]
    for b, images in enumerate(pool):
        for j, sample in enumerate(program_samples(cell, params, images,
                                                   range(B))):
            yield b * B + j, check_mod.check(cell.config, params, [sample],
                                             device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=())
    p.add_argument("--every-image", action="store_true",
                   help="print the numbers of each image of the pool")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", nargs="*", default=(),
                   choices=faults_mod.NAMES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device(args.device)
    params = setup(cell, device)
    if args.every_image:
        for i, numbers in every_image(cell, params, device):
            print(json.dumps({"image": i, "program": numbers}), flush=True)
    for seed in args.seeds:
        print(json.dumps(readings(cell, params, seed, device, args.control,
                                  args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
