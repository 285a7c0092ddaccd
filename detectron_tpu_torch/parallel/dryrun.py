"""One full training step on a data or data x model mesh of local
processes (the port's twin of __graft_entry__.dryrun_multichip), and the
rank program behind it, which the tests and chip_smoke.py also drive.

    python -m detectron_tpu_torch.parallel.dryrun N \
        [--device cuda|cuda:0|cpu] [--backend gloo|nccl]

dryrun_multichip(n): n processes on this host, one per device: rank r
on cuda:r by default (NCCL; without a GPU it raises), every rank on the
one device named otherwise (gloo on the CPU, or --backend gloo for
ranks that share a card); below 4 a 1-D data mesh of n, at 4 and above
(even) a 2-D mesh of n / 2 data x 2 model with the box head's fc6 / fc7
split on the model axis. The cfg and the batch are the JAX twin's (__graft_entry__.py:16-36,
:102-121): Mask R-CNN R-50-FPN at its widths, 128 x 128 images, two gt
boxes with masks each, one image per data index. The weights are
models/init.py's numpy init from seed 0 and the sampling draws come from a
CPU generator seeded 1 (the JAX twin's PRNGKey(0) / PRNGKey(1) have no
torch counterpart). Prints `dryrun_multichip OK: n_devices=... mesh=...
loss=...` as the twin does.
"""

import argparse
import copy
import time

import numpy as np
import torch

# __graft_entry__._tiny_cfg's keys after the mask_rcnn_r50_fpn preset.
TINY_KEYS = [
    "TRAIN.BATCH_SIZE_PER_IM", "64",
    "TRAIN.RPN_PRE_NMS_TOP_N", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.RPN_BATCH_SIZE_PER_IM", "64",
    "TEST.RPN_PRE_NMS_TOP_N", "256",
    "TEST.RPN_POST_NMS_TOP_N", "64",
    "TEST.DETECTIONS_PER_IM", "20",
    "TPU.NMS_TILE_SIZE", "64",
    "TPU.MAX_GT_BOXES", "8",
]
CANVAS = (128, 128)


def tiny_cfg(batch, mask_on=True):
    """The port's cfg set as __graft_entry__._tiny_cfg sets the JAX
    package's."""
    from detectron_tpu_torch.core import config
    from detectron_tpu_torch.core.configs_presets import mask_rcnn_r50_fpn

    config.reset_cfg()
    mask_rcnn_r50_fpn()
    config.merge_cfg_from_list(["MODEL.MASK_ON", str(mask_on),
                                "TRAIN.IMS_PER_BATCH", str(batch)]
                               + TINY_KEYS)
    config.assert_and_infer_cfg(make_immutable=False)


def cfg_snapshot():
    """A picklable copy of the port's cfg (what a rank process sets)."""
    from detectron_tpu_torch.core.config import cfg

    return copy.deepcopy(dict(cfg))


def set_cfg(snapshot):
    from detectron_tpu_torch.core import config

    config.reset_cfg()
    for k, v in snapshot.items():
        config.cfg[k] = copy.deepcopy(v)
    config.assert_and_infer_cfg(make_immutable=False)


def dryrun_batch(B):
    """__graft_entry__.dryrun_multichip's batch of B 128 x 128 images, as
    numpy arrays."""
    Hc, Wc = CANVAS
    G = 8
    rng = np.random.RandomState(0)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_boxes[:, 0] = [8, 8, 60, 60]
    gt_boxes[:, 1] = [30, 30, 100, 100]
    gt_classes = np.zeros((B, G), np.int32)
    gt_classes[:, :2] = [1, 2]
    gt_valid = np.zeros((B, G), bool)
    gt_valid[:, :2] = True
    masks = np.zeros((B, G, 28, 28), np.float32)
    masks[:, :, 7:21, 7:21] = 1.0
    return {
        "images": rng.randn(B, Hc, Wc, 3).astype(np.float32),
        "im_info": np.asarray([[Hc, Wc, 1.0]] * B, np.float32),
        "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_valid": gt_valid,
        "crowd_boxes": np.zeros((B, 2, 4), np.float32),
        "crowd_valid": np.zeros((B, 2), bool),
        "gt_masks": masks,
    }


def global_draws(seed, batch):
    """make_draws of the whole (global) batch from a CPU generator seeded
    `seed`, as numpy arrays."""
    from detectron_tpu_torch.models import train_graph

    draws = train_graph.make_draws(
        torch.Generator().manual_seed(seed), batch["images"].shape[0],
        tuple(batch["images"].shape[1:3]), batch["gt_boxes"].shape[1], "cpu")
    return {k: v.numpy() for k, v in draws.items()}


def _to_device(arrays, rows, device):
    from detectron_tpu_torch.parallel import mesh as mesh_mod

    rank, n = rows
    return {k: torch.as_tensor(v).to(device)
            for k, v in mesh_mod.shard_batch(arrays, rank, n).items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launch_counts():
    from detectron_tpu_torch.ops.cuda import nms_kernel, roi_align_kernel

    return {"nms_keep_mask": nms_kernel.nms_keep_mask,
            "roi_window_pool": roi_align_kernel.roi_window_pool,
            "roi_window_pool_seg": roi_align_kernel.roi_window_pool_seg,
            "roi_window_accum": roi_align_kernel.roi_window_accum}


def run_rank(device, spec):
    """One rank of a mesh training run. spec: "cfg" (cfg_snapshot()),
    "tree" (numpy params, JAX layout, full), "batch" and "draws" (the
    global ones, numpy; lists of them, one per microbatch, for gradient
    accumulation), "mesh" ((n_data, n_model)), and optionally "steps"
    (default 1: the first is the compared one, the rest are timed) and
    "cudnn" (False runs convolutions without cuDNN, as a comparison with a
    one-process step needs). Returns this rank's stats of each step (floats), the launches of the
    port's kernels over the steps, the host ms of each step after the
    first, and on rank 0 the full params after the first step (numpy, JAX
    layout) and, on a mesh with a model axis, "roundtrip": whether
    gather_params of the initial shards gives the tree back exactly."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.parallel import mesh as mesh_mod
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.parallel import train_step as ts

    set_cfg(spec["cfg"])
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.enabled = spec.get("cudnn", True)
    mesh = mesh_mod.make_mesh_2d(*spec["mesh"])
    rows = (mesh.data_index, mesh.n_data)
    full = bridge.to_torch(spec["tree"], device, torch.float32)
    params = mesh_mod.shard_params(full, mesh)
    out = {"rank": mesh.rank, "stats": [], "step_ms": [], "params": None}
    if mesh.model_group is not None:
        back = mesh_mod.gather_params(params, mesh)
        out["roundtrip"] = None if back is None else all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                opt.flatten(back), opt.flatten(full)))
    del full
    opt_state = opt.init_opt_state(params)
    accum = isinstance(spec["batch"], (list, tuple))
    if accum:
        batch = [_to_device(b, rows, device) for b in spec["batch"]]
        draws = [_to_device(d, rows, device) for d in spec["draws"]]
    else:
        batch = _to_device(spec["batch"], rows, device)
        draws = _to_device(spec["draws"], rows, device)
    wrappers = _launch_counts()
    for fn in wrappers.values():
        fn.launches = 0
    for i in range(spec.get("steps", 1)):
        _sync(device)
        t0 = time.perf_counter()
        step = ts.train_step_accum if accum else ts.train_step
        params, opt_state, stats = step(params, opt_state, batch, draws,
                                        mesh)
        out["stats"].append({k: float(v) for k, v in stats.items()})
        _sync(device)
        if i:
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        else:
            first = mesh_mod.gather_params(params, mesh)
            if first is not None:
                out["params"] = bridge.to_jax_layout(first)
            del first
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    return out


def mesh_shape(n_devices):
    """The JAX twin's layout: (n, 1) below 4 devices, (n / 2, 2) at 4
    and above when n is even."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def ok_line(n_devices, results):
    """The JAX twin's line for the ranks' run_rank results on a mesh of
    n_devices (mesh_shape); raises if the first step's loss is not
    finite."""
    n_data, n_model = mesh_shape(n_devices)
    loss = results[0]["stats"][0]["loss"]
    if not np.isfinite(loss):
        raise AssertionError("train step produced non-finite loss")
    return "dryrun_multichip OK: n_devices={} mesh={} loss={:.4f}".format(
        n_devices, "2d(data={},model={})".format(n_data, n_model)
        if n_model > 1 else "1d(data)", loss)


def dryrun_multichip(n_devices, device="cuda", backend=None, timeout_s=600,
                     cudnn=True):
    """One training step on n_devices local processes (rank r on cuda:r
    where device is "cuda", else every rank on `device`); prints the OK
    line and returns the ranks' run_rank results (rank 0's with the full
    params after the step). cudnn=False runs the ranks' convolutions
    without cuDNN, image by image, so that a rank's images take the values
    they take in a larger batch and the step can be held against the
    one-process step."""
    from detectron_tpu_torch.models import init
    from detectron_tpu_torch.parallel import launch
    from detectron_tpu_torch.utils.device import check_device

    devices = ["cuda:{}".format(r) for r in range(n_devices)] \
        if device == "cuda" else [device] * n_devices
    for d in devices:
        check_device(d)
    n_data, n_model = mesh_shape(n_devices)
    tiny_cfg(batch=n_data)
    batch = dryrun_batch(n_data)
    spec = {"cfg": cfg_snapshot(), "tree": init.init_model(0),
            "batch": batch, "draws": global_draws(1, batch),
            "mesh": (n_data, n_model), "cudnn": cudnn}
    results = launch.spawn("detectron_tpu_torch.parallel.dryrun:run_rank",
                           devices, (spec,), backend=backend,
                           timeout_s=timeout_s)
    print(ok_line(n_devices, results))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device, a.backend)
