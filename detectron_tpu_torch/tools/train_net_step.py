"""Train a Generalized R-CNN step by step on one device or a data-parallel
world of them (the port's twin of tools/train_net_step.py:28-251).

    python -m detectron_tpu_torch.tools.train_net_step --dataset coco2017 \
        --cfg CFG.yaml [--bs N] [--nw N] [--iter_size N] [--lr X] \
        [--lr_decay_gamma X] [--load_detectron PKL | --load_ckpt DIR \
        [--resume] [--start_step N]] [--use_tfboard] [--no_save] \
        [--ckpt_num_per_epoch N] [--disp_interval N] [--set KEY VALUE ...] \
        [--device cuda|cpu|cuda:0,cuda:1,...] [--deterministic] \
        [--multihost | --multihost_coordinator HOST:PORT --num_hosts N \
         --host_rank R] [--dist_backend nccl|gloo]

The JAX tool's flags, with its meaning, plus --device (default cuda; cpu
only where asked for, and cuda raises without a GPU) and --deterministic:
the steps run under torch.use_deterministic_algorithms (the RoIAlign
backward takes K4's atomic-free variant), so that a --resume'd run follows
an uninterrupted one bit for bit, as the JAX tool's runs do; on the card
cuBLAS then needs CUBLAS_WORKSPACE_CONFIG=:4096:8 in the environment
before the process starts (torch raises without it). The pieces:

- the roidb of cfg.TRAIN.DATASETS (data/roidb.py), with
  TRAIN.PROPOSAL_FILES in Fast R-CNN mode (RPN.RPN_ON off);
- the linear-scaling rule for lr, MAX_ITER and STEPS when the global
  batch (--bs times --iter_size) differs from NUM_GPUS x
  TRAIN.IMS_PER_BATCH;
- weights: the numpy init from RNG_SEED, then a Detectron .pkl
  (--load_detectron) or the ImageNet body
  (MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS), then --load_ckpt's params
  (and, with --resume, its momentum and step); float32 master params on the
  device, compute in TPU.COMPUTE_DTYPE;
- data from data/loader.TrainLoader, fast-forwarded past the batches the
  steps before start_step consumed;
- one step (parallel/train_step.py; --iter_size > 1 accumulates that many
  minibatches' gradients into one update), its sampling draws from a
  generator seeded by (RNG_SEED, step) alone, as the JAX tool folds the
  step into its key: a resumed run samples the RoIs an uninterrupted one
  does;
- the stats of step k-1 read back while step k is queued, logged by
  utils/training_stats.TrainingStats as `json_stats:` lines;
- checkpoints in the JAX package's format (utils/net.save_ckpt) every
  ckpt_interval steps, at the end, and on an interrupt or an exception.

More than one device (the JAX tool's multi-host semantics, :86-186): the
port runs one process per device (parallel/mesh.py). --multihost alone
joins the world torchrun describes (env://: RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT; device cuda is cuda:LOCAL_RANK);
--multihost_coordinator HOST:PORT --num_hosts N --host_rank R joins
tcp://HOST:PORT as rank R of N; a --device list (cuda:0,cuda:1) starts
one such process per listed device on this host (parallel/launch.py).
NCCL serves CUDA devices and gloo the CPU; --dist_backend gloo lets
several ranks share one card. Then --bs (default: the world size x
TRAIN.IMS_PER_BATCH) is the global batch: it sets the linear scaling
and cfg.TRAIN.IMS_PER_BATCH, and must divide by the world size. Each
rank loads its local batch (global / world) from a stream seeded
RNG_SEED + rank, takes its rows of the global batch's sampling draws,
and runs the data-parallel step (parallel/train_step.py with the 1-D
mesh): the losses and the logged stats are the global batch's, equal on
every rank. Only rank 0 writes checkpoints and tfboard. The epoch
trainer (tools/train_net.py) shares this tool's world
(parallel/launch.join_world), cfg, state and step loop (merge_cfg,
load_state, run_steps).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from detectron_tpu_torch.core.config import (
    assert_and_infer_cfg, cfg, merge_cfg_from_file, merge_cfg_from_list)
from detectron_tpu_torch.parallel import launch
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a detection model")
    parser.add_argument("--dataset", help="coco2017 | coco2014 | keypoints_coco2017 | ...")
    parser.add_argument("--cfg", dest="cfg_file", help="config yaml")
    parser.add_argument("--bs", dest="batch_size", type=int,
                        help="global minibatch size (images)")
    parser.add_argument("--nw", dest="num_workers", type=int,
                        help="data loader threads")
    parser.add_argument("--iter_size", type=int, default=1,
                        help="gradient accumulation steps")
    parser.add_argument("--o", dest="optimizer", help="ignored (SGD only)")
    parser.add_argument("--lr", type=float, help="base LR override")
    parser.add_argument("--lr_decay_gamma", type=float)
    parser.add_argument("--start_step", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--load_ckpt", help="checkpoint dir to load")
    parser.add_argument("--load_detectron", help="Detectron .pkl weights")
    parser.add_argument("--use_tfboard", action="store_true")
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--ckpt_num_per_epoch", type=int, default=3)
    parser.add_argument("--disp_interval", type=int, default=20)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    launch.add_world_args(parser)
    parser.add_argument("--deterministic", action="store_true",
                        help="run the steps under "
                        "torch.use_deterministic_algorithms (on the card "
                        "with CUBLAS_WORKSPACE_CONFIG=:4096:8 set)")
    return parser.parse_args(argv)


DATASET_MAP = {
    "coco2017": ("coco_2017_train",),
    "coco2014": ("coco_2014_train", "coco_2014_valminusminival"),
    "keypoints_coco2017": ("keypoints_coco_2017_train",),
    "keypoints_coco2014": ("keypoints_coco_2014_train",
                           "keypoints_coco_2014_valminusminival"),
    "voc2007": ("voc_2007_trainval",),
    "voc2012": ("voc_2012_trainval",),
}


def apply_linear_scaling(batch_size, iter_size):
    """The JAX tool's linear-scaling rule (train_net_step.py:118-130) on
    cfg: BASE_LR scales by the effective batch over NUM_GPUS x
    TRAIN.IMS_PER_BATCH, MAX_ITER and STEPS by its inverse. Returns the
    old BASE_LR."""
    original_batch_size = cfg.NUM_GPUS * cfg.TRAIN.IMS_PER_BATCH
    step_scale = original_batch_size / (batch_size * iter_size)
    old_base_lr = cfg.SOLVER.BASE_LR
    cfg.SOLVER.BASE_LR *= batch_size * iter_size / original_batch_size
    cfg.SOLVER.MAX_ITER = int(cfg.SOLVER.MAX_ITER * step_scale)
    cfg.SOLVER.STEPS = tuple(int(s * step_scale) for s in cfg.SOLVER.STEPS)
    return old_base_lr


def step_generator(step):
    """The CPU generator of one step's sampling draws, seeded by
    (cfg.RNG_SEED, step) alone."""
    seed = np.random.SeedSequence((cfg.RNG_SEED, step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def init_params(args):
    """The numpy params tree (JAX layout) before any checkpoint: the init
    from RNG_SEED, then --load_detectron or the ImageNet weights."""
    from detectron_tpu_torch.models import init

    params = init.init_model(cfg.RNG_SEED)
    if args.load_detectron:
        from detectron_tpu_torch.utils import detectron_weight_helper as dwh
        params = dwh.load_detectron_weight(params, args.load_detectron)
    elif cfg.MODEL.LOAD_IMAGENET_PRETRAINED_WEIGHTS:
        from detectron_tpu_torch.utils import resnet_weights_helper as rwh
        params = rwh.load_pretrained_imagenet_weights(params)
    return params


def merge_cfg(args):
    """--cfg, then --set, then the JAX tools' --dataset rules
    (TRAIN.DATASETS from DATASET_MAP; MODEL.NUM_CLASSES 2 for a keypoint
    set, 81 for COCO, 21 for VOC)."""
    if args.cfg_file:
        merge_cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        merge_cfg_from_list(args.set_cfgs)
    if args.dataset:
        cfg.TRAIN.DATASETS = DATASET_MAP.get(args.dataset, (args.dataset,))
        if "keypoints" in args.dataset:
            cfg.MODEL.NUM_CLASSES = 2
        elif "coco" in args.dataset:
            cfg.MODEL.NUM_CLASSES = 81
        elif "voc" in args.dataset:
            cfg.MODEL.NUM_CLASSES = 21


def load_state(args, device):
    """The float32 master params on the device (the layers cast them to
    the compute dtype) and their optimizer state: init_params, then
    --load_ckpt's params and, with --resume, its momentum. Returns
    (params, opt_state, the checkpoint's step where --resume restored its
    momentum, else None)."""
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.parallel import optimizer as opt
    from detectron_tpu_torch.utils import net as net_utils

    params = init_params(args)
    momentum = step_loaded = None
    if args.load_ckpt:
        step, payload = net_utils.load_ckpt(args.load_ckpt)
        params = payload["params"]
        if args.resume and "opt_state" in payload:
            momentum = payload["opt_state"]["momentum"]
            step_loaded = step
    params = bridge.to_torch(params, device, torch.float32)
    opt_state = opt.init_opt_state(params)
    if momentum is not None:
        opt_state["momentum"] = bridge.to_torch(momentum, device,
                                                torch.float32)
    return params, opt_state, step_loaded


def run_steps(args, roidb, device, params, opt_state, start_step,
              after_step, iter_size=1, save_at_end=False, mesh=None):
    """The step loop of both trainers: steps [start_step,
    cfg.SOLVER.MAX_ITER) of parallel/train_step on the global batch of
    cfg.TRAIN.IMS_PER_BATCH images, this rank's share of it (global /
    world) from data/loader.TrainLoader seeded RNG_SEED + rank
    (fast-forwarded past the batches the earlier steps consumed), each
    step's sampling draws this rank's rows of the global batch's from
    step_generator(step) (the rows of its own canvas: ranks may load
    canvases of different sizes, and each draws the global batch's
    uniforms for its own), the gradients summed over the mesh's data
    group (one device: mesh None or without groups), step k-1's stats
    read back while step k is queued and logged by TrainingStats.

    after_step(step, save) runs after each step; save(step, name=None)
    writes a checkpoint of params and optimizer state in the JAX package's
    format under <cfg.OUTPUT_DIR>/<cfg stem>/ckpt (nothing with
    --no_save, or on a rank other than 0). save_at_end saves one at step
    MAX_ITER after the loop, even when it ran no step. A last checkpoint
    is saved on an interrupt or an exception, as the reference does.
    Returns the run: the output directory, the
    checkpoints written ("ckpts", the last also as "ckpt"), the start
    step, the stats read back per step, the seconds of each step (loader
    wait included), and per minibatch the seconds spent waiting for the
    loader and the canvas (H, W)."""
    from detectron_tpu_torch.data.loader import TrainLoader
    from detectron_tpu_torch.models import bridge
    from detectron_tpu_torch.models import train_graph
    from detectron_tpu_torch.parallel import mesh as mesh_mod
    from detectron_tpu_torch.parallel import train_step as ts
    from detectron_tpu_torch.utils import net as net_utils
    from detectron_tpu_torch.utils.training_stats import TrainingStats

    rank, world = mesh_mod.rank_and_world()
    chief = rank == 0
    batch_size = cfg.TRAIN.IMS_PER_BATCH
    if batch_size % world:
        raise ValueError("the global batch of {} images does not divide "
                         "into {} ranks".format(batch_size, world))
    local_batch = batch_size // world
    # The step's mesh argument, where there is a world to sum over.
    on_mesh = () if mesh is None or mesh.data_group is None else (mesh,)
    output_dir = os.path.join(
        cfg.OUTPUT_DIR,
        os.path.splitext(os.path.basename(args.cfg_file or "default"))[0])
    os.makedirs(output_dir, exist_ok=True)
    opt_state["step"] = start_step
    loader_seed = cfg.RNG_SEED + rank
    logger.info("loader stream seed %d (host %d/%d, local batch %d)",
                loader_seed, rank, world, local_batch)
    loader = TrainLoader(roidb, local_batch, seed=loader_seed,
                         num_threads=args.num_workers,
                         start_batch=start_step * iter_size)
    tblogger = None
    if args.use_tfboard and chief:
        from tensorboardX import SummaryWriter
        tblogger = SummaryWriter(output_dir)
    training_stats = TrainingStats(args, args.disp_interval, tblogger)
    run = {"output_dir": output_dir, "ckpts": [], "ckpt": None,
           "start_step": start_step, "stats": [], "step_s": [],
           "loader_wait_s": [], "canvases": []}

    def save(step, name=None):
        if args.no_save or not chief:
            return
        run["ckpt"] = net_utils.save_ckpt(
            output_dir, step, bridge.to_jax_layout(params),
            {"momentum": bridge.to_jax_layout(opt_state["momentum"]),
             "step": np.asarray(opt_state["step"], np.int32)}, name=name)
        run["ckpts"].append(run["ckpt"])

    def log(pending):
        p_stats, p_step = pending
        # Python floats: syncs on the step that made them.
        host = {k: float(v) for k, v in p_stats.items()}
        training_stats.UpdateIterStats(host, p_step)
        training_stats.LogIterStats(p_step)
        run["stats"].append(host)

    def next_batch():
        t0 = time.perf_counter()
        batch = next(loader)
        run["loader_wait_s"].append(time.perf_counter() - t0)
        run["canvases"].append(batch["images"].shape[1:3])
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    pending = None
    try:
        for step in range(start_step, cfg.SOLVER.MAX_ITER):
            t0 = time.perf_counter()
            training_stats.IterTic()
            gen = step_generator(step)
            batches = [next_batch() for _ in range(iter_size)]
            draws = [{k: v[rank * local_batch:(rank + 1) * local_batch]
                      .to(device) for k, v in train_graph.make_draws(
                          gen, batch_size, tuple(b["images"].shape[1:3]),
                          b["gt_boxes"].shape[1], "cpu").items()}
                     for b in batches]
            if iter_size > 1:
                params, opt_state, stats = ts.train_step_accum(
                    params, opt_state, batches, draws, *on_mesh)
            else:
                params, opt_state, stats = ts.train_step(
                    params, opt_state, batches[0], draws[0], *on_mesh)
            training_stats.IterToc()
            # Deferred stats readback: step k-1's losses are read while
            # step k's queued kernels run.
            if pending is not None:
                log(pending)
            pending = (stats, step)
            after_step(step, save)
            run["step_s"].append(time.perf_counter() - t0)
        if pending is not None:
            log(pending)
        if save_at_end:
            save(cfg.SOLVER.MAX_ITER)
    except (KeyboardInterrupt, Exception):
        save(opt_state["step"])
        raise
    finally:
        loader.close()
        if tblogger:
            tblogger.close()
    return run


def main(argv=None):
    """Train; returns run_steps' run (None where a --device list started
    the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    with launch.world_of(args, argv,
                         "detectron_tpu_torch.tools.train_net_step") as world:
        return None if world is None else _train(args, *world)


def _train(args, device, mesh):
    from detectron_tpu_torch.data.roidb import combined_roidb_for_training
    from detectron_tpu_torch.parallel import mesh as mesh_mod

    merge_cfg(args)
    assert args.iter_size >= 1, "--iter_size must be >= 1"
    # The global batch (run_steps checks that it divides by the world).
    batch_size = args.batch_size or \
        mesh_mod.rank_and_world()[1] * cfg.TRAIN.IMS_PER_BATCH
    old_base_lr = apply_linear_scaling(batch_size, args.iter_size)
    logger.info("Linear scaling: lr %.5f -> %.5f, max_iter -> %d",
                old_base_lr, cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER)
    if args.lr is not None:
        cfg.SOLVER.BASE_LR = args.lr
    if args.lr_decay_gamma is not None:
        cfg.SOLVER.GAMMA = args.lr_decay_gamma
    cfg.TRAIN.IMS_PER_BATCH = batch_size

    assert_and_infer_cfg(make_immutable=False)

    roidb, _, _ = combined_roidb_for_training(cfg.TRAIN.DATASETS,
                                              cfg.TRAIN.PROPOSAL_FILES)
    logger.info("%d roidb entries", len(roidb))
    params, opt_state, step_loaded = load_state(args, device)
    start_step = args.start_step if step_loaded is None else step_loaded
    ckpt_interval = max(
        1, int(len(roidb) / batch_size / args.ckpt_num_per_epoch))

    def after_step(step, save):
        if step > 0 and step % ckpt_interval == 0:
            save(step)

    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(was_deterministic or
                                       args.deterministic)
    try:
        return run_steps(args, roidb, device, params, opt_state, start_step,
                         after_step, iter_size=args.iter_size,
                         save_at_end=True, mesh=mesh)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


if __name__ == "__main__":
    main()
