"""Epoch-style trainer on one device or a data-parallel world (the port's
twin of tools/train_net.py:28-186).

    python -m detectron_tpu_torch.tools.train_net --dataset voc2007 \
        --cfg CFG.yaml [--bs N] [--nw N] [--epochs 6] [--start_epoch 0] \
        [--lr X] [--lr_decay_epochs 4 5] [--lr_decay_gamma X] \
        [--load_detectron PKL | --load_ckpt DIR [--resume]] \
        [--use_tfboard] [--no_save] [--disp_interval N] \
        [--set KEY VALUE ...] [--device cuda|cpu|cuda:0,cuda:1,...] \
        [--multihost | --multihost_coordinator HOST:PORT --num_hosts N \
         --host_rank R] [--dist_backend nccl|gloo]

The JAX tool's flags, with its meaning, plus --device (default cuda; cpu
only where asked for, and cuda raises without a GPU). As the JAX tool
does, it turns the epochs into the step schedule of the optimizer:
steps_per_epoch = len(roidb) // --bs, SOLVER.LR_POLICY steps_with_decay
with no warm-up, SOLVER.STEPS = [0] + [e * steps_per_epoch for each of
--lr_decay_epochs] and MAX_ITER = --epochs * steps_per_epoch (no linear
scaling: --bs is the batch the schedule counts). The cfg, the weights
and the step loop are train_net_step's (merge_cfg, load_state,
run_steps: parallel/train_step.train_step, the sampling draws seeded by
(RNG_SEED, step), the stats of step k-1 read back while step k is
queued), and each epoch ends in a checkpoint `model_epoch{N}` in the JAX
package's format. --resume with --load_ckpt starts at the epoch the
checkpoint's step falls in (its momentum and step restored), the loader
fast-forwarded past the batches the earlier steps consumed.

More than one device: train_net_step's world (parallel/launch.py,
join_world): one process per device, from a --device list or the
multi-host flags; --bs (default
the world size x TRAIN.IMS_PER_BATCH) is the global batch the epochs
count, each rank loads global / world images a step from a stream seeded
RNG_SEED + rank, and only rank 0 writes the checkpoints.
"""

import argparse
import sys

from detectron_tpu_torch.core.config import assert_and_infer_cfg, cfg
from detectron_tpu_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Epoch-style training")
    parser.add_argument("--dataset", help="coco2017 | voc2007 | ...")
    parser.add_argument("--cfg", dest="cfg_file", help="config yaml")
    parser.add_argument("--bs", dest="batch_size", type=int,
                        help="minibatch size (images)")
    parser.add_argument("--nw", dest="num_workers", type=int)
    parser.add_argument("--epochs", dest="num_epochs", type=int, default=6)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--lr", type=float, help="base LR override")
    parser.add_argument("--lr_decay_epochs", nargs="+", type=int,
                        default=[4, 5],
                        help="epochs at which lr decays by lr_decay_gamma")
    parser.add_argument("--lr_decay_gamma", type=float)
    parser.add_argument("--o", dest="optimizer", help="ignored (SGD only)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--load_ckpt", help="checkpoint dir to load")
    parser.add_argument("--load_detectron", help="Detectron .pkl weights")
    parser.add_argument("--use_tfboard", action="store_true")
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--disp_interval", type=int, default=20)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    from detectron_tpu_torch.parallel import launch

    launch.add_world_args(parser)
    return parser.parse_args(argv)


def epoch_schedule(steps_per_epoch, num_epochs, lr_decay_epochs):
    """The JAX tool's epoch schedule (train_net.py:100-106) on cfg: decay at
    epoch boundaries, no warm-up."""
    cfg.SOLVER.LR_POLICY = "steps_with_decay"
    cfg.SOLVER.WARM_UP_ITERS = 0
    cfg.SOLVER.STEPS = tuple(
        [0] + [e * steps_per_epoch for e in sorted(lr_decay_epochs)])
    cfg.SOLVER.MAX_ITER = num_epochs * steps_per_epoch


def main(argv=None):
    """Train; returns train_net_step.run_steps' run with steps_per_epoch
    and the start epoch added (None where a --device list started the
    ranks)."""
    from detectron_tpu_torch.parallel import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    with launch.world_of(args, argv, "detectron_tpu_torch.tools.train_net") \
            as world:
        return None if world is None else _train(args, *world)


def _train(args, device, mesh):
    from detectron_tpu_torch.data.roidb import combined_roidb_for_training
    from detectron_tpu_torch.parallel import mesh as mesh_mod
    from detectron_tpu_torch.tools import train_net_step as tns

    tns.merge_cfg(args)
    # The global batch (run_steps checks that it divides by the world).
    batch_size = args.batch_size or \
        mesh_mod.rank_and_world()[1] * cfg.TRAIN.IMS_PER_BATCH
    cfg.TRAIN.IMS_PER_BATCH = batch_size
    if args.lr is not None:
        cfg.SOLVER.BASE_LR = args.lr
    if args.lr_decay_gamma is not None:
        cfg.SOLVER.GAMMA = args.lr_decay_gamma

    assert_and_infer_cfg(make_immutable=False)

    roidb, _, _ = combined_roidb_for_training(cfg.TRAIN.DATASETS,
                                              cfg.TRAIN.PROPOSAL_FILES)
    logger.info("%d roidb entries", len(roidb))
    steps_per_epoch = max(1, len(roidb) // batch_size)
    epoch_schedule(steps_per_epoch, args.num_epochs, args.lr_decay_epochs)
    logger.info("epochs %d x %d steps; lr decays at epochs %s",
                args.num_epochs, steps_per_epoch, args.lr_decay_epochs)

    params, opt_state, step_loaded = tns.load_state(args, device)
    start_epoch = args.start_epoch
    if step_loaded is not None:
        start_epoch = step_loaded // steps_per_epoch

    def after_step(step, save):
        if (step + 1) % steps_per_epoch == 0:
            epoch = (step + 1) // steps_per_epoch
            logger.info("epoch %d/%d done", epoch, args.num_epochs)
            save(step + 1, name="model_epoch{}".format(epoch))

    run = tns.run_steps(args, roidb, device, params, opt_state,
                        start_epoch * steps_per_epoch, after_step, mesh=mesh)
    run.update(steps_per_epoch=steps_per_epoch, start_epoch=start_epoch)
    return run


if __name__ == "__main__":
    main()
