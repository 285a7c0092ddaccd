"""SGD with momentum, Detectron's parameter-group rules and LR schedule
(port of detectron_tpu/parallel/optimizer.py:23-154).

- Caffe2 form: v = mu * mcorr * v + lr * (g + wd * p); p -= v. When the
  schedule jumps (a STEPS decay, not the warm-up ramp) the buffered
  momentum, which carries the old lr, is rescaled by new_lr / old_lr
  (SOLVER.SCALE_MOMENTUM).
- Groups: biases get 2x LR (SOLVER.BIAS_DOUBLE_LR) and no weight decay
  unless SOLVER.BIAS_WEIGHT_DECAY; AffineChannel params and frozen stages
  (RESNETS.FREEZE_AT, TRAIN.FREEZE_CONV_BODY) are never updated.
- SOLVER.CLIP_GRADIENTS > 0 scales all gradients to that global norm.
- Warm-up (linear or constant) for WARM_UP_ITERS, then steps_with_decay
  over SOLVER.STEPS (or "step" every STEP_SIZE) by GAMMA.

Params, gradients and momentum are trees of float32 tensors keyed like the
JAX params tree; opt_state["step"] is a Python int. The lr is computed on
the host in float32, as the JAX step computes it.
"""

import numpy as np
import torch

from detectron_tpu_torch.core.config import cfg

FROZEN_KINDS = ("affine", "frozen")


def param_kind(path):
    """Classify a params-tree path (a tuple of dict keys and list indices):
    'frozen' | 'affine' | 'gn' | 'bias' | 'weight'."""
    keys = [k for k in path if isinstance(k, str)]
    if keys and keys[0] in ("body", "fpn") and cfg.TRAIN.FREEZE_CONV_BODY:
        return "frozen"
    if keys and keys[0] == "body":
        fa = cfg.RESNETS.FREEZE_AT
        if fa >= 2 and len(keys) > 1:
            sub = keys[1]
            if sub in ("conv1", "res_conv1_bn"):
                return "frozen"
            if sub.startswith("res") and sub[3:].isdigit() \
                    and int(sub[3:]) <= fa:
                return "frozen"
    if any(k.endswith("_bn") for k in keys):
        return "gn" if cfg.RESNETS.USE_GN else "affine"
    if any(k.endswith("_gn") or k == "gns" for k in keys):
        return "gn"
    if keys and keys[-1] == "b":
        return "bias"
    return "weight"


def flatten(tree, path=()):
    """[(path, leaf), ...] in the tree's order (dict insertion order)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, path + (i,))]
    return [(path, tree)]


def unflatten_like(tree, leaves):
    """A tree shaped like `tree` with the leaves taken in order from the
    iterator `leaves`."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflatten_like(v, leaves) for v in tree]
    return next(leaves)


def make_lr_fn():
    """step (int) -> lr (np.float32)."""
    base_lr = cfg.SOLVER.BASE_LR
    gamma = np.float32(cfg.SOLVER.GAMMA)
    steps = tuple(cfg.SOLVER.STEPS) or (0,)
    warm_iters = cfg.SOLVER.WARM_UP_ITERS
    warm_factor = np.float32(cfg.SOLVER.WARM_UP_FACTOR)
    policy = cfg.SOLVER.LR_POLICY

    def lr_fn(step):
        if policy == "steps_with_decay":
            n_decays = sum(int(step >= s) for s in steps if s > 0)
            lr = np.float32(base_lr) * gamma ** np.float32(n_decays)
        elif policy == "step":
            lr = np.float32(base_lr) * gamma ** np.float32(
                step // cfg.SOLVER.STEP_SIZE)
        else:
            lr = np.float32(base_lr)
        if warm_iters > 0 and step < warm_iters:
            if cfg.SOLVER.WARM_UP_METHOD == "linear":
                alpha = np.float32(step) / np.float32(warm_iters)
                factor = warm_factor * (np.float32(1.0) - alpha) + alpha
            else:
                factor = warm_factor
            lr = lr * factor
        return np.float32(lr)

    return lr_fn


def init_opt_state(params):
    """Zero float32 momentum shaped like params, and step 0."""
    return {"momentum": unflatten_like(params, iter([
        torch.zeros_like(p, dtype=torch.float32)
        for _, p in flatten(params)])), "step": 0}


@torch.no_grad()
def apply_updates(params, grads, opt_state):
    """One Caffe2 SGD + momentum step with Detectron's group rules.
    grads: a tree like params (frozen leaves may be zeros). Returns
    (new_params, new_opt_state, lr); the inputs are left unchanged."""
    leaves = flatten(params)
    g_leaves = [g for _, g in flatten(grads)]
    v_leaves = [v for _, v in flatten(opt_state["momentum"])]
    if cfg.SOLVER.CLIP_GRADIENTS > 0:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in g_leaves))
        scale = torch.clamp(cfg.SOLVER.CLIP_GRADIENTS
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        g_leaves = [g * scale for g in g_leaves]
    lr_fn = make_lr_fn()
    step = opt_state["step"]
    lr = lr_fn(step)
    mcorr = np.float32(1.0)
    if cfg.SOLVER.SCALE_MOMENTUM:
        ratio = lr / max(lr_fn(max(step - 1, 0)), np.float32(1e-20))
        thr = cfg.SOLVER.SCALE_MOMENTUM_THRESHOLD
        if ratio > thr or ratio < 1.0 / thr:
            mcorr = np.float32(ratio)
    mu = cfg.SOLVER.MOMENTUM
    wd = cfg.SOLVER.WEIGHT_DECAY
    bias_lr = lr * np.float32(2.0 if cfg.SOLVER.BIAS_DOUBLE_LR else 1.0)
    bias_wd = wd if cfg.SOLVER.BIAS_WEIGHT_DECAY else 0.0

    new_p, new_v = [], []
    for (path, p), g, v in zip(leaves, g_leaves, v_leaves):
        kind = param_kind(path)
        if kind in FROZEN_KINDS:
            new_p.append(p)
            new_v.append(v)
            continue
        if kind == "bias":
            eff_lr, eff_wd = bias_lr, bias_wd
        elif kind == "gn":
            eff_lr, eff_wd = lr, cfg.SOLVER.WEIGHT_DECAY_GN
        else:
            eff_lr, eff_wd = lr, wd
        v_next = mu * (float(mcorr) * v) + float(eff_lr) * (
            g.to(torch.float32) + eff_wd * p)
        new_p.append(p - v_next)
        new_v.append(v_next)
    return (unflatten_like(params, iter(new_p)),
            {"momentum": unflatten_like(params, iter(new_v)),
             "step": step + 1}, lr)
