"""The training step (port of detectron_tpu/parallel/train_step.py:
train_step :24-36 and the iter_size gradient accumulation of
make_pjit_train_step_accum :59-100, on one device).

One call is one SGD iteration in eager PyTorch: the loss forward
(models/train_graph.py), torch.autograd.grad over the trainable leaves
(AffineChannel and frozen leaves take no gradient: they enter the forward
detached), then the optimizer update (parallel/optimizer.py). Params stay
float32 master copies whatever TPU.COMPUTE_DTYPE is: the layers cast them
to the activation dtype, so their gradients come back in float32.
Multi-device data parallelism is not ported yet (ROADMAP Queue A,
A8).
"""

import torch

from detectron_tpu_torch.models import train_graph
from detectron_tpu_torch.parallel import optimizer as opt


def grad_leaves(params):
    """(a tree aliasing params' storage with requires_grad on the trainable
    leaves, the list of those leaves)."""
    leaves = []
    out = []
    for path, p in opt.flatten(params):
        t = p.detach()
        if opt.param_kind(path) not in opt.FROZEN_KINDS:
            t.requires_grad_(True)
            leaves.append(t)
        out.append(t)
    return opt.unflatten_like(params, iter(out)), leaves


def grads_of(loss, tree, leaves):
    """Gradients of `loss` as a tree like `tree` (grad_leaves' first
    result): float32, zero for the leaves that take none."""
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = []
    for _, leaf in opt.flatten(tree):
        g = next(got) if leaf.requires_grad else None
        grads.append(torch.zeros_like(leaf) if g is None else g)
    return opt.unflatten_like(tree, iter(grads))


def loss_and_grads(params, batch, draws, scale=1.0):
    """(total, parts, grads): grads a tree like params, float32, zero for
    the frozen leaves, of scale * total."""
    p, leaves = grad_leaves(params)
    total, parts = train_graph.training_losses(p, batch, draws)
    grads = grads_of(total * scale, p, leaves)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads


def train_step(params, opt_state, batch, draws):
    """Returns (new_params, new_opt_state, stats): stats holds the losses,
    accuracy_cls, the total "loss" and the "lr" of this step. `draws` is
    train_graph.make_draws' dict of sampling uniforms."""
    total, parts, grads = loss_and_grads(params, batch, draws)
    new_params, new_opt_state, lr = opt.apply_updates(params, grads,
                                                      opt_state)
    stats = dict(parts)
    stats["loss"] = total
    stats["lr"] = lr
    return new_params, new_opt_state, stats


def train_step_accum(params, opt_state, batches, draws):
    """The reference's --iter_size: one update from the gradients of
    len(batches) microbatches, each loss divided by their count (so the
    update uses the mean gradient). draws: one dict per microbatch.
    stats["loss"] is the sum of the scaled losses; the other stats are the
    last microbatch's."""
    iter_size = len(batches)
    acc = None
    loss = 0.0
    for batch, d in zip(batches, draws):
        total, parts, grads = loss_and_grads(params, batch, d,
                                             1.0 / iter_size)
        loss = loss + total / iter_size
        leaves = [g for _, g in opt.flatten(grads)]
        acc = leaves if acc is None else [a + g for a, g in zip(acc, leaves)]
    new_params, new_opt_state, lr = opt.apply_updates(
        params, opt.unflatten_like(params, iter(acc)), opt_state)
    stats = dict(parts)
    stats["loss"] = loss
    stats["lr"] = lr
    return new_params, new_opt_state, stats
