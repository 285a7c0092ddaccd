"""The training step (port of detectron_tpu/parallel/train_step.py:
train_step :24-36, make_pjit_train_step :39-56 and the iter_size gradient
accumulation of make_pjit_train_step_accum :59-100).

One call is one SGD iteration in eager PyTorch: the loss forward
(models/train_graph.py), torch.autograd.grad over the trainable leaves
(AffineChannel and frozen leaves take no gradient: they enter the forward
detached), then the optimizer update (parallel/optimizer.py). Params stay
float32 master copies whatever TPU.COMPUTE_DTYPE is: the layers cast them
to the activation dtype, so their gradients come back in float32.

With a mesh (parallel/mesh.py; one process per device) the step is the
JAX package's sharded step, make_pjit_train_step's counterpart: the batch
and the draws are this rank's rows of the global ones, the losses this
rank's shares of the global batch's loss (models/losses.py sums their
normalizers over the data group), and after the backward the trainable
gradients are summed over the data group in a few buckets
(comm.all_reduce_tree; with accumulation once per update, after the
microbatches). A leaf split on the model axis and a replicated leaf are
both summed over the data group only: the box head's Megatron functions
have already completed the replicated leaves' gradient over the model
group. The stats are summed too, so every rank returns the global batch's
losses. A W-rank step on B images is the one-device step on the same B
images, up to the order of float sums.
"""

import torch

from detectron_tpu_torch.models import train_graph
from detectron_tpu_torch.parallel import comm
from detectron_tpu_torch.parallel import optimizer as opt
from detectron_tpu_torch.utils import tracing


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


def loss_and_grads(params, batch, draws, scale=1.0, mesh=None):
    """(total, parts, grads): grads a tree like params, float32, zero for
    the frozen leaves, of scale * total. With a mesh these are this rank's
    shares, before any sum over the data group."""
    p, leaves = grad_leaves(params)
    total, parts = train_graph.training_losses(p, batch, draws, mesh)
    with tracing.span("backward"):
        grads = grads_of(total * scale, p, leaves)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads


def sum_over_data(grads, stats, mesh):
    """The gradient tree's trainable leaves summed over mesh.data_group in
    place, and the stats dict summed (returned); both as they are without
    a mesh."""
    if mesh is None or mesh.data_group is None:
        return stats
    comm.all_reduce_tree(
        [g for path, g in opt.flatten(grads)
         if opt.param_kind(path) not in opt.FROZEN_KINDS], mesh.data_group)
    return comm.all_reduce_stats(stats, mesh.data_group)


@tracing.spanned("train_step")
def train_step(params, opt_state, batch, draws, mesh=None):
    """Returns (new_params, new_opt_state, stats): stats holds the losses,
    accuracy_cls, the total "loss" and the "lr" of this step. `draws` is
    train_graph.make_draws' dict of sampling uniforms (under a mesh, this
    rank's rows of the global batch's)."""
    total, parts, grads = loss_and_grads(params, batch, draws, mesh=mesh)
    stats = dict(parts)
    stats["loss"] = total
    stats = sum_over_data(grads, stats, mesh)
    with tracing.span("optimizer"):
        new_params, new_opt_state, lr = opt.apply_updates(params, grads,
                                                          opt_state, mesh)
    stats["lr"] = lr
    return new_params, new_opt_state, stats


@tracing.spanned("train_step")
def train_step_accum(params, opt_state, batches, draws, mesh=None):
    """The reference's --iter_size: one update from the gradients of
    len(batches) microbatches, each loss divided by their count (so the
    update uses the mean gradient). draws: one dict per microbatch.
    stats["loss"] is the sum of the scaled losses; the other stats are the
    last microbatch's. Under a mesh the gradients are summed over the data
    group once, after the last microbatch."""
    iter_size = len(batches)
    acc = None
    loss = 0.0
    for batch, d in zip(batches, draws):
        total, parts, grads = loss_and_grads(params, batch, d,
                                             1.0 / iter_size, mesh)
        loss = loss + total / iter_size
        leaves = [g for _, g in opt.flatten(grads)]
        acc = leaves if acc is None else [a + g for a, g in zip(acc, leaves)]
    grads = opt.unflatten_like(params, iter(acc))
    stats = dict(parts)
    stats["loss"] = loss
    stats = sum_over_data(grads, stats, mesh)
    with tracing.span("optimizer"):
        new_params, new_opt_state, lr = opt.apply_updates(params, grads,
                                                          opt_state, mesh)
    stats["lr"] = lr
    return new_params, new_opt_state, stats
