"""The collectives of the parallel step and engine (what XLA inserts for
the JAX package's shardings, parallel/mesh.py and train_step.py there).

- all_reduce_tree: the gradient sum over the data group, leaves packed
  into a few flat buckets (one call per bucket, not one per leaf).
- global_sum: the sum of a small count tensor over a group (the loss
  normalizers, the logged stats).
- gather_object: picklable results of every rank on one rank (the
  engine's detections on rank 0).
- copy_to_model / reduce_from_model / gather_from_model: the Megatron
  autograd functions around the box head's model split. copy_to_model is
  the identity forward with an all-reduce of the gradient; reduce_from_model
  all-reduces the row-split product forward and passes the gradient
  through; gather_from_model concatenates the column-split outputs and
  hands each rank its own columns of the gradient.

Every function takes its group explicitly; with group None it is the
identity (no process group: one device). Only all-reduce, broadcast,
all-gather and gather are used, which gloo has for CUDA tensors too. The
model group's all-reduces run in float32 and cast back to the input's
dtype.
"""

import torch
import torch.distributed as dist

# Gradient values per bucket of all_reduce_tree (64 MiB of float32).
BUCKET_NUMEL = 1 << 24


def all_reduce_tree(tensors, group):
    """Sum each tensor of the list over `group`, in place: same-dtype
    tensors are packed into flat buckets of up to BUCKET_NUMEL values
    (a larger tensor is a bucket of its own), each bucket one all-reduce.
    Returns the number of all-reduce calls."""
    if group is None or not tensors:
        return 0
    calls = 0
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_dtype.values():
        bucket, size = [], 0
        for t in ts + [None]:
            if t is not None and (not bucket
                                  or size + t.numel() <= BUCKET_NUMEL):
                bucket.append(t)
                size += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            calls += 1
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            if t is not None:
                bucket, size = [t], t.numel()
    return calls


def global_sum(x, group):
    """x (a tensor of counts or stats, no gradient) summed over `group`,
    as float32; x itself where group is None."""
    if group is None:
        return x
    y = x.detach().to(torch.float32).clone()
    dist.all_reduce(y, group=group)
    return y


def all_reduce_stats(stats, group):
    """A dict of scalar tensors, each summed over `group`, in one call."""
    if group is None:
        return stats
    keys = list(stats)
    vec = global_sum(torch.stack([stats[k].detach().to(torch.float32)
                                  for k in keys]), group)
    return {k: vec[i] for i, k in enumerate(keys)}


def gather_object(obj, dst=0):
    """[every rank's obj] in rank order on rank dst (pickled through the
    CPU), None on the other ranks."""
    out = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def _all_reduce32(x, group):
    y = x.to(torch.float32).contiguous()
    if y is x:
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


def copy_to_model(x, group):
    """Before a column-split layer: x forward, the gradient summed over
    the model group backward."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """After a row-split layer: the partial products summed over the model
    group forward, the gradient as it is backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x, group):
    """After a column-split layer whose full output is needed: the ranks'
    columns concatenated in model order forward, this rank's columns of
    the gradient backward."""
    return x if group is None else _GatherFromModel.apply(x, group)
