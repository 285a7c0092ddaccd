"""Process groups for data-parallel and data x model training and
inference (port of detectron_tpu/parallel/mesh.py).

The JAX package runs one process per host and builds a jax.sharding.Mesh
over every chip of every host; XLA inserts the collectives that its
shardings imply. The port runs one process per device (torch.distributed),
so a JAX host with n local chips is n processes here, and a mesh is the
set of process groups that those shardings address:

- make_mesh(): a 1-D data mesh over the world of n processes. Every
  rank holds the whole params tree and 1/n of the global batch; the
  train step sums the gradients over the data group
  (parallel/train_step.py), the counterpart of XLA's psum.
- make_mesh_2d(n_data, n_model): rank r is data index r // n_model and
  model index r % n_model, as the JAX mesh reshapes its devices into
  (n_data, n_model). The batch splits over the data index; the box head's
  fc6 / fc7 split Megatron-style over the model index (tp_param_shardings).

init_distributed joins the processes into one world: tcp://host:port for
an explicit coordinator (--multihost_coordinator), env:// for torchrun's
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (--multihost alone, the
counterpart of JAX's platform auto-discovery). NCCL serves CUDA devices,
gloo the CPU; a caller may name the backend (gloo also reduces CUDA
tensors, through the host, which lets several ranks share one card).

With no process group every function here is the one-device case: the
mesh has no groups and the step runs no collective.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from detectron_tpu_torch.parallel import optimizer as opt

# A rendezvous or a collective that waits longer than this fails its rank
# (and so the run) instead of hanging.
TIMEOUT_S = 600


class Mesh:
    """The process groups of one rank: `data_group` (the ranks that hold
    the same params shard and different images; None without a process
    group) and `model_group` (the ranks that split the box head for the
    same images; None when n_model is 1)."""

    def __init__(self, n_data, n_model, rank=0, data_group=None,
                 model_group=None):
        self.n_data = n_data
        self.n_model = n_model
        self.rank = rank
        self.data_group = data_group
        self.model_group = model_group

    @property
    def data_index(self):
        return self.rank // self.n_model

    @property
    def model_index(self):
        return self.rank % self.n_model


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device="cuda"):
    """Join this process to the world; every process calls it before any
    collective. coordinator_address "host:port" gives tcp://host:port
    (rank process_id of num_processes; either may come from the RANK /
    WORLD_SIZE environment when None); with neither an address nor a
    process count the environment gives everything (env://, as torchrun
    sets it). A no-op for one process, as in the JAX package. backend:
    NCCL for a CUDA device, gloo for the CPU, unless given. Every wait of
    the group is bounded by TIMEOUT_S."""
    if coordinator_address is None and num_processes is not None \
            and int(num_processes) <= 1:
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = os.environ["WORLD_SIZE"]
    if process_id is None and "RANK" in os.environ:
        process_id = os.environ["RANK"]
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                "--multihost without --multihost_coordinator reads the "
                "world from the environment (env://, as torchrun sets it), "
                "but {} is not set".format(", ".join(missing)))
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--multihost_coordinator needs --num_hosts and --host_rank "
                "(or WORLD_SIZE and RANK in the environment)")
        init_method = "tcp://" + coordinator_address
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=TIMEOUT_S))


def rank_and_world():
    """(this process's rank, the world size); (0, 1) without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_chief():
    return rank_and_world()[0] == 0


def make_mesh():
    """The 1-D data mesh over the whole world (one process per device)."""
    rank, world = rank_and_world()
    if not dist.is_initialized():
        return Mesh(1, 1)
    return Mesh(world, 1, rank, data_group=dist.new_group(list(
        range(world))))


def make_mesh_2d(n_data, n_model):
    """The (data, model) mesh: rank r is data index r // n_model and model
    index r % n_model. Every rank builds every group (torch.distributed
    needs all ranks in each new_group call) and keeps its own two."""
    rank, world = rank_and_world()
    if n_data * n_model != world:
        raise ValueError("a {} x {} mesh needs {} processes; the world has "
                         "{}".format(n_data, n_model, n_data * n_model,
                                     world))
    if not dist.is_initialized():
        return Mesh(1, 1)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def shard_dim(path):
    """The dim of the leaf at `path` (a tuple of tree keys) that the model
    axis splits, or None where the leaf is replicated: box_head/fc6/w on
    its output dim and fc6/b with it, box_head/fc7/w on its input dim
    (detectron_tpu/parallel/mesh.py:58-77)."""
    keys = [k for k in path if isinstance(k, str)]
    if "box_head" not in keys:
        return None
    if "fc6" in keys:
        return {"w": 1, "b": 0}.get(keys[-1])
    if "fc7" in keys and keys[-1] == "w":
        return 0
    return None


def tp_param_shardings(params):
    """A tree like params holding each leaf's split dim on the model axis
    (shard_dim) or None for a replicated leaf."""
    return opt.unflatten_like(params, iter(
        [shard_dim(path) for path, _ in opt.flatten(params)]))


def _take(x, dim, index, n):
    size = x.shape[dim]
    if size % n:
        raise ValueError("a dim of {} does not split into {} shards".format(
            size, n))
    step = size // n
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    out = x[tuple(sl)]
    return out.clone() if isinstance(out, torch.Tensor) else \
        np.ascontiguousarray(out)


def shard_params(params, mesh):
    """This rank's shards of a full params tree (numpy or torch leaves):
    the model-split leaves cut to the rank's model index, the others as
    they are."""
    if mesh.model_group is None:
        return params
    out = []
    for path, x in opt.flatten(params):
        dim = shard_dim(path)
        out.append(x if dim is None else
                   _take(x, dim, mesh.model_index, mesh.n_model))
    return opt.unflatten_like(params, iter(out))


def gather_params(params, mesh, dst=0):
    """The full params tree from every rank's shards, on rank `dst` (for a
    checkpoint in the JAX package's format); None on the other ranks.
    Every rank calls it. The split leaves are gathered over the model
    group of dst's data row; the replicated leaves are dst's own."""
    if mesh.model_group is None:
        return params if mesh.rank == dst else None
    out = []
    dst_row = dst // mesh.n_model
    for path, x in opt.flatten(params):
        dim = shard_dim(path)
        if dim is None:
            out.append(x)
            continue
        if mesh.data_index != dst_row:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.n_model)]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        out.append(torch.cat(parts, dim=dim))
    if mesh.rank != dst:
        return None
    return opt.unflatten_like(params, iter(out))


def shard_batch(batch, rank, world):
    """Rows [rank * B / world, (rank + 1) * B / world) of every leaf of a
    global host batch (a dict of numpy arrays or tensors with the batch on
    dim 0): this rank's images, or its rows of the sampling draws."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError("a batch of {} does not split over {} ranks"
                             .format(n, world))
        b = n // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out
