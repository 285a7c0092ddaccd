"""Start one process per device on this host and join them into a world
(the port runs one process per device; parallel/mesh.py).

- spawn(target, devices, args): run the function named "module:function"
  as target(device, *args) in len(devices) new processes, rank r on
  devices[r], and return every rank's result. The processes meet at
  tcp://localhost:<a free port>.
- spawn_cli(module, argv, devices): run a CLI (`python -m module argv`)
  once per device with --device d --multihost_coordinator localhost:P
  --num_hosts W --host_rank r added: what a --device list
  (cuda:0,cuda:1) turns into in the trainers and test_net, and how the
  tests and chip_smoke.py start a world of CLI ranks.
- add_world_args / join_world / world_of: those CLIs' --device and
  multi-host flags, and the world they make.

Both wait for every rank with a time limit: a rank that exits with an
error, or a run past its limit, stops every rank and raises, naming the
rank and its exit code (with the end of its log where it was captured).
Nothing carries on with fewer ranks.

    python -m detectron_tpu_torch.parallel.launch TARGET ARGS_PKL RANK \
        WORLD PORT BACKEND DEVICE OUT_PKL

is the child side of spawn.
"""

import contextlib
import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

DEFAULT_TIMEOUT_S = 900

logger = logging.getLogger(__name__)


def free_port():
    """A TCP port on localhost that nothing listened on a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(world, device):
    """The environment of a local rank: its processes pair over loopback
    (gloo's interface detection may pick an address they cannot reach),
    and CPU ranks share the host's cores."""
    out = dict(os.environ)
    out.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if not str(device).startswith("cuda"):
        out.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // world)))
    return out


def wait_all(procs, timeout_s=None, logs=None):
    """Wait for every process of `procs` (Popen, rank order) to exit 0;
    on a failure, or past timeout_s where one is given, kill the rest and
    raise."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r, c = bad[0]
                tail = ""
                if logs:
                    with open(logs[r]) as f:
                        tail = "\n" + f.read()[-4000:]
                raise RuntimeError("rank {} exited with code {}{}".format(
                    r, c, tail))
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("ranks {} still running after {} s".format(
                    [r for r, c in enumerate(codes) if c is None],
                    timeout_s))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def spawn(target, devices, args=(), backend=None,
          timeout_s=DEFAULT_TIMEOUT_S, log_dir=None):
    """Run target ("module:function") as fn(device, *args) on ranks
    0..len(devices)-1, joined in one process group (backend: NCCL for CUDA
    devices, gloo for the CPU, unless given), and return [each rank's
    result]. Each rank's stdout and stderr go to log_dir/rank{r}.log (a
    temporary directory unless given)."""
    world = len(devices)
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = log_dir or tmp
        os.makedirs(log_dir, exist_ok=True)
        args_pkl = os.path.join(tmp, "args.pkl")
        with open(args_pkl, "wb") as f:
            pickle.dump(tuple(args), f, pickle.HIGHEST_PROTOCOL)
        procs, logs, outs = [], [], []
        try:
            for rank, device in enumerate(devices):
                logs.append(os.path.join(log_dir, "rank{}.log".format(rank)))
                outs.append(os.path.join(tmp, "out{}.pkl".format(rank)))
                with open(logs[-1], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "detectron_tpu_torch.parallel.launch", target,
                         args_pkl, str(rank), str(world), str(port),
                         backend or "", str(device), outs[-1]],
                        env=_child_env(world, device), stdout=log,
                        stderr=subprocess.STDOUT))
        finally:
            wait_all(procs, timeout_s, logs)
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results


def spawn_cli(module, argv, devices, backend=None, logs=None,
              timeout_s=None, env=None, command=None):
    """Run `python -m module argv` once per device, rank r with --device
    devices[r] and the multi-host flags of a local world (plus
    --dist_backend where given), and wait for every rank to exit 0.

    argv is a list, or a function of the rank that gives one. logs: a
    path per rank for its stdout and stderr (default: this process's).
    timeout_s bounds the wait (default: none; a training run takes as
    long as it takes, and a rank that hangs in a collective fails at the
    process group's time limit, mesh.TIMEOUT_S). env: variables added to
    the ranks' environment. command: what runs in place of
    `python -m module` (a list)."""
    world = len(devices)
    port = free_port()
    procs = []
    try:
        for rank, device in enumerate(devices):
            args = argv(rank) if callable(argv) else list(argv)
            args += ["--device", device, "--multihost_coordinator",
                     "localhost:{}".format(port), "--num_hosts", str(world),
                     "--host_rank", str(rank)]
            if backend:
                args += ["--dist_backend", backend]
            child_env = _child_env(world, device)
            child_env.update(env or {})
            cmd = (command or [sys.executable, "-m", module]) + args
            if logs:
                with open(logs[rank], "w") as log:
                    procs.append(subprocess.Popen(
                        cmd, env=child_env, stdout=log,
                        stderr=subprocess.STDOUT))
            else:
                procs.append(subprocess.Popen(cmd, env=child_env))
    finally:
        wait_all(procs, timeout_s, logs)


def devices_of(device):
    """The devices a --device value names: "cuda:0,cuda:1" -> both."""
    return [d.strip() for d in str(device).split(",") if d.strip()]


def without_flags(argv, flags):
    """argv less each flag of `flags` and its one value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in flags:
            skip = True
            continue
        if any(a.startswith(f + "=") for f in flags):
            continue
        out.append(a)
    return out


def add_world_args(parser):
    """--device and the flags of a multi-process world (both trainers and
    test_net)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join the world torchrun describes (env://), "
                        "one process per device")
    parser.add_argument("--multihost_coordinator", default=None,
                        help="rank 0's host:port (tcp://)")
    parser.add_argument("--num_hosts", type=int, default=None,
                        help="processes in the world")
    parser.add_argument("--host_rank", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--dist_backend", default=None,
                        help="nccl | gloo (default: nccl for CUDA devices, "
                        "gloo for the CPU)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cpu, or a "
                        "list: cuda:0,cuda:1 starts one process each)")


def join_world(args, argv, module):
    """This process's (device, mesh), or None where it only started the
    ranks of a --device list (one `python -m module` per device, argv
    with that device and the world's flags; they must all exit 0). The
    multi-host flags join this process to its world first and log
    `multi-host: process r/W ...`."""
    import torch

    from detectron_tpu_torch.parallel import mesh as mesh_mod
    from detectron_tpu_torch.utils.device import check_device

    devices = devices_of(args.device)
    if len(devices) > 1:
        if args.multihost or args.multihost_coordinator:
            raise ValueError("a --device list starts a world of its own on "
                             "this host; with the multi-host flags each "
                             "process names one device")
        for d in devices:
            check_device(d)
        spawn_cli(module, without_flags(argv, ("--device",)), devices,
                  backend=args.dist_backend)
        return None
    device = devices[0] if devices else "cuda"
    if args.multihost or args.multihost_coordinator:
        if device == "cuda" and "LOCAL_RANK" in os.environ:
            device = "cuda:" + os.environ["LOCAL_RANK"]
        device = check_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh_mod.init_distributed(args.multihost_coordinator, args.num_hosts,
                                  args.host_rank, backend=args.dist_backend,
                                  device=device)
        rank, world = mesh_mod.rank_and_world()
        logger.info("multi-host: process %d/%d, 1 local / %d global devices "
                    "(%s, %s)", rank, world, world,
                    torch.distributed.get_backend(), device)
    else:
        device = check_device(device)
    return device, mesh_mod.make_mesh()


@contextlib.contextmanager
def world_of(args, argv, module):
    """join_world's result for the with block; the process group it made
    is destroyed after it."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    try:
        yield join_world(args, argv, module)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _child_main(target, args_pkl, rank, world, port, backend, device,
                out_pkl):
    import importlib

    import torch

    from detectron_tpu_torch.parallel import mesh

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    else:
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    mesh.init_distributed("localhost:{}".format(port), world, rank,
                          backend=backend or None, device=device)
    mod_name, fn_name = target.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    with open(args_pkl, "rb") as f:
        args = pickle.load(f)
    try:
        result = fn(device, *args)
        with open(out_pkl, "wb") as f:
            pickle.dump(result, f, pickle.HIGHEST_PROTOCOL)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child_main(*sys.argv[1:9])
