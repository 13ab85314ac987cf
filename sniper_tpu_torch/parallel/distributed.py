"""Data parallelism across processes: one process per card.

Port of sniper_tpu/parallel/distributed.py. The JAX package scales out by
joining every host's devices into one global mesh; here each card is a
rank of one ``torch.distributed`` process group (NCCL between cards, gloo
on the CPU or for several ranks sharing one card, which NCCL refuses), and
the training model is wrapped in DDP (parallel/mesh.py).

Host-side sharding follows the JAX package: rank p of N trains on
``roidb[p::N]`` (``shard_roidb``) with its own loader, and since every step
is a collective, all ranks run ``global_min_steps(len(loader))`` steps an
epoch, the global minimum.

A run joins a group in one of two ways:
- one process per rank, started from outside (torchrun, or one command per
  host): ``maybe_init_distributed`` reads ``parallel.coordinator_address``
  ("host:port" of rank 0), ``parallel.num_processes`` and
  ``parallel.process_id``, each falling back to its environment variable
  when the key is unset (SNIPER_COORDINATOR, SNIPER_NUM_PROCESSES,
  SNIPER_PROCESS_ID), and to torchrun's (WORLD_SIZE, RANK, and
  MASTER_ADDR with MASTER_PORT through ``env://``; the card is
  LOCAL_RANK's). Unlike the JAX package, the
  default ``num_processes`` 0 counts as unset, so the environment is read;
- one process that starts a worker per card (``launch``), as
  ``main_train`` does for ``parallel.num_devices`` > 1.

Without a group every helper here is a no-op and a run is the
single-process one, bit for bit.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before it raises
TIMEOUT_S = 1800.0

_ENV = {
    "coordinator_address": ("SNIPER_COORDINATOR",),
    "num_processes": ("SNIPER_NUM_PROCESSES", "WORLD_SIZE"),
    "process_id": ("SNIPER_PROCESS_ID", "RANK"),
}


def _cfg_or_env(cfg, key: str):
    """parallel.<key>, or the first of its environment variables that is
    set when the key is unset (empty, or a negative or zero count)."""
    v = getattr(getattr(cfg, "parallel", None), key, None)
    unset = v in (None, "") or (
        isinstance(v, (int, float)) and (v < 0 or
                                         (key == "num_processes" and v == 0)))
    if not unset:
        return v
    for env in _ENV[key]:
        if os.environ.get(env, "") != "":
            return os.environ[env]
    if key == "coordinator_address" and os.environ.get("MASTER_ADDR"):
        # torchrun's: its agent may already serve the store at
        # MASTER_ADDR:MASTER_PORT, which env:// joins as a client
        return "env://"
    return None


def num_processes(cfg) -> int:
    """The process count of a run started one process per rank (the config
    or the environment); 0 or 1 for a single process."""
    return int(_cfg_or_env(cfg, "num_processes") or 0)


def backend_for(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    several ranks on one card, which NCCL refuses)."""
    devices = [torch.device(d) for d in devices]
    distinct = len({str(d) for d in devices}) == len(devices)
    return "nccl" if devices[0].type == "cuda" and distinct else "gloo"


def init_group(init_method: str, world: int, rank_: int, device,
               backend: str, timeout_s: float = TIMEOUT_S):
    """Join the process group as ``rank_`` of ``world``; a CUDA ``device``
    becomes this process's current card. The group's store counts the
    ranks that have joined (``leave_group``)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank_,
        timeout=datetime.timedelta(seconds=timeout_s))
    if world > 1:
        store = dist.distributed_c10d._get_default_store()
        if store.add("leave/joined", 1) == world:
            store.set("leave/all_joined", "")


def maybe_init_distributed(cfg, device="cuda"):
    """Join the process group when the run was started one process per rank
    (``parallel.num_processes`` > 1, from the config or the environment).
    Returns (rank, world size); a single process joins nothing and gets
    (0, 1). On a CUDA ``device`` the rank's card (LOCAL_RANK's, else the
    process id modulo the visible cards) becomes the current one. Raises
    ValueError when the coordinator's address is missing."""
    if dist.is_available() and dist.is_initialized():
        return rank(), world_size()
    nprocs = num_processes(cfg)
    if nprocs <= 1:
        return 0, 1
    coord = str(_cfg_or_env(cfg, "coordinator_address") or "")
    pid = int(_cfg_or_env(cfg, "process_id") or 0)
    if not coord:
        raise ValueError(
            "parallel.num_processes > 1 requires "
            "parallel.coordinator_address (or SNIPER_COORDINATOR)")
    method = coord if "://" in coord else f"tcp://{coord}"
    device = torch.device(device)
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None else
                              pid % max(torch.cuda.device_count(), 1))
    init_group(method, nprocs, pid, device,
               backend="nccl" if device.type == "cuda" else "gloo")
    return rank(), world_size()


def is_distributed() -> bool:
    """Whether this process is a rank of a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def collective_device() -> torch.device:
    """Where a small tensor of a collective lives: NCCL takes only CUDA
    tensors, gloo any."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_min_steps(local_steps: int) -> int:
    """The number of steps every rank can run this epoch: the ranks' roidb
    slices give different chip counts, but each step is a collective, so
    all ranks truncate to the global minimum."""
    if world_size() <= 1:
        return int(local_steps)
    t = torch.tensor([int(local_steps)], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def shard_roidb(roidb, process_index: int | None = None,
                process_count: int | None = None):
    """This rank's slice of the image database: strided (p::N), so that
    aspect and scale statistics stay balanced across ranks even when the
    roidb is sorted."""
    p = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    return roidb if n <= 1 else roidb[p::n]


def global_count(count: torch.Tensor) -> torch.Tensor:
    """The sum of a count over the ranks, as fp32 with no gradient (exact
    below 2^24); the count itself without a group of more than one."""
    if world_size() <= 1:
        return count
    t = count.detach().float().reshape(1)
    dist.all_reduce(t)
    return t[0]


def leave_group(ok: bool, timeout_s: float = TIMEOUT_S):
    """Leave a group joined by ``init_group`` once this rank's part is over
    (``ok``: it returned; else it raised). Leaving closes the rank's
    connections, and a slower rank still joining the group or in its last
    collective would then fail with the closed connection's error instead
    of its own. So, through the group's store, a rank that returned waits
    until every rank has returned or one has failed, and a rank that failed
    waits until every rank has joined. Rank 0, which serves a ``tcp://``
    group's store, leaves last. A failed rank of an NCCL group aborts its
    communicators rather than destroying them: NCCL's destroy waits for
    the other ranks, which may be inside a collective that waits for this
    one, and the launch would then see neither rank's error until the
    collective timeout. Raises when the others do not return within
    ``timeout_s``."""
    try:
        if dist.get_world_size() > 1:
            _meet_to_leave(ok, timeout_s)
    except RuntimeError:  # the store's errors, its timeout included
        if ok:
            raise
        # a failed rank's own error is the one to report
    finally:
        if not ok and dist.get_backend() == "nccl":
            # private and experimental in torch.distributed; on four H100s
            # a rank failed at set-up ended its launch with its own error
            # through it, where destroy hung the launch to its time limit
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()


def _meet_to_leave(ok: bool, timeout_s: float):
    store = dist.distributed_c10d._get_default_store()
    world, timeout = dist.get_world_size(), datetime.timedelta(
        seconds=timeout_s)
    if not ok:
        store.wait(["leave/all_joined"], timeout)
        store.set("leave/all_returned", "a rank failed")
    elif store.add("leave/returned", 1) == world:
        store.set("leave/all_returned", "")
    else:
        store.wait(["leave/all_returned"], timeout)
    if dist.get_rank() > 0:
        if store.add("leave/left", 1) == world - 1:
            store.set("leave/all_left", "")
    elif ok:
        store.wait(["leave/all_left"], timeout)


def _rank_main(index, fn, devices, init_method, backend, timeout_s, args):
    init_group(init_method, len(devices), index, devices[index],
               backend=backend, timeout_s=timeout_s)
    ok = False
    try:
        fn(index, devices[index], *args)
        ok = True
    finally:
        leave_group(ok, timeout_s)


def launch(fn, devices, init_method: str, args=(), *,
           timeout_s: float | None = None):
    """Run ``fn(rank, device, *args)`` in one spawned process per entry of
    ``devices``, each the rank of that index in a group (``backend_for``'s
    backend) that meets at ``init_method`` (a ``file://`` path that does not
    exist yet, or ``tcp://host:port``). Returns when every rank has
    returned; raises the failing rank's own error when one fails (the
    others are terminated) or when ``timeout_s`` passes first (all are
    killed). ``fn`` and ``args`` are
    pickled: ``fn`` must be a module-level function."""
    devices = [torch.device(d) for d in devices]
    backend = backend_for(devices)
    collective_s = TIMEOUT_S if timeout_s is None else timeout_s
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, devices, init_method, backend, collective_s,
                          tuple(args)),
        nprocs=len(devices), join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(devices)} ranks did not finish within "
                    f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
