"""Process-group glue for the device provider: the port of
``pgen_tpu/parallel/distributed.py`` (``initialize_from_env``, the barrier).

One process per GPU under ``torch.distributed``: NCCL on CUDA, gloo on the
CPU. Rank r owns variant shard r of every block (``pipeline/mesh_filter.py``)
and runs on ``cuda:LOCAL_RANK``. The group comes from the environment, as a
launcher sets it:

- torchrun: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``;
- pgen_tpu's variables: ``PGEN_TPU_COORDINATOR`` (host:port),
  ``PGEN_TPU_NUM_PROCS``, ``PGEN_TPU_PROC_ID``;
- neither: no group at all. A lone process is rank 0 of 1 on its device,
  every gather is the local tensor and the barrier returns at once, as
  pgen_tpu's one-process mesh filter sets up no distributed runtime. (An
  explicit one-rank group, the caller's or a launcher's ``WORLD_SIZE=1``,
  still runs the collectives.)

pgen_tpu's ``run_distributed_filter`` (one jax process a shard of the
host filter) is not ported: no entry point of pgen_tpu calls it, and the
port's one process a shard is ``filter --shards N --shard-index I``
(``parallel/shard.py``).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from pgen_tpu_torch.device import resolve_device

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); the older one warns where the newer exists.
all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def env_rank() -> int:
    """This process's rank as the environment gives it (0 when none does)."""
    return int(os.environ.get("RANK", os.environ.get("PGEN_TPU_PROC_ID", "0")))


def initialize_from_env(device="cuda") -> tuple:
    """Initialise the default process group from the environment; returns
    (rank, world_size, device). On CUDA each rank takes ``cuda:LOCAL_RANK``
    (without LOCAL_RANK, its rank modulo the visible cards) and makes it
    current before any launch; ``device="cpu"`` uses gloo. An environment
    that names no ranks makes no group: (0, 1, device)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kwargs = {"init_method": "env://"}
    elif "PGEN_TPU_COORDINATOR" in os.environ:
        rank, world = int(os.environ["PGEN_TPU_PROC_ID"]), int(os.environ["PGEN_TPU_NUM_PROCS"])
        kwargs = {"init_method": f"tcp://{os.environ['PGEN_TPU_COORDINATOR']}"}
    else:
        return 0, 1, dev
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else (
            rank % torch.cuda.device_count() if world > 1 else dev.index
        )
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    return rank, world, dev


@contextlib.contextmanager
def process_group(device="cuda"):
    """Yield (rank, world_size, device) of the default process group: the
    caller's when one is initialised (its device is this rank's card, or the
    CPU for gloo), else one initialised from the environment here and
    destroyed on exit. A lone process, whose environment names no ranks,
    gets (0, 1, device) and no group."""
    if dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda" and dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        yield dist.get_rank(), dist.get_world_size(), dev
        return
    rank, world, dev = initialize_from_env(device)
    try:
        yield rank, world, dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def barrier(dev: torch.device) -> None:
    """Wait for every rank (nothing to wait for without a group or in a
    one-rank group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)
