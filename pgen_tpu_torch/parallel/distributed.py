"""Process-group glue: the port of ``pgen_tpu/parallel/distributed.py``
(``initialize_from_env``, ``run_distributed_filter``, the barrier).

One process per GPU under ``torch.distributed``: NCCL on CUDA, gloo on the
CPU. Rank r owns variant shard r of every block (``pipeline/mesh_filter.py``)
and runs on ``cuda:LOCAL_RANK``. The group comes from the arguments of
``initialize_from_env`` (pgen_tpu's names), else from the environment, as a
launcher sets it:

- pgen_tpu's variables: ``PGEN_TPU_COORDINATOR`` (host:port),
  ``PGEN_TPU_NUM_PROCS``, ``PGEN_TPU_PROC_ID``;
- torchrun's: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``;
- neither: no group at all. A lone process is rank 0 of 1 on its device,
  every gather is the local tensor and the barrier returns at once, as
  pgen_tpu's one-process mesh filter sets up no distributed runtime. (An
  explicit one-rank group, the caller's or a launcher's ``WORLD_SIZE=1``,
  still runs the collectives.)

``run_distributed_filter`` is pgen_tpu's multi-host filter: one process a
variant shard of the host filter (``parallel/shard.py``), each writing its
rows at their offsets of one shared file or its own part, then a barrier.
Its group only meets and waits (gloo, even on the card; the function says
why).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

log = get_logger("torch.distributed")

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); the older one warns where the newer exists.
all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def env_rank() -> int:
    """This process's rank as the environment gives it (0 when none does)."""
    return int(os.environ.get("RANK", os.environ.get("PGEN_TPU_PROC_ID", "0")))


def _group_spec(coordinator_address=None, num_processes=None, process_id=None):
    """(rank, world size, init method) of the group to join, or None when
    neither the arguments nor the environment name one. Each argument
    defaults to pgen_tpu's variable (``PGEN_TPU_COORDINATOR``,
    ``PGEN_TPU_NUM_PROCS``, ``PGEN_TPU_PROC_ID``), then to torchrun's
    (``MASTER_ADDR``/``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``,
    ``RANK``)."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("PGEN_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = env.get("PGEN_TPU_NUM_PROCS", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("PGEN_TPU_PROC_ID", env.get("RANK"))
    if num_processes is None or process_id is None:
        if coordinator_address is None:
            return None
        raise ValueError(
            f"coordinator {coordinator_address} named without a process count and id "
            "(num_processes/process_id, PGEN_TPU_NUM_PROCS/PGEN_TPU_PROC_ID or "
            "WORLD_SIZE/RANK)"
        )
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    return int(process_id), int(num_processes), init


def _rank_device(dev: torch.device, rank: int, world: int) -> torch.device:
    """The card of this rank: ``cuda:LOCAL_RANK``, else its rank modulo the
    visible cards when there are several ranks, else ``dev``; the CPU stays
    the CPU."""
    if dev.type != "cuda":
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else (
        rank % torch.cuda.device_count() if world > 1 else dev.index
    )
    return torch.device("cuda", index)


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> tuple:
    """Initialise the default process group; returns (rank, world_size,
    device). The group is the one the arguments name (pgen_tpu's), each
    defaulting to the environment (``_group_spec``: pgen_tpu's variables,
    then torchrun's). On CUDA each rank takes ``cuda:LOCAL_RANK`` (without
    LOCAL_RANK, its rank modulo the visible cards) and makes it current
    before any launch, over NCCL; ``device="cpu"`` uses gloo. When neither
    names ranks no group is made: (0, 1, device)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    spec = _group_spec(coordinator_address, num_processes, process_id)
    if spec is None:
        return 0, 1, dev
    rank, world, init = spec
    kwargs = {}
    dev = _rank_device(dev, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world, **kwargs)
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
    rank, world, dev = initialize_from_env(device=device)
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


def run_distributed_filter(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    block_variants: int = 1 << 16,
    shared_fs: bool = True,
    device="cuda",
    **init_kwargs,
):
    """Each process filters its variant shard; output order is stable.

    pgen_tpu's ``run_distributed_filter``, with the text made on ``device``.
    Call once per process: each joins the group (``init_kwargs``: pgen_tpu's
    ``coordinator_address``, ``num_processes`` and ``process_id``, each
    defaulting to ``PGEN_TPU_*``, then to torchrun's variables; none at all
    is one process of one shard), runs shard ``rank`` of ``world`` of
    ``parallel/shard.py``'s ``filter_to_vcf_sharded`` on its card
    (``cuda:LOCAL_RANK``, else its rank modulo the visible cards; or the
    CPU), and waits at a barrier so that none returns before the file is
    complete. With ``shared_fs`` every process writes its rows at their
    offsets of ``out_file`` (default ``{prefix}.pgen-rs.vcf``); otherwise
    each writes ``{out_file}.shard{rank}``, and the parts concatenate to
    the file in rank order. Returns this shard's ``FilterResult``, its
    timer also holding the ``process_group`` (joining) and ``barrier``
    stages.

    The group is gloo even on the card: no tensor crosses between the
    processes (every one derives each shard's offsets from the metadata),
    it only meets and waits, and NCCL refuses two ranks on one card. A
    group the caller already made is used and left alone; one this call
    made is destroyed after the barrier, so that the process can call
    again and exit cleanly.
    """
    from pgen_tpu_torch.parallel.shard import filter_to_vcf_sharded

    group = StageTimer()
    own = not dist.is_initialized()
    with group.stage("process_group"):
        if not own:
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            spec = _group_spec(**init_kwargs)
            rank, world = (0, 1) if spec is None else spec[:2]
            if spec is not None:
                dist.init_process_group("gloo", init_method=spec[2], rank=rank,
                                        world_size=world)
    try:
        dev = _rank_device(resolve_device(device), rank, world)
        log.info("distributed filter: process %d/%d on %s", rank, world, dev)
        if out_file is None:
            out_file = f"{pfile_prefix}.pgen-rs.vcf"
        target = str(out_file) if shared_fs else f"{out_file}.shard{rank}"
        result = filter_to_vcf_sharded(
            pfile_prefix,
            var_query=var_query,
            sam_query=sam_query,
            out_file=target,
            provider=provider,
            num_shards=world,
            shard_index=rank,
            block_variants=block_variants,
            standalone=not shared_fs,
            device=str(dev),
        )
        # no process returns before the file is complete everywhere
        with group.stage("barrier"):
            if dist.is_initialized() and world > 1:
                if dist.get_backend() == "nccl":
                    dist.barrier(device_ids=[torch.cuda.current_device()])
                else:
                    dist.barrier()
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    result.timer.stages = {**group.stages, **result.timer.stages}
    return result
