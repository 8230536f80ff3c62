"""The rank-local steps of the device provider and of the variant-sharded
analytics: the port of ``pgen_tpu/parallel/mesh.py`` and of the mesh steps'
collectives.

The workload has one long axis, the variants. Every block of ``vb`` rows
splits into ``world`` shards of ``vb // world`` rows, and rank r holds shard
r (the sample axis stays whole on every rank). Per block, each rank runs on
its own card:

    predicate   mask = lower_device(expr, columns) & valid, or the host
                mask & valid
    compact     kept = mask.nonzero() (ascending, so the stable kept-first
                order of pgen_tpu's argsort(~mask, stable=True)), then an
                index_select of the kept rows
    kernel      GT text of the kept rows only: K2 genotype_text (every
                sample) or K3 subset_text_from_packed (kept samples)
    fetch       all-gather of the kept counts (int64) and of the shard
                masks (uint8): every rank learns the whole block's mask,
                hence every kept row's output offset, so the ordered write
                is arithmetic; then both to the host (a lone process
                without a process group gathers nothing)

The genotype text never crosses ranks. The plane form of pgen_tpu
(``_local_pipeline_planes``) exists because Mosaic cannot interleave lanes
and is not ported; K2 writes interleaved text.

The analytics (``glm``, ``score``, ``king``, ``genome``, ``pca``) shard the
kept variants instead: rank r takes the r-th contiguous slice
(``shard_range``, sizes differing by at most one), gathers, decodes and
multiplies only its own rows, and the ranks combine their results with one
collective per result where pgen_tpu's ``shard_map`` steps ``psum``
(``all_reduce_sum``) or keep per-variant outputs sharded
(``all_gather_rows``, rank order). Every collective runs at the same call
site on every rank, an empty shard passing zeros of its shape and dtype, so
no rank waits on one that skipped it. ``variant_mesh`` holds a run's group
and reports each rank's card and rows. No 0xFF pad rows are needed: they
are a ``shard_map`` requirement; a gather pads the shards to the largest
and trims.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from pgen_tpu_torch.utils.timer import Stage, StageTimer
from pgen_tpu_torch.device import synchronize
from pgen_tpu_torch.ops.gt_text import genotype_text, subset_text_from_packed
from pgen_tpu_torch.parallel.distributed import all_gather, barrier, process_group
from pgen_tpu_torch.query.compile_device import lower_device


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Zero-pad along axis so the dim divides the number of ranks."""
    pad = (-arr.shape[axis]) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def _gather_shards(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's equally sized ``local``, concatenated in rank order; a
    lone process without a process group is the only rank."""
    if not dist.is_initialized():
        return local
    out = torch.empty((dist.get_world_size(group) * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    all_gather(out, local.contiguous(), group=group)
    return out


def mesh_pipeline_step(packed, pred, valid, num_samples, expr=None, sel=None,
                       group=None, timer: StageTimer | None = None):
    """One rank's step over its shard of a block, with the collectives.

    ``packed`` (per, R) u8 records and ``valid`` (per,) bool (False on pad
    rows) on this rank's device. With ``expr`` (a parsed AST), ``pred`` maps
    column name -> (mat (per, W) u8, lens (per,) int32) and the predicate is
    lowered on the device; without, ``pred`` is the (per,) bool host mask.
    ``sel`` (K,) int32 kept-sample ids, or None for every one of
    ``num_samples`` samples. Each stage ends synchronised, timed on
    ``timer``'s predicate, compact, kernel and fetch stages.

    Returns (text (kept, 4*K or 4*num_samples) u8 on the device, block mask
    (world*per,) bool numpy, counts (world,) int64 numpy).
    """
    timer = timer or StageTimer()
    dev = packed.device
    with timer.stage("predicate"):
        mask = (lower_device(expr, pred) if expr is not None else pred) & valid
        synchronize(dev)
    with timer.stage("compact", nbytes=packed.numel()):
        kept = mask.nonzero()[:, 0]
        rows = packed.index_select(0, kept)
        synchronize(dev)
    with timer.stage("kernel") as st:
        if sel is None:
            text = genotype_text(rows, num_samples)
        else:
            text = subset_text_from_packed(rows, sel)
        synchronize(dev)
        st.bytes_moved += text.numel()
    with timer.stage("fetch"):
        count = torch.tensor([kept.numel()], dtype=torch.int64, device=dev)
        counts = _gather_shards(count, group).cpu().numpy()
        block_mask = _gather_shards(mask.to(torch.uint8), group).cpu().numpy().astype(bool)
    return text, block_mask, counts


def _offsets(counts: np.ndarray) -> np.ndarray:
    return np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)


def build_sharded_filter_step(group=None):
    """(packed, mask) -> (text, counts, offsets) on this rank's shard: the
    kept rows' GT text of all 4R slots, every rank's kept count and its
    first kept row's global offset (pgen_tpu's ``build_sharded_filter_step``;
    its text keeps the padded rows after the kept ones, this one only the
    kept)."""

    def step(packed, mask):
        text, _, counts = mesh_pipeline_step(
            packed, mask, torch.ones_like(mask), 4 * packed.shape[1], group=group
        )
        return text, counts, _offsets(counts)

    return step


def build_sharded_predicate_and_filter_step(expr_ast, col_names, group=None):
    """(packed, cols) -> (text, counts, offsets) with the predicate lowered on
    the device over ``cols`` ({name: (mat, lens)} tensors of this rank's
    rows; ``col_names`` as in pgen_tpu, which orders its sharded pytree)."""

    def step(packed, cols):
        valid = torch.ones(packed.shape[0], dtype=torch.bool, device=packed.device)
        pred = valid if expr_ast is None else {name: cols[name] for name in col_names}
        text, _, counts = mesh_pipeline_step(
            packed, pred, valid, 4 * packed.shape[1], expr=expr_ast, group=group
        )
        return text, counts, _offsets(counts)

    return step


# -- the analytics' shards and collectives ----------------------------------


class SingleRankOnly(ValueError):
    """A run that pgen_tpu has no mesh step for (it runs on one device
    there), asked of several ranks; the CLI exits 2 with the message."""


def ranks_refusal(what: str, world: int, why: str) -> str:
    """The message that refuses ``what`` under ``world`` ranks: pgen_tpu
    runs ``why`` on one device, with no mesh step."""
    return (f"{what} under {world} ranks: pgen_tpu runs {why} on one device (no mesh step), "
            "so the port runs it on one GPU only; glm (linear, --modifier), score, king, "
            "genome and pca run over variant shards on 1-4 GPUs (ROADMAP §1 item 17)")


def shard_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """Rows [lo, hi) of rank's contiguous shard of n rows: the first n %
    world ranks take one row more than the rest."""
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def _timed(timer: StageTimer | None, name: str, nbytes: int):
    return timer.stage(name, nbytes) if timer is not None else contextlib.nullcontext()


def all_reduce_sum(values, dev: torch.device, timer: StageTimer | None = None) -> list:
    """Each of ``values`` (numpy arrays, ints or torch tensors, the same
    shapes and dtypes on every rank) summed over the ranks of the default
    process group, one all_reduce each, timed as ``timer``'s all_reduce
    stage. An array or int goes through ``dev`` (the rank's card, or the CPU
    for gloo) and comes back as an array or int; a tensor is summed in place
    on its own device. Without a process group each value is its own sum."""
    values = list(values)
    if not dist.is_initialized():
        return values
    nbytes = sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                 else np.asarray(v).nbytes for v in values)
    out = []
    with _timed(timer, "all_reduce", nbytes):
        for v in values:
            if isinstance(v, torch.Tensor):
                if v.numel():
                    dist.all_reduce(v)
                out.append(v)
                continue
            a = np.asarray(v)
            t = torch.tensor(a.reshape(-1), device=dev)
            if t.numel():
                dist.all_reduce(t)
            total = t.cpu().numpy().reshape(a.shape)
            out.append(total if isinstance(v, np.ndarray) else total.item())
    return out


def broadcast_from_rank0(t: torch.Tensor, timer: StageTimer | None = None) -> torch.Tensor:
    """``t`` made rank 0's on every rank of the default process group, in
    place (timed as ``timer``'s broadcast stage); without a group, ``t``."""
    if dist.is_initialized():
        with _timed(timer, "broadcast", t.numel() * t.element_size()):
            dist.broadcast(t, src=0)
    return t


def all_gather_rows(values, dev: torch.device, timer: StageTimer | None = None) -> list:
    """Each of ``values`` (numpy arrays whose first axis is this rank's rows,
    the same row count for all of them, the same trailing shape and dtype on
    every rank): every rank's rows concatenated in rank order, on every
    rank, one all_gather each after one of the row counts; the shards are
    padded to the largest and trimmed. Timed as ``timer``'s all_gather
    stage (bytes received). Without a process group each value is whole."""
    values = [np.ascontiguousarray(v) for v in values]
    if not dist.is_initialized():
        return values
    world = dist.get_world_size()
    row_bytes = sum(int(np.prod(v.shape[1:])) * v.itemsize for v in values)
    with _timed(timer, "all_gather", 0) as st:
        sizes = torch.empty(world, dtype=torch.int64, device=dev)
        all_gather(sizes, torch.tensor([len(values[0])], dtype=torch.int64, device=dev))
        sizes = sizes.tolist()
        per = max(sizes)
        out = []
        for v in values:
            src = torch.from_numpy(v).to(dev)
            local = src.new_zeros((per, *v.shape[1:]))
            local[: len(v)] = src
            whole = src.new_empty((world * per, *v.shape[1:]))
            if whole.numel():
                all_gather(whole, local)
            whole = whole.cpu().numpy()
            out.append(np.concatenate([whole[r * per : r * per + sizes[r]] for r in range(world)]))
        if st is not None:
            st.bytes_moved += world * per * row_bytes
    return out


# the timer stages of the collectives
COLLECTIVE_STAGES = ("all_reduce", "all_gather", "broadcast")


@dataclass
class VariantMesh:
    """One rank of a variant-sharded analytics run (``variant_mesh``): its
    rank, the number of ranks, its device, the run's timer and the shards it
    took."""

    rank: int
    world: int
    device: torch.device
    timer: StageTimer
    shards: list = field(default_factory=list)

    def shard(self, n: int, stage: str) -> tuple[int, int]:
        """This rank's rows [lo, hi) of n (``shard_range``), which the timer's
        ``stage`` processes; both go into the ranks' report."""
        lo, hi = shard_range(n, self.rank, self.world)
        self.shards.append((lo, hi, n, stage))
        return lo, hi

    def report_ranks(self) -> None:
        """Every rank's card, rows, collectives' time and device stage
        (which holds the collectives made inside it), gathered into rank 0's
        timer as one stage a rank (``--stats`` prints them). The run calls it
        on every rank after its last collective and before rank 0 writes, so
        that a rank 0 that fails while writing (a broken pipe) leaves no rank
        waiting. Without a process group it does nothing."""
        if not dist.is_initialized():
            return
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "host")
        rows = "; ".join(f"[{lo}, {hi}) of {n}" for lo, hi, n, _ in self.shards) or "none"
        stage = self.shards[-1][3] if self.shards else None
        st = self.timer.stages.get(stage, Stage())
        waits = "".join(f"; {c} {self.timer.stages[c].seconds * 1e3:.1f} ms"
                        for c in COLLECTIVE_STAGES if c in self.timer.stages)
        line = (f"rank {self.rank} on {self.device} ({name}), rows {rows}{waits}; {stage}",
                st.seconds, st.bytes_moved, st.calls)
        lines = [None] * self.world
        dist.all_gather_object(lines, line)
        if self.rank == 0:
            for label, seconds, nbytes, calls in lines:
                self.timer.stages[label] = Stage(seconds, nbytes, calls)


@contextlib.contextmanager
def variant_mesh(device, timer: StageTimer):
    """The default process group of an analytics run (``process_group``:
    the caller's, one made from the environment, or none for a lone
    process), its set-up until every rank has joined (a barrier, so that
    no collective stage holds another rank's start) and its teardown timed
    as ``timer``'s process_group stage. Yields a ``VariantMesh``. No rank
    waits for another on exit: after the last collective only rank 0 has
    work left."""
    with contextlib.ExitStack() as stack:
        with timer.stage("process_group"):
            rank, world, dev = stack.enter_context(process_group(device))
            barrier(dev)
        yield VariantMesh(rank, world, dev, timer)
        with timer.stage("process_group"):
            stack.close()
