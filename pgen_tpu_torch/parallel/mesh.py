"""The rank-local block step of the device provider: the port of
``pgen_tpu/parallel/mesh.py``.

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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.device import synchronize
from pgen_tpu_torch.ops.gt_text import genotype_text, subset_text_from_packed
from pgen_tpu_torch.parallel.distributed import all_gather
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
