"""Filter to VCF with the device provider on one or more GPUs: the port of
``pgen_tpu/pipeline/mesh_filter.py`` (``filter --provider device``).

One process per GPU (``parallel/distributed.py``); a lone process, whose
environment names no ranks, is rank 0 of 1 and makes no process group, as
pgen_tpu's one-process mesh filter sets up no distributed runtime. Per block of
``vb`` rows (``vb`` a multiple of the world size; rank d owns rows
[d*per, (d+1)*per) of every block):

    process_group  (once) the group's set-up and teardown, when the call
                makes it (a lone process makes none: near zero)
    stage_read  a reader thread gathers this rank's rows (only its own)
                into one of two staging tensors, pinned on CUDA, while the
                main thread works on the block before
    h2d         the rows, the valid flags and, for a device-lowered
                predicate, this rank's slice of each column tensor
    predicate, compact, kernel, fetch
                the rank-local step and its all-gathers
                (``parallel/mesh.py``)
    d2h         the kept rows' text into a pinned host buffer
    assemble    pvar prefixes + text + newline (the C++ row assembler)
    compress    BGZF, for a .gz output, in slices across the host's cores
                (the same members as one call)
    pwrite      the rank's rows at their arithmetic offset; for .gz an
                append (one rank) or a part file per (block, rank), which
                rank 0 merges in order after a barrier

Every device stage ends synchronised, so each StageTimer stage is its own
time. The predicate route is decided before the loop, from the expression
alone: a variant query over ``.pvar`` columns inside the device subset
lowers on the device; anything else (GT_* or virtual variables, builtins
such as the ``num(POS)`` of a region flag, a GT_* sample query, a construct
outside the subset) is evaluated on the host by the port's
``compute_masks`` (its genotype counts on the device), and only the kept
rows are staged. Output bytes equal pgen_tpu's for every world size; .gz
bytes equal pgen_tpu's mesh over as many devices, at the same block size.
"""

from __future__ import annotations

import contextlib
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter_host import (
    BGZF_EOF,
    DEFAULT_BLOCK_VARIANTS,
    FilterResult,
    _assemble_rows_numpy,
    _pwrite_all,
    _write_all,
    emit_tabix_index,
    materialize_prefixes,
)
from pgen_tpu_torch.pipeline.vcf import DEFAULT_SOURCE_TAG, vcf_header_bytes
from pgen_tpu_torch.query import ExprError, compile_predicate, parse
from pgen_tpu_torch.query.ast import variables
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.device import synchronize
from pgen_tpu_torch.parallel.distributed import barrier, process_group
from pgen_tpu_torch.parallel.mesh import mesh_pipeline_step
from pgen_tpu_torch.pipeline.filter import _bgzf, compute_masks
from pgen_tpu_torch.query.compile_device import (
    DeviceFallback,
    columns_to_device,
    lower_device,
)

log = get_logger("torch.mesh_filter")

ROUTE_DEVICE = "device-lowered"
ROUTE_HOST = "host mask"
ROUTE_FALLBACK = "host mask after DeviceFallback"


@dataclass
class MeshFilterResult(FilterResult):
    """pgen_tpu's FilterResult and the predicate route that ran (one of
    ROUTE_DEVICE, ROUTE_HOST, ROUTE_FALLBACK)."""

    route: str = ROUTE_HOST


def _device_expr_columns(var_node, pvar):
    """{name: (mat, lens)} padded columns of every variable of a variant
    expression over all pvar rows, or None when there is no expression or
    it names anything that is not a ``.pvar`` column (GT_* statistics,
    virtual INFO_* columns): the host mask route."""
    if var_node is None:
        return None
    cols = {}
    for name in variables(var_node):
        if name not in pvar.columns:
            return None
        mat, lens = pvar.get_column_padded(name)
        cols[name] = (mat, np.asarray(lens, dtype=np.int32))
    return cols or None


def _gz_part_path(out_file: str, bi: int, d: int) -> str:
    return f"{out_file}.mesh.b{bi:06d}.d{d:04d}.part"


def _merge_gz_parts(out_file: str, header_bytes: bytes, rank: int, dev) -> int:
    """Multi-rank BGZF finish: after a barrier (every part file exists),
    rank 0 writes the compressed header, the parts in (block, rank) order
    and the EOF marker. BGZF members concatenate losslessly. Returns the
    bytes rank 0 wrote (0 on the other ranks)."""
    from pgen_tpu_torch.native import native

    barrier(dev)
    if rank != 0:
        return 0
    parts = sorted(glob.glob(f"{out_file}.mesh.b*.part"))
    fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        comp = native.bgzf_compress(np.frombuffer(header_bytes, dtype=np.uint8))
        _write_all(fd, memoryview(comp))
        total = len(comp)
        for part in parts:
            with open(part, "rb") as f:
                while chunk := f.read(8 << 20):
                    _write_all(fd, memoryview(chunk))
                    total += len(chunk)
        _write_all(fd, memoryview(BGZF_EOF))
        total += len(BGZF_EOF)
    finally:
        os.close(fd)
    for part in parts:
        os.unlink(part)
    return total


def filter_to_vcf_mesh(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    source_tag: str = DEFAULT_SOURCE_TAG,
    index: bool = False,
    index_format: str = "auto",
) -> MeshFilterResult:
    """Filter a pgen fileset to a VCF with the device provider, as this
    rank of the default process group (``device`` "cuda", which must be
    available, or "cpu" over gloo; without a group, one made from the
    environment for the call where it names ranks, else this process alone
    with no group).

    Same arguments and output bytes as pgen_tpu's ``filter_to_vcf_mesh``
    (``device`` in place of its ``mesh``): ``out_file`` defaults to
    ``{prefix}.pgen-rs.vcf``, a ``.gz`` name writes BGZF, ``index`` (``.gz``
    only) a tabix index, on rank 0. Every rank returns once the output is
    complete.
    """
    if block_variants < 1:
        raise ValueError(f"block_variants must be positive, got {block_variants}")
    timer = StageTimer()
    with contextlib.ExitStack() as group:
        # a group made here (NCCL sets up its communicator eagerly) and its
        # teardown are part of the call's wall
        with timer.stage("process_group"):
            rank, world, dev = group.enter_context(process_group(device))
        result = _filter(
            pfile_prefix, var_query, sam_query, out_file, rank, world, dev,
            block_variants, source_tag, index, index_format, timer,
        )
        with timer.stage("process_group"):
            barrier(dev)
            group.close()
    log.info("mesh filter (rank %d of %d, %s, %s): %s", rank, world, dev, result.route,
             timer.report())
    return result


def _filter(pfile_prefix, var_query, sam_query, out_file, rank, world, dev,
            block_variants, source_tag, index, index_format, timer) -> MeshFilterResult:
    from pgen_tpu_torch.native import HAVE_NATIVE

    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    gz = out_file.endswith(".gz")
    if gz and not HAVE_NATIVE:
        raise ValueError("bgzf (.gz) output requires the native runtime (C++ toolchain)")
    if index and not gz:
        raise ValueError("--index requires a .gz (BGZF) output file")

    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")
    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    expected = 12 + header.num_variants * rec
    if pgen_mm.shape[0] < expected:
        raise ValueError(
            f"{pfile_prefix}.pgen is {pgen_mm.shape[0]} bytes; header implies {expected}"
        )
    records = pgen_mm[12:expected].reshape(header.num_variants, rec)
    var_node = parse(var_query) if isinstance(var_query, str) else var_query

    with timer.stage("predicates"):
        cols, route = _device_expr_columns(var_node, pvar), ROUTE_DEVICE
        if cols is not None and isinstance(sam_query, str):
            # a GT_* sample query (--mind) needs compute_masks' per-sample
            # counts: host masks, as in pgen_tpu
            from pgen_tpu_torch.ops.gt_stats_host import GT_VARIABLE_NAMES

            if variables(parse(sam_query)) & set(GT_VARIABLE_NAMES):
                cols = None
        if cols is not None:
            # pgen_tpu meets a construct outside the device subset while its
            # first block traces; the port lowers eagerly, so it lowers once
            # over zero rows to choose the route before the loop
            try:
                lower_device(var_node, columns_to_device(
                    {k: (m[:0], ln[:0]) for k, (m, ln) in cols.items()}, dev))
            except DeviceFallback:
                cols, route = None, ROUTE_FALLBACK
            except ExprError:
                # the host compiler below raises its own ExprError for the
                # same expression (over zero rows it evaluates nothing, as
                # pgen_tpu then runs no block)
                cols = None
        if cols is None:
            route = route if route == ROUTE_FALLBACK else ROUTE_HOST
            host_var_mask, sam_mask = compute_masks(
                var_node, sam_query, pvar, psam, header, records, dev
            )
        else:
            sam_mask = compile_predicate(sam_query, psam)
    sam_idx = np.flatnonzero(sam_mask)
    all_iids = psam.get_column_strs("IID")
    sample_ids = [all_iids[i] for i in sam_idx]
    n_kept = len(sam_idx)
    keep_all = n_kept == psam.num_rows == header.num_samples
    if n_kept and int(sam_idx[-1]) // 4 >= rec:
        raise ValueError(
            f"{pfile_prefix}.psam row {int(sam_idx[-1])} is beyond the pgen's "
            f"{header.num_samples}-sample records"
        )
    nvar_meta = pvar.num_rows
    if nvar_meta > header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar row {header.num_variants} is beyond the pgen's "
            f"{header.num_variants} variant records"
        )
    header_bytes = vcf_header_bytes(pvar, sample_ids, source_tag)
    line_starts_all, line_ends_all = pvar.row_line_spans()
    row_fixed = 4 * n_kept + 1
    text_cols = 4 * n_kept

    # host route: only the kept rows are staged, so every staged row is kept
    universe = np.flatnonzero(host_var_mask) if cols is None else None
    total_rows = len(universe) if universe is not None else nvar_meta
    vb = min(block_variants, max(total_rows, 1))
    vb += (-vb) % world
    per = vb // world

    cuda = dev.type == "cuda"
    staging = [torch.empty((per, rec), dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
    text_host = torch.empty((per, text_cols), dtype=torch.uint8, pin_memory=True) if cuda else None
    sel = None if keep_all else torch.from_numpy(sam_idx.astype(np.int32)).to(dev)

    def stage_block(bi: int, lo: int):
        """This rank's rows of block [lo, lo + vb) into staging[bi % 2], its
        valid flags and column slices; the whole block's row ids and pvar
        line spans (every rank needs every kept row's span for its
        offsets)."""
        hi = min(lo + vb, total_rows)
        a = min(lo + rank * per, hi)
        b = min(a + per, hi)
        rows_blk = universe[lo:hi] if universe is not None else np.arange(lo, hi)
        local = rows_blk[a - lo : b - lo]
        packed = staging[bi % 2].numpy()
        packed[: b - a] = records[local] if universe is not None else records[a:b]
        packed[b - a :] = 0
        valid = np.zeros(per, dtype=bool)
        valid[: b - a] = True
        col_slices = None
        if cols is not None:
            col_slices = {}
            for name, (mat, lens) in cols.items():
                m = np.zeros((per, mat.shape[1]), dtype=np.uint8)
                m[: b - a] = mat[a:b]
                ln = np.zeros(per, dtype=np.int32)
                ln[: b - a] = lens[a:b]
                col_slices[name] = (m, ln)
        return (hi - lo, bi % 2, valid, col_slices, rows_blk,
                line_starts_all[rows_blk], line_ends_all[rows_blk])

    state = {"byte_base": len(header_bytes), "rows": 0, "gz_bytes": 0}
    kept_rows, kept_ls, kept_le = [], [], []

    def write_rows(bi, n, text, block_mask, counts, rows_blk, ls_blk, le_blk, fd):
        """This rank's kept rows of block bi, at their offsets."""
        from pgen_tpu_torch.native import native

        kept_blk = np.flatnonzero(block_mask[:n])
        nk = len(kept_blk)
        ls, le = ls_blk[kept_blk], le_blk[kept_blk]
        if index:
            kept_rows.append(rows_blk[kept_blk])
            kept_ls.append(ls)
            kept_le.append(le)
        psz = np.zeros(nk + 1, dtype=np.int64)
        np.cumsum(le - ls + 3, out=psz[1:])
        c = int(counts[rank])
        k0 = int(counts[:rank].sum())  # kept rows of the shards before this one
        if c:
            with timer.stage("d2h", nbytes=text.numel()):
                if cuda:
                    text_host[:c].copy_(text, non_blocking=True)
                    synchronize(dev)
                    text_np = text_host[:c].numpy()
                else:
                    text_np = text.numpy()
            bstart = state["byte_base"] + int(psz[k0]) + k0 * row_fixed
            nbytes = int(psz[k0 + c] - psz[k0]) + c * row_fixed
            scratch = np.empty(nbytes, dtype=np.uint8)
            with timer.stage("assemble", nbytes=nbytes):
                pbuf, poff = materialize_prefixes(pvar.data_buffer, ls[k0 : k0 + c], le[k0 : k0 + c])
                if HAVE_NATIVE:
                    wrote = native.assemble_rows_buf(text_np, pbuf, poff, scratch)
                else:
                    wrote = _assemble_rows_numpy(text_np, pbuf, poff, scratch)
            if wrote != nbytes:
                raise RuntimeError(f"block {bi} rank {rank} took {wrote} bytes, layout says {nbytes}")
            if gz:
                with timer.stage("compress", nbytes=nbytes):
                    comp = _bgzf(pool, threads, scratch)
                comp_bytes = sum(p.nbytes for p in comp)
                with timer.stage("pwrite", nbytes=comp_bytes):
                    if world == 1:
                        for p in comp:
                            _write_all(fd, memoryview(p))
                    else:
                        part = _gz_part_path(out_file, bi, rank)
                        with open(part + ".tmp", "wb") as f:
                            for p in comp:
                                f.write(p)
                        os.replace(part + ".tmp", part)
                state["gz_bytes"] += comp_bytes
            else:
                with timer.stage("pwrite", nbytes=nbytes):
                    _pwrite_all(fd, scratch, bstart)
        state["byte_base"] += int(psz[-1]) + nk * row_fixed
        state["rows"] += nk

    if gz:
        # compressed sizes are not arithmetic: one rank appends BGZF members
        # in row order, several write part files that rank 0 merges
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644) if world == 1 else -1
    else:
        # no O_TRUNC: every rank opens the same file and pwrites its rows; a
        # late opener must not wipe an early writer's bytes. The ftruncate
        # below (the same size on every rank) trims any stale tail.
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT, 0o644)
    reader = ThreadPoolExecutor(1, thread_name_prefix="pgen-stage")
    threads = os.cpu_count() or 1
    pool = ThreadPoolExecutor(threads, thread_name_prefix="pgen-bgzf")
    try:
        if gz and world == 1:
            from pgen_tpu_torch.native import native

            comp = native.bgzf_compress(np.frombuffer(header_bytes, dtype=np.uint8))
            _write_all(fd, memoryview(comp))
            state["gz_bytes"] += len(comp)
        elif not gz:
            _pwrite_all(fd, header_bytes, 0)
        block_los = list(range(0, total_rows, vb))
        staged = reader.submit(stage_block, 0, 0) if block_los else None
        for bi in range(len(block_los)):
            with timer.stage("stage_read"):
                n, slot, valid, col_slices, rows_blk, ls_blk, le_blk = staged.result()
            if bi + 1 < len(block_los):
                staged = reader.submit(stage_block, bi + 1, block_los[bi + 1])
            with timer.stage("h2d", nbytes=per * rec):
                packed_d = staging[slot].to(dev, non_blocking=True)
                valid_d = torch.from_numpy(valid).to(dev)
                pred_d = valid_d if col_slices is None else columns_to_device(col_slices, dev)
                synchronize(dev)
            text, block_mask, counts = mesh_pipeline_step(
                packed_d, pred_d, valid_d, header.num_samples,
                expr=None if cols is None else var_node, sel=sel, timer=timer,
            )
            write_rows(bi, n, text, block_mask, counts, rows_blk, ls_blk, le_blk, fd)
        if gz and world == 1:
            _write_all(fd, memoryview(BGZF_EOF))
            state["gz_bytes"] += len(BGZF_EOF)
        elif gz:
            with timer.stage("pwrite"):
                state["gz_bytes"] = _merge_gz_parts(out_file, header_bytes, rank, dev)
        else:
            os.ftruncate(fd, state["byte_base"])
    finally:
        reader.shutdown(wait=True, cancel_futures=True)
        pool.shutdown(wait=True)
        if fd >= 0:
            os.close(fd)

    if index and rank == 0:
        var_idx = np.concatenate(kept_rows) if kept_rows else np.zeros(0, dtype=np.int64)
        ls_all = np.concatenate(kept_ls) if kept_ls else np.zeros(0, dtype=np.int64)
        le_all = np.concatenate(kept_le) if kept_le else np.zeros(0, dtype=np.int64)
        psz = np.zeros(len(var_idx) + 1, dtype=np.int64)
        np.cumsum(le_all - ls_all + 3, out=psz[1:])
        with timer.stage("index"):
            emit_tabix_index(out_file, pvar, var_idx, psz, row_fixed, len(header_bytes),
                             fmt=index_format)

    return MeshFilterResult(
        out_path=out_file,
        num_variants_kept=state["rows"],
        num_samples_kept=n_kept,
        bytes_written=state["gz_bytes"] if gz else state["byte_base"],
        timer=timer,
        route=route,
    )
