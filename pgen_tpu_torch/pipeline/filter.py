"""Filter a pgen fileset to VCF on one GPU: the port of pgen_tpu's
``device`` provider (``pgen_tpu/pipeline/filter.py:_emit_block``).

Everything but the genotype text is the port's copy of pgen_tpu's host
code (``pipeline/filter_host.py``, ``formats/``, ``query/``, ``native/``):
``derive_row_layout`` (metadata, predicates, the byte layout of every output
row), ``_gather_rows``, ``materialize_prefixes``, the C++ row assembler
``native.assemble_rows_buf``, BGZF and tabix. With ``provider="auto"``
this path's predicates run on the ``native`` provider, or ``numpy`` without
a C++ toolchain. ``compute_masks`` below is the device provider's
(``--provider device``): pgen_tpu's, with its genotype counts made on the
device (K8, K9, K14). ``derive_row_layout`` and ``duplicated_ids`` below
are the copy's two functions with those masks for ``provider="device"``
(and the copy's own for any other provider); the sharded filters, the
merged ``.vcf.gz`` index and ``--rm-dup error|list`` take them, so that
``--provider device`` counts ``GT_*`` on the card on every path.

The records are the memory-mapped ``.pgen`` matrix; what reaches the
device is each block's kept rows, copied into a staging tensor. Per block:

  gather    host gather of the kept rows into the staging tensor (pinned
            host memory when the device is CUDA)
  h2d       copy to the device
  kernel    keep-all: genotype_text (K2); kept samples: subset_text_from_packed
            (K3) with the sample ids resident on the device
  d2h       copy of the text to a pinned host buffer
  assemble  pvar prefixes + text + newline into the output (mmap or scratch)
  write     fd sink, compressed to BGZF for a .gz output

The loop is synchronous: each stage ends before the next starts, so the
StageTimer report attributes the time honestly. With ``emit_threads`` T > 1
(``--threads``, the mapped output only, as in pgen_tpu) T host threads run
that loop over disjoint blocks into disjoint ranges of the mapped output,
each with its own staging and text buffers and its own CUDA stream, so one
thread's assembly overlaps another's copies and kernel; each thread keeps
its own StageTimer, summed into the report after the loop, which one
``emit`` stage spans. The BGZF/fd branch keeps one ordered loop.
Overlapping the stages of one loop on two streams is later work. Output
bytes equal pgen_tpu's for every provider and thread count.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline import filter_host
from pgen_tpu_torch.pipeline.filter_host import (
    BGZF_EOF,
    DEFAULT_BLOCK_VARIANTS,
    FilterResult,
    RowLayout,
    _assemble_rows_numpy,
    _can_mmap,
    _gather_rows,
    _resolve_provider,
    _write_all,
    emit_tabix_index,
    materialize_prefixes,
)
from pgen_tpu_torch.pipeline.vcf import DEFAULT_SOURCE_TAG, vcf_header_bytes
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import Stage, StageTimer
from pgen_tpu_torch.device import resolve_device, synchronize
from pgen_tpu_torch.ops.gt_text import genotype_text, subset_text_from_packed

log = get_logger("torch.filter")

# BGZF compresses 65,280-byte input blocks independently, so a buffer split
# on multiples of it compresses in parallel to the same bytes as one call.
_BGZF_INPUT_BLOCK = 65280


class _BlockRows:
    """The block loop's work for kept rows [lo, hi): staging buffers, sample
    ids on the device, the kernel for the layout (K2 keep-all, K3 subset),
    and the host assembly of the rows."""

    def __init__(self, lay, dev: torch.device, rows: int, timer: StageTimer):
        self.lay, self.dev, self.timer = lay, dev, timer
        self.cuda = dev.type == "cuda"
        self.n_samples = len(lay.sam_idx)
        rec = lay.records.shape[1]
        self.staging = torch.empty((rows, rec), dtype=torch.uint8, pin_memory=self.cuda)
        self.sel = (
            None
            if lay.sample_idx_arg is None
            else torch.from_numpy(lay.sample_idx_arg).to(dev)
        )
        self.text_host = (
            torch.empty((rows, 4 * self.n_samples), dtype=torch.uint8, pin_memory=True)
            if self.cuda
            else None
        )

    def _text(self, lo: int, hi: int) -> np.ndarray:
        """GT text of kept rows [lo, hi) as a (hi-lo, 4*n_samples) u8 host array."""
        n, t = hi - lo, self.timer
        packed_np = self.staging.numpy()
        with t.stage("gather", nbytes=n * packed_np.shape[1]):
            np.copyto(packed_np[:n], _gather_rows(self.lay.records, self.lay.var_idx[lo:hi]))
        with t.stage("h2d", nbytes=n * packed_np.shape[1]):
            packed = self.staging[:n].to(self.dev, non_blocking=True)
            synchronize(self.dev)
        with t.stage("kernel", nbytes=n * 4 * self.n_samples):
            if self.sel is None:
                text = genotype_text(packed, self.n_samples)
            else:
                text = subset_text_from_packed(packed, self.sel)
            synchronize(self.dev)
        if not self.cuda:
            return text.numpy()
        with t.stage("d2h", nbytes=text.numel()):
            self.text_host[:n].copy_(text, non_blocking=True)
            synchronize(self.dev)
        return self.text_host[:n].numpy()

    def write(self, lo: int, hi: int, out: np.ndarray) -> None:
        """pvar prefix + GT text + newline of kept rows [lo, hi), filling out."""
        from pgen_tpu_torch.native import HAVE_NATIVE, native

        text = self._text(lo, hi)
        with self.timer.stage("assemble", nbytes=out.nbytes):
            pbuf, off = materialize_prefixes(
                self.lay.pvar.data_buffer, self.lay.v_starts[lo:hi], self.lay.v_ends[lo:hi]
            )
            if HAVE_NATIVE:
                n = native.assemble_rows_buf(text, pbuf, off, out)
            else:
                n = _assemble_rows_numpy(text, pbuf, off, out)
        if n != out.nbytes:
            raise RuntimeError(f"rows [{lo},{hi}) took {n} bytes, layout says {out.nbytes}")


def plan_blocks(lay, lo: int, hi: int, pos: int, block_variants: int) -> list:
    """(lo, hi, byte offset, byte size) of each block of kept rows [lo, hi),
    the first at byte ``pos`` of the output."""
    blocks = []
    for blo in range(lo, hi, block_variants):
        bhi = min(blo + block_variants, hi)
        cap = int(lay.prefix_sizes[bhi] - lay.prefix_sizes[blo]) + (bhi - blo) * lay.row_fixed
        blocks.append((blo, bhi, pos, cap))
        pos += cap
    return blocks


def _add_timers(timer: StageTimer, parts) -> None:
    """Sum the stages of ``parts`` (one StageTimer a thread) into timer."""
    for part in parts:
        for name, st in part.stages.items():
            into = timer.stages.setdefault(name, Stage())
            into.seconds += st.seconds
            into.bytes_moved += st.bytes_moved
            into.calls += st.calls


def emit_mapped(lay, dev: torch.device, blocks: list, out: np.ndarray, timer: StageTimer,
                threads: int = 1) -> None:
    """Write the rows of ``blocks`` (``plan_blocks``) into ``out`` at their
    offsets.

    One loop with one ``_BlockRows`` when ``threads`` is 1. Otherwise
    ``threads`` host threads take every ``threads``-th block, each with its
    own ``_BlockRows``, StageTimer and, on a card, CUDA stream (the
    kernels, copies and synchronisations of a thread run on its current
    stream); one ``emit`` stage spans them and their stages are summed
    into ``timer`` after it."""
    if not blocks:
        return
    rows_cap = max(hi - lo for lo, hi, _, _ in blocks)
    if threads <= 1 or len(blocks) == 1:
        rows = _BlockRows(lay, dev, rows_cap, timer)
        for lo, hi, pos, cap in blocks:
            rows.write(lo, hi, out[pos : pos + cap])
        return
    threads = min(threads, len(blocks))
    timers = [StageTimer() for _ in range(threads)]

    def run(t: int) -> None:
        with contextlib.ExitStack() as ctx:
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
            rows = _BlockRows(lay, dev, rows_cap, timers[t])
            for lo, hi, pos, cap in blocks[t::threads]:
                rows.write(lo, hi, out[pos : pos + cap])

    with timer.stage("emit", nbytes=sum(b[3] for b in blocks)):
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(run, range(threads)))  # raises a thread's exception
    _add_timers(timer, timers)


def emit_stream(lay, dev: torch.device, blocks: list, fd: int, gz: bool, timer: StageTimer,
                head: bytes | None, eof: bool) -> int:
    """Write ``head`` (when given), then the rows of ``blocks`` in order, to
    ``fd``: plain, or each piece compressed to BGZF members when ``gz``,
    then the BGZF EOF marker when ``eof``; returns the bytes written. One
    loop, one ``_BlockRows`` and one scratch buffer; the ``write`` stage
    holds the compression (over the host's cores) and the writes."""
    written = 0
    threads = os.cpu_count() or 1
    with ThreadPoolExecutor(threads) as pool:

        def sink(data: np.ndarray) -> int:
            with timer.stage("write", nbytes=data.nbytes):
                parts = _bgzf(pool, threads, data) if gz else [data]
                for p in parts:
                    _write_all(fd, memoryview(p))
                return sum(p.nbytes for p in parts)

        if head is not None:
            written += sink(np.frombuffer(head, dtype=np.uint8))
        if blocks:
            rows = _BlockRows(lay, dev, max(hi - lo for lo, hi, _, _ in blocks), timer)
            scratch = np.empty(max(b[3] for b in blocks), dtype=np.uint8)
            for lo, hi, _, cap in blocks:
                rows.write(lo, hi, scratch[:cap])
                written += sink(scratch[:cap])
    if eof:
        _write_all(fd, memoryview(BGZF_EOF))
        written += len(BGZF_EOF)
    return written


def compute_masks(var_query, sam_query, pvar, psam, header, records, device):
    """pgen_tpu's ``compute_masks`` with ``provider="device"``
    (``pgen_tpu/pipeline/filter.py``), its genotype counts made on
    ``device``: the variant and sample masks of the two include-predicates.

    ``GT_*`` variables bind per-variant code histograms in the variant query
    (K8 ``gt_counts_device``) and per-sample ones over all variants in the
    sample query (K9 ``sample_counts_device``; plink2's ``--mind``
    convention). With a GT_* sample query the sample mask comes first, and
    when it keeps a subset the variant counts cover only the kept samples:
    K14 ``gt_counts_masked`` makes those cohort-aware counts on the device
    too, where pgen_tpu's device provider makes them on the host
    (``gt_counts_subset``). Everything else is the port's copy of
    pgen_tpu's host code: GT()/GT_TEXT()/GT_ROW indexing, DUP_* variables
    and the predicate compiler.
    """
    from pgen_tpu_torch.ops.gt_stats_host import GT_VARIABLE_NAMES, gt_variables
    from pgen_tpu_torch.pipeline.filter_host import _maybe_gt_index_masks
    from pgen_tpu_torch.query import compile_predicate, parse
    from pgen_tpu_torch.query.ast import variables
    from pgen_tpu_torch.query.dup import dup_variables
    from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset, sample_counts

    var_node = parse(var_query) if isinstance(var_query, str) else var_query
    sam_node = parse(sam_query) if isinstance(sam_query, str) else sam_query
    var_node, sam_node, var_idx_extra, sam_idx_extra = _maybe_gt_index_masks(
        var_node, sam_node, pvar, psam, header, records
    )
    var_used = variables(var_node) & set(GT_VARIABLE_NAMES) if var_node is not None else set()
    sam_used = variables(sam_node) & set(GT_VARIABLE_NAMES) if sam_node is not None else set()
    dup_extra = dup_variables(pvar, variables(var_node)) if var_node is not None else None
    if var_idx_extra:
        dup_extra = {**(dup_extra or {}), **var_idx_extra}
    if not var_used and not sam_used:
        return (
            compile_predicate(var_node, pvar, dup_extra),
            compile_predicate(sam_node, psam, sam_idx_extra),
        )
    if sam_used:
        if psam.num_rows > header.num_samples:
            raise ValueError(
                f"{psam.path} has {psam.num_rows} rows but the pgen holds "
                f"{header.num_samples} samples (GT_* stats require matching counts)"
            )
        sc = sample_counts(records, header.num_samples, device)
        sam_extra = gt_variables(sc, header.num_variants, sam_used)
        sam_extra = {k: v[: psam.num_rows] for k, v in sam_extra.items()}
        if sam_idx_extra:
            sam_extra = {**sam_extra, **sam_idx_extra}
        sam_mask = compile_predicate(sam_node, psam, sam_extra)
    else:
        sam_mask = compile_predicate(sam_node, psam, sam_idx_extra)
    if not var_used:
        return compile_predicate(var_node, pvar, dup_extra), sam_mask
    sam_idx = np.flatnonzero(sam_mask)
    if len(sam_idx) == header.num_samples:
        counts = gt_counts(records, header.num_samples, device)
    else:
        counts = gt_counts_subset(records, sam_idx.astype(np.int32), device)
    extra = gt_variables(counts, len(sam_idx), var_used)
    if pvar.num_rows > header.num_variants:
        raise ValueError(
            f"{pvar.path} has {pvar.num_rows} rows but the pgen holds "
            f"{header.num_variants} variant records (GT_* stats require matching counts)"
        )
    extra = {k: v[: pvar.num_rows] for k, v in extra.items()}
    if dup_extra:
        extra = {**extra, **dup_extra}
    return compile_predicate(var_node, pvar, extra), sam_mask


def derive_row_layout(
    pfile_prefix: str,
    var_query,
    sam_query,
    provider: str,
    source_tag: str = DEFAULT_SOURCE_TAG,
    timer: StageTimer | None = None,
    device: str | torch.device = "cuda",
) -> RowLayout:
    """Load the fileset, evaluate both predicates, and pin the output row
    layout (shared by filter_to_vcf, the sharded writers, and the
    merged-.gz indexer).

    The device provider's layout: ``filter_host.derive_row_layout`` with the
    masks of the port's ``compute_masks``, whose genotype counts run on
    ``device`` (K8, K9, K14). Any other provider is the copy's, called as
    it stands."""
    if provider != "device":
        return filter_host.derive_row_layout(
            pfile_prefix, var_query, sam_query, provider, source_tag, timer
        )
    timer = timer or StageTimer()
    provider = _resolve_provider(provider)
    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    # IID lookup precedes filtering, so a missing IID column errors even
    # when queries would keep nothing (pfile.rs:111-126 order).
    psam.column_index("IID")

    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    expected = 12 + header.num_variants * rec
    if pgen_mm.shape[0] < expected:
        raise ValueError(
            f"{pfile_prefix}.pgen is {pgen_mm.shape[0]} bytes; header implies {expected}"
        )
    records = pgen_mm[12:expected].reshape(header.num_variants, rec)

    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, device
        )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    all_iids = psam.get_column_strs("IID")
    sample_ids = [all_iids[i] for i in sam_idx]
    n_kept_samples = len(sam_idx)
    # Fast sequential-LUT emission only when the kept set is exactly the
    # pgen's full sample range; otherwise index per sample. (A psam with
    # fewer rows than the pgen is fine — the reference only indexes bytes
    # for rows that exist; more rows than fit a record is an error there
    # too, via the record_buf index panic at pfile.rs:173.)
    keep_all_fast = n_kept_samples == psam.num_rows == header.num_samples
    sample_idx_arg = None if keep_all_fast else sam_idx.astype(np.int32)

    header_bytes = vcf_header_bytes(pvar, sample_ids, source_tag)

    # Row prefixes are raw pvar line bytes + "\tGT"; only their spans are
    # materialized here (emitters read straight from the metadata buffer).
    line_starts_all, line_ends_all = pvar.row_line_spans()
    v_starts = line_starts_all[var_idx]
    v_ends = line_ends_all[var_idx]
    prefix_sizes = np.zeros(len(var_idx) + 1, dtype=np.int64)
    np.cumsum(v_ends - v_starts + 3, out=prefix_sizes[1:])
    row_fixed = 4 * n_kept_samples + 1
    total = len(header_bytes) + int(prefix_sizes[-1]) + len(var_idx) * row_fixed

    if len(var_idx) and var_idx[-1] >= header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar row {int(var_idx[-1])} is beyond the pgen's "
            f"{header.num_variants} variant records"
        )
    if len(sam_idx) and int(sam_idx[-1]) // 4 >= rec:
        raise ValueError(
            f"{pfile_prefix}.psam row {int(sam_idx[-1])} is beyond the pgen's "
            f"{header.num_samples}-sample records"
        )
    return RowLayout(
        header=header,
        pvar=pvar,
        psam=psam,
        records=records,
        var_idx=var_idx,
        sam_idx=sam_idx,
        sample_ids=sample_ids,
        sample_idx_arg=sample_idx_arg,
        header_bytes=header_bytes,
        v_starts=v_starts,
        v_ends=v_ends,
        prefix_sizes=prefix_sizes,
        row_fixed=row_fixed,
        total=total,
    )


def duplicated_ids(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    provider: str = "auto",
    device: str | torch.device = "cuda",
) -> list:
    """IDs that occur more than once among the variants KEPT by the
    queries (the post-filter set --rm-dup error/list report on,
    matching plink2's filter order).

    The device provider's report: ``filter_host.duplicated_ids`` with the
    masks of the port's ``compute_masks`` on ``device``. Any other provider
    is the copy's, called as it stands."""
    if provider != "device":
        return filter_host.duplicated_ids(pfile_prefix, var_query, sam_query, provider)
    provider = _resolve_provider(provider)
    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    var_mask, _ = compute_masks(
        var_query, sam_query, pvar, psam, header, records, device
    )
    ids = pvar.get_column_bytes("ID")[np.flatnonzero(var_mask)]
    uniq, counts = np.unique(ids, return_counts=True)
    return sorted(x.decode() for x in uniq[counts > 1])


def _bgzf(pool: ThreadPoolExecutor, threads: int, data: np.ndarray) -> list:
    """BGZF members of data, compressed in slices across the pool's threads
    (the C call releases the GIL)."""
    from pgen_tpu_torch.native import native

    nparts = min(threads, max(1, data.nbytes // (4 << 20)))
    if nparts == 1:
        return [native.bgzf_compress(data)]
    step = -(-data.nbytes // nparts)
    step = -(-step // _BGZF_INPUT_BLOCK) * _BGZF_INPUT_BLOCK
    slices = [data[o : o + step] for o in range(0, data.nbytes, step)]
    return list(pool.map(native.bgzf_compress, slices))


def filter_to_vcf(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | Path | None = None,
    provider: str = "auto",
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    source_tag: str = DEFAULT_SOURCE_TAG,
    emit_threads: int | None = None,
    index: bool = False,
    index_format: str = "auto",
    device: str | torch.device = "cuda",
) -> FilterResult:
    """Filter a pgen fileset to a VCF with the genotype text made on
    ``device`` (``"cuda"``, which must be available, or ``"cpu"``).

    Same arguments and output bytes as pgen_tpu's ``filter_to_vcf``:
    ``out_file`` defaults to ``{prefix}.pgen-rs.vcf``, ``"-"`` streams to
    stdout, a ``.gz`` name writes BGZF, and ``index`` (``.gz`` only) also
    writes a tabix index (``index_format`` tbi, csi or auto); ``source_tag``
    names the ``##source`` header line. ``provider``: ``"auto"`` binds
    ``GT_*`` predicates on the host (the native C++ counts, or numpy),
    ``"device"`` counts them on ``device`` (``derive_row_layout`` above:
    K8, K9, K14), as pgen_tpu's device provider counts on its device;
    ``"native"`` and ``"numpy"`` raise. ``emit_threads`` (``--threads``):
    host threads, each on its own CUDA stream, emitting disjoint blocks
    into the mapped output (a plain file); the default ``None`` runs one
    loop, as does any stream or ``.gz`` output.
    """
    from pgen_tpu_torch.native import HAVE_NATIVE

    if provider in ("native", "numpy"):
        raise ValueError(
            f"provider {provider!r}: the port's filter serves auto and device; pgen_tpu's "
            "host providers stay pgen_tpu's, by decision (ROADMAP §1): the port's host "
            'path is device="cpu"'
        )
    if provider not in ("auto", "device"):
        raise ValueError(f"unknown provider {provider!r}")
    dev = resolve_device(device)
    if block_variants < 1:
        raise ValueError(f"block_variants must be positive, got {block_variants}")
    timer = StageTimer()
    if out_file == "-":
        out_file = "/dev/stdout"
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)

    lay = derive_row_layout(
        pfile_prefix, var_query, sam_query, provider, source_tag, timer, dev
    )
    gz = out_file.endswith(".gz")
    if gz and not HAVE_NATIVE:
        raise ValueError("bgzf (.gz) output requires the native runtime (C++ toolchain)")
    if index and not gz:
        raise ValueError("--index requires a .gz (BGZF) output file")

    n_var = len(lay.var_idx)
    header_len = len(lay.header_bytes)
    blocks = plan_blocks(lay, 0, n_var, header_len, block_variants)
    pos = blocks[-1][2] + blocks[-1][3] if blocks else header_len
    if pos != lay.total:
        raise RuntimeError(f"size accounting: planned {pos} bytes, layout says {lay.total}")

    if _can_mmap(out_file) and not gz:
        out_mm = np.memmap(out_file, dtype=np.uint8, mode="w+", shape=(lay.total,))
        out_mm[:header_len] = np.frombuffer(lay.header_bytes, dtype=np.uint8)
        emit_mapped(lay, dev, blocks, out_mm, timer, emit_threads or 1)
        del out_mm  # unmap; the OS writes back lazily, as pgen_tpu does
        bytes_written = lay.total
    else:
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            bytes_written = emit_stream(lay, dev, blocks, fd, gz, timer, lay.header_bytes,
                                        eof=gz)
        finally:
            os.close(fd)

    if index:
        with timer.stage("index"):
            emit_tabix_index(
                out_file, lay.pvar, lay.var_idx, lay.prefix_sizes, lay.row_fixed,
                header_len, fmt=index_format,
            )

    log.info("filter (%s): %s", dev, timer.report())
    return FilterResult(
        out_path=out_file,
        num_variants_kept=n_var,
        num_samples_kept=len(lay.sam_idx),
        bytes_written=bytes_written,
        timer=timer,
    )
