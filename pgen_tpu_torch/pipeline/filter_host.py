"""The host half of ``pgen_tpu/pipeline/filter.py``, copied: the output row
layout and its predicates (``derive_row_layout``, ``compute_masks`` with
the GT-index masks), the prefix gather, the row assembler's numpy twin,
tabix, the write loops and the row gather. Only the imports differ, and
the row gather checks that a slice's ids step by one (``_gather_rows``).
The duplicate-ID report of ``--rm-dup error|list`` (``duplicated_ids``)
is copied too: its ``GT_*`` counts run on the host (the native C++ or
numpy), whatever the provider. Left out:
``_emit_block`` (its device branch runs jax), ``_emit_block_meta``,
``filter_to_vcf`` and ``_start_pretouch``, which no path of the port
runs; the port's filters are ``pipeline/filter.py`` and
``pipeline/mesh_filter.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.vcf import DEFAULT_SOURCE_TAG, vcf_header_bytes
from pgen_tpu_torch.query.compile import compile_predicate
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

log = get_logger("filter")

DEFAULT_BLOCK_VARIANTS = 1 << 16

# BGZF end-of-file marker: one empty block (SAM spec §4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _resolve_provider(provider: str) -> str:
    from pgen_tpu_torch.native import HAVE_NATIVE

    if provider == "auto":
        return "native" if HAVE_NATIVE else "numpy"
    if provider == "native" and not HAVE_NATIVE:
        log.warning("native provider unavailable (no C++ toolchain); using numpy")
        return "numpy"
    return provider


def _maybe_gt_index_masks(var_node, sam_node, pvar, psam, header, records):
    """Bind GT()/GT_TEXT()/GT_ROW genotype-indexing references in the two
    include-predicates (query/gt_index.py). Variant-axis calls name a
    sample (psam IID); sample-axis calls name a variant (pvar ID)."""
    from pgen_tpu_torch.query.gt_index import bind_gt_index, uses_gt_index

    var_idx_extra = sam_idx_extra = None
    if uses_gt_index((var_node,)):
        if pvar.num_rows > header.num_variants:
            raise ValueError(
                f"{pvar.path} has {pvar.num_rows} rows but the pgen holds "
                f"{header.num_variants} variant records (GT indexing "
                f"requires matching counts)"
            )

        def _iids():
            if "IID" not in psam.columns:
                raise ValueError(f"{psam.path} has no IID column")
            return psam.get_column_bytes("IID")

        (var_node,), var_idx_extra = bind_gt_index(
            (var_node,), records, header.num_samples, pvar, False, _iids
        )
    if uses_gt_index((sam_node,)):
        if psam.num_rows > header.num_samples:
            raise ValueError(
                f"{psam.path} has {psam.num_rows} rows but the pgen holds "
                f"{header.num_samples} samples (GT indexing requires "
                f"matching counts)"
            )

        def _vids():
            if "ID" not in pvar.columns:
                raise ValueError(f"{pvar.path} has no ID column")
            return pvar.get_column_bytes("ID")

        (sam_node,), sam_idx_extra = bind_gt_index(
            (sam_node,), records, header.num_samples, psam, True, _vids
        )
    return var_node, sam_node, var_idx_extra, sam_idx_extra


def compute_masks(var_query, sam_query, pvar, psam, header, records, provider):
    """Evaluate both include-predicates, supporting GT_* genotype-stat
    variables on BOTH axes (an extension over the reference —
    README.md:259-264 lists genotype-valued queries as unsupported there):
    in the variant query they bind per-variant code histograms; in the
    sample query, per-sample ones (GT_MISSING_RATE etc. over ALL variants
    — the plink2 --mind convention: sample QC sees the whole fileset).

    Without GT_* variables the evaluation order matches the reference
    (variants first, pfile.rs:127-128). With them, the sample mask comes
    first so the variant stats are cohort-aware (counts cover kept
    samples only).
    """
    from pgen_tpu_torch.ops.gt_stats_host import GT_VARIABLE_NAMES, maybe_gt_extra
    from pgen_tpu_torch.query.ast import variables
    from pgen_tpu_torch.query.parser import parse

    from pgen_tpu_torch.query.dup import dup_variables

    var_node = parse(var_query) if isinstance(var_query, str) else var_query
    sam_node = parse(sam_query) if isinstance(sam_query, str) else sam_query
    # GT("IID")/GT_TEXT()/GT_ROW per-sample indexing (query/gt_index.py):
    # rewrite the ASTs up front so every later path sees plain variables
    var_node, sam_node, var_idx_extra, sam_idx_extra = _maybe_gt_index_masks(
        var_node, sam_node, pvar, psam, header, records
    )
    uses_gt = var_node is not None and bool(
        variables(var_node) & set(GT_VARIABLE_NAMES)
    )
    sam_uses_gt = sam_node is not None and bool(
        variables(sam_node) & set(GT_VARIABLE_NAMES)
    )
    # DUP_* whole-column duplicate-group variables (query/dup.py) ride the
    # same extra mechanism as GT_*, computed from the pvar alone
    dup_extra = (
        dup_variables(pvar, variables(var_node))
        if var_node is not None
        else None
    )
    if var_idx_extra:
        dup_extra = {**(dup_extra or {}), **var_idx_extra}
    if not uses_gt and not sam_uses_gt:
        return (
            compile_predicate(var_node, pvar, dup_extra),
            compile_predicate(sam_node, psam, sam_idx_extra),
        )
    if sam_uses_gt:
        from pgen_tpu_torch.ops.gt_stats_host import gt_variables, sample_counts

        if psam.num_rows > header.num_samples:
            raise ValueError(
                f"{psam.path} has {psam.num_rows} rows but the pgen holds "
                f"{header.num_samples} samples (GT_* stats require "
                f"matching counts)"
            )
        stats_provider = (
            provider if provider in ("native", "device", "numpy") else "native"
        )
        used = variables(sam_node) & set(GT_VARIABLE_NAMES)
        sc = sample_counts(records, header.num_samples, stats_provider)
        sam_extra = gt_variables(sc, header.num_variants, used)
        sam_extra = {k: v[: psam.num_rows] for k, v in sam_extra.items()}
        if sam_idx_extra:
            sam_extra = {**sam_extra, **sam_idx_extra}
        sam_mask = compile_predicate(sam_node, psam, sam_extra)
    else:
        sam_mask = compile_predicate(sam_node, psam, sam_idx_extra)
    if not uses_gt:
        return compile_predicate(var_node, pvar, dup_extra), sam_mask
    sam_idx = np.flatnonzero(sam_mask)
    subset = None if len(sam_idx) == header.num_samples else sam_idx.astype(np.int32)
    stats_provider = provider if provider in ("native", "device", "numpy") else "native"
    extra = maybe_gt_extra(
        var_node, records, header.num_samples, subset, stats_provider
    )
    if extra is not None:
        if pvar.num_rows > header.num_variants:
            raise ValueError(
                f"{pvar.path} has {pvar.num_rows} rows but the pgen holds "
                f"{header.num_variants} variant records (GT_* stats require "
                f"matching counts)"
            )
        extra = {k: v[: pvar.num_rows] for k, v in extra.items()}
    if dup_extra:
        extra = {**(extra or {}), **dup_extra}
    var_mask = compile_predicate(var_node, pvar, extra)
    return var_mask, sam_mask


def duplicated_ids(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    provider: str = "auto",
) -> list:
    """IDs that occur more than once among the variants KEPT by the
    queries (the post-filter set --rm-dup error/list report on,
    matching plink2's filter order)."""
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
        var_query, sam_query, pvar, psam, header, records, provider
    )
    ids = pvar.get_column_bytes("ID")[np.flatnonzero(var_mask)]
    uniq, counts = np.unique(ids, return_counts=True)
    return sorted(x.decode() for x in uniq[counts > 1])


@dataclass
class FilterResult:
    out_path: str
    num_variants_kept: int
    num_samples_kept: int
    bytes_written: int
    timer: StageTimer


def materialize_prefixes(meta_buf, line_starts, line_ends):
    """Ragged-gather pvar line bytes + "\\tGT" into a dense prefix buffer.

    Returns (pbuf u8, offsets i64 of len n+1): prefix i is
    pbuf[offsets[i]:offsets[i+1]] == meta line bytes + b"\\tGT".
    """
    n = len(line_starts)
    line_lens = line_ends - line_starts
    lens = line_lens + 3
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    pbuf = np.empty(int(off[-1]), dtype=np.uint8)
    if n:
        rows = np.repeat(np.arange(n), line_lens)
        line_pos = np.arange(int(line_lens.sum()), dtype=np.int64)
        starts_cum = np.concatenate(([0], np.cumsum(line_lens)[:-1]))
        within = line_pos - starts_cum[rows]
        pbuf[off[rows] + within] = meta_buf[line_starts[rows] + within]
        gt_idx = off[1:, None] - np.array([3, 2, 1], dtype=np.int64)
        pbuf[gt_idx[:, 0]] = ord("\t")
        pbuf[gt_idx[:, 1]] = ord("G")
        pbuf[gt_idx[:, 2]] = ord("T")
    return pbuf, off


@dataclass
class RowLayout:
    """Everything derivable from (fileset, queries): masks, kept indices,
    header bytes, and the deterministic byte layout of every output row.

    Row i's body bytes span
    ``[header_len + prefix_sizes[i] + i*row_fixed, ... i+1 ...)`` — the
    arithmetic every writer (single, sharded, worker-merged) and the index
    emitter must agree on, so it is derived in exactly one place.
    """

    header: object
    pvar: object
    psam: object
    records: np.ndarray
    var_idx: np.ndarray
    sam_idx: np.ndarray
    sample_ids: list
    sample_idx_arg: np.ndarray | None  # None == keep-all fast path
    header_bytes: bytes
    v_starts: np.ndarray
    v_ends: np.ndarray
    prefix_sizes: np.ndarray
    row_fixed: int
    total: int


def derive_row_layout(
    pfile_prefix: str,
    var_query,
    sam_query,
    provider: str,
    source_tag: str = DEFAULT_SOURCE_TAG,
    timer: StageTimer | None = None,
) -> RowLayout:
    """Load the fileset, evaluate both predicates, and pin the output row
    layout (shared by filter_to_vcf, the sharded writers, and the
    merged-.gz indexer)."""
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
            var_query, sam_query, pvar, psam, header, records, provider
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


def _assemble_rows_numpy(text, prefix_buf, prefix_off, out):
    n_var, gt_len = text.shape
    plens = np.diff(prefix_off)
    row_lens = plens + gt_len + 1
    out_off = np.zeros(n_var + 1, dtype=np.int64)
    np.cumsum(row_lens, out=out_off[1:])
    total = int(out_off[-1])
    if total > out.nbytes:
        raise ValueError("output buffer too small")
    rows = np.repeat(np.arange(n_var), plens)
    src_pos = np.arange(int(prefix_off[-1]), dtype=np.int64)
    out[out_off[rows] + (src_pos - prefix_off[rows])] = prefix_buf
    gstart = out_off[:-1] + plens
    chunk = max(1, (64 << 20) // max(gt_len * 8, 1))
    for lo in range(0, n_var, chunk):
        hi = min(lo + chunk, n_var)
        idx = gstart[lo:hi, None] + np.arange(gt_len, dtype=np.int64)[None, :]
        out[idx] = text[lo:hi]
    out[out_off[1:] - 1] = ord("\n")
    return total


def emit_tabix_index(
    gz_path: str,
    pvar,
    var_idx: np.ndarray,
    prefix_sizes: np.ndarray,
    row_fixed: int,
    header_len: int,
    fmt: str = "auto",
) -> str:
    """Emit {gz_path}.tbi (or .csi) for the rows just written (kept order
    var_idx). fmt: tbi/csi/auto — auto picks .csi when any position
    exceeds the .tbi 2^29 ceiling.

    Row i's uncompressed byte span is pure arithmetic:
    [header_len + prefix_sizes[i] + i*row_fixed, ... i+1 ...).
    """
    from pgen_tpu_torch.formats.tabix import build_index_for_vcf_gz

    for col in ("CHROM", "POS", "REF"):
        if col not in pvar.columns:
            raise ValueError(f"--index requires a {col} column in the .pvar")
    chroms = pvar.get_column_bytes("CHROM")[var_idx]
    try:
        pos = pvar.get_column_bytes("POS")[var_idx].astype(np.int64)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"--index requires integer POS values: {e}") from None
    _, ref_lens_all = pvar.get_column_padded("REF")
    ref_lens = np.asarray(ref_lens_all, dtype=np.int64)[var_idx]
    n = len(var_idx)
    idx = np.arange(n, dtype=np.int64)
    u_starts = header_len + prefix_sizes[:-1] + idx * row_fixed
    u_ends = header_len + prefix_sizes[1:] + (idx + 1) * row_fixed
    return build_index_for_vcf_gz(
        gz_path, chroms, pos, ref_lens, u_starts, u_ends, fmt=fmt
    )


def _write_all(fd: int, view: memoryview) -> None:
    """os.write until the whole view is on the fd. A single os.write may
    return short on a pipe (e.g. interrupted after a partial transfer);
    silently dropping the remainder would truncate the VCF."""
    view = view.cast("B")
    while len(view):
        n = os.write(fd, view)
        view = view[n:]


def _pwrite_all(fd: int, data, offset: int) -> None:
    """os.pwrite until everything lands at offset. A single pwrite caps at
    ~2 GiB on Linux (and may return short on EINTR); dropping the
    remainder would leave stale bytes mid-file with no error."""
    view = memoryview(data).cast("B")
    while len(view):
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


def _gather_rows(records: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather that stays zero-copy for contiguous kept ranges (the
    keep-all fast path reads straight from the .pgen memory map).

    pgen_tpu's takes the slice whenever the ends are ``len(idx) - 1``
    apart, so a permuted block (sort's order, say [0, 2, 1, 3]) reads the
    rows in file order; here the ids must step by one."""
    if len(idx) and int(idx[-1]) - int(idx[0]) + 1 == len(idx) and (np.diff(idx) == 1).all():
        return records[int(idx[0]) : int(idx[-1]) + 1]
    return records[idx]


def _can_mmap(path: str) -> bool:
    """mmap emission needs a regular (seekable) output file."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        # new file in a writable directory: fine
        parent = os.path.dirname(path) or "."
        return os.path.isdir(parent)
    import stat as stat_mod

    return stat_mod.S_ISREG(st.st_mode)
