"""``query`` on one GPU: the port of ``pgen_tpu/pipeline/query.py``.

The metadata-only query path. Reference parity (pgen-rs/src/pfile.rs:78-102,
main.rs:95-113): ``query`` touches ONLY the .pvar (default) or .psam (-s)
metadata file -- never the .pgen records -- which is the reference's stated
scaling advantage over bcftools (README.md:158-160). The pgen header is
still opened first (Pfile::from_prefix runs before the reader is chosen,
main.rs:101), so a missing/invalid .pgen errors here too.

Extension: referencing a GT_* genotype-stat variable in -i or -f opts
into exactly one pass over the packed records (the reference cannot
query genotypes at all, README.md:259-264). Per-variant histograms by
default (K8 ``gt_counts_device`` on ``device``); per-sample ones under -s
(K9 ``sample_counts_device``). A query with neither GT_* nor a GT
index (``GT("IID")``, ``GT_TEXT``, ``GT_ROW``, bound on the host by the
port's copy of ``query/gt_index.py``) launches no kernel.

Instead of the reference's per-row context rebuild + evalexpr walk, the
include predicate and fstring compile once to whole-column vector ops; rows
stream to the writer in one pass.

``_maybe_gt_index`` and ``query_metadata`` are copied from pgen_tpu, with a
device where pgen_tpu counts on the host; ``_maybe_gt_extra`` counts on it.
"""

from __future__ import annotations

import sys

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.query.compile import (
    compile_fstring,
    compile_fstring_bytes,
    compile_predicate,
)


def _maybe_gt_extra(
    pfile_prefix: str, header, table, query_samples: bool, nodes, device
) -> dict | None:
    """Bind GT_* genotype-stat variables when a query references them.

    The metadata-only scaling property (README.md:158-160) holds for every
    query that does NOT use GT_*; referencing one opts into a single pass
    over the packed records. Axis follows the query axis: per-variant
    code histograms (like filter's --include-var, K8), or per-sample ones
    under -s (GT_NOBS = called variants for that sample, GT_AC = alt
    alleles the sample carries; K9), counted on ``device``.
    """
    from pgen_tpu_torch.ops.gt_stats import gt_counts, sample_counts
    from pgen_tpu_torch.ops.gt_stats_host import GT_VARIABLE_NAMES, gt_variables
    from pgen_tpu_torch.query.ast import variables

    used = set()
    for node in nodes:
        if node is not None:
            used |= variables(node) & set(GT_VARIABLE_NAMES)
    if not used:
        return None
    axis_rows = header.num_samples if query_samples else header.num_variants
    if table.num_rows > axis_rows:
        raise ValueError(
            f"{table.path} has {table.num_rows} rows but the pgen holds "
            f"{axis_rows} (GT_* stats require matching counts)"
        )
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    if query_samples:
        counts = sample_counts(records, header.num_samples, device)
        extra = gt_variables(counts, header.num_variants, used)
    else:
        counts = gt_counts(records, header.num_samples, device)
        extra = gt_variables(counts, header.num_samples, used)
    return {k: v[: table.num_rows] for k, v in extra.items()}


def _maybe_gt_index(
    pfile_prefix, header, table, query_samples, query, query_fstring, extra
):
    """Bind GT("IID")/GT_TEXT(...)/GT_ROW per-sample genotype references
    (query/gt_index.py). Like GT_*, referencing one opts into reading the
    packed records; metadata-only queries never touch them."""
    from pgen_tpu_torch.query.gt_index import bind_gt_index, uses_gt_index

    if not uses_gt_index((query, query_fstring)):
        return query, query_fstring, extra
    axis_rows = header.num_samples if query_samples else header.num_variants
    if table.num_rows > axis_rows:
        raise ValueError(
            f"{table.path} has {table.num_rows} rows but the pgen holds "
            f"{axis_rows} (GT indexing requires matching counts)"
        )
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )

    def lookup_ids():
        if query_samples:
            other = read_metadata(f"{pfile_prefix}.pvar")
            col = "ID"
        else:
            other = read_metadata(f"{pfile_prefix}.psam")
            col = "IID"
        if col not in other.columns:
            raise ValueError(f"{other.path} has no {col} column")
        return other.get_column_bytes(col)

    (query, query_fstring), gt_extra = bind_gt_index(
        (query, query_fstring), records, header.num_samples, table,
        query_samples, lookup_ids,
    )
    if gt_extra:
        extra = {**(extra or {}), **gt_extra}
    return query, query_fstring, extra


def query_metadata(
    pfile_prefix: str,
    query_fstring: str,
    query: str | None = None,
    query_samples: bool = False,
    out=None,
    device="cuda",
) -> int:
    """Print one fstring result per kept metadata row (to stdout by default).

    Returns the number of rows printed. GT_* variables are counted on
    ``device`` (``"cuda"``, which must be available, or ``"cpu"``, the
    kernels' plain versions).
    """
    from pgen_tpu_torch.query.parser import parse

    dev = resolve_device(device)
    header = read_pgen_header(f"{pfile_prefix}.pgen")  # from_prefix parity
    meta_path = f"{pfile_prefix}.psam" if query_samples else f"{pfile_prefix}.pvar"
    table = read_metadata(meta_path)
    query = parse(query) if isinstance(query, str) else query
    query_fstring = (
        parse(query_fstring) if isinstance(query_fstring, str) else query_fstring
    )
    extra = _maybe_gt_extra(
        pfile_prefix, header, table, query_samples, (query, query_fstring), dev
    )
    query, query_fstring, extra = _maybe_gt_index(
        pfile_prefix, header, table, query_samples, query, query_fstring,
        extra,
    )
    if not query_samples:
        from pgen_tpu_torch.query.ast import variables
        from pgen_tpu_torch.query.dup import dup_variables

        used = set()
        for node in (query, query_fstring):
            if node is not None:
                used |= variables(node)
        dup_extra = dup_variables(table, used)
        if dup_extra:
            extra = {**(extra or {}), **dup_extra}
    mask = compile_predicate(query, table, extra)
    rows = np.flatnonzero(mask)
    out = sys.stdout if out is None else out
    # fast path: vectorized straight-to-bytes assembly, one write call
    # (the reference println!s per row; output bytes are identical)
    data = compile_fstring_bytes(query_fstring, table, rows, extra)
    if data is not None:
        payload = data.tobytes()
        sink = getattr(out, "buffer", None)
        if sink is not None:
            sink.write(payload)
        else:
            out.write(payload.decode("utf-8"))
        return len(rows)
    results = compile_fstring(query_fstring, table, rows, extra)
    if results:
        out.write("\n".join(results))
        out.write("\n")
    return len(results)
