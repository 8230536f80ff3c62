"""`pgen-tpu sort`: order a fileset's variants chromosomally (CHROM, POS).

bcftools-sort analog, absent from the reference (its outputs always keep
input row order, pgen-rs/src/pfile.rs:319-333). Needed before
tabix/CSI indexing when the fileset came from an unsorted source (a
`pgen-tpu import` of an unsorted VCF, or a variant-axis `concat` of
interleaved contigs).

Ordering rules:
  - Contig rank follows the ``##contig=<ID=...>`` comment lines of the
    .pvar when present (bcftools' header-order rule). Contigs not listed
    there — or all contigs, when no contig lines exist — follow AFTER the
    listed ones in natural genome order: an optional case-insensitive
    "chr" prefix is ignored, numeric names ascend numerically, then X, Y,
    XY, MT/M, then everything else byte-lexicographically.
  - Within a contig: POS ascending numerically, input order for ties
    (the sort is stable end to end).

The output is a new fileset: .pvar rows are re-emitted byte-verbatim in
sorted order, .pgen records are block-gathered (fixed-width rows, no
re-coding — SURVEY.md C9), .psam is a verbatim copy. When the input is
already sorted the permutation is the identity and the output is a
byte-exact copy of the input fileset.

Copied from ``pgen_tpu/pipeline/sort.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import re
import shutil
from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.pgen_out_host import _write_meta_subset
from pgen_tpu_torch.pipeline.split import _write_subset_pgen
from pgen_tpu_torch.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16

_CONTIG_RE = re.compile(r"^##contig=<[^>]*?\bID=([^,>]+)", re.MULTILINE)
_SPECIAL_RANK = {b"X": 0, b"Y": 1, b"XY": 2, b"MT": 3, b"M": 3}


@dataclass
class SortResult:
    out_prefix: str | None
    num_variants: int
    num_samples: int
    already_sorted: bool
    timer: StageTimer


def _natural_key(name: bytes):
    """Genome-natural ordering key for a contig name (chr prefix ignored)."""
    base = name
    if base[:3].upper() == b"CHR":
        base = base[3:]
    if base.isdigit():
        return (0, int(base), b"")
    up = base.upper()
    if up in _SPECIAL_RANK:
        return (1, _SPECIAL_RANK[up], b"")
    return (2, 0, name)


def _contig_ranks(pvar) -> np.ndarray:
    """Per-row int64 contig rank: ##contig header order first, then
    natural genome order for the rest."""
    listed = [m.encode("utf-8") for m in _CONTIG_RE.findall(pvar.comments)]
    listed_rank = {name: i for i, name in enumerate(listed)}
    col = pvar.get_column_bytes("CHROM")
    values, inverse = np.unique(col, return_inverse=True)
    ranks = np.empty(len(values), dtype=np.int64)
    unlisted = sorted(
        (v for v in values.tolist() if v not in listed_rank), key=_natural_key
    )
    base = len(listed_rank)
    order = {**listed_rank, **{v: base + i for i, v in enumerate(unlisted)}}
    for k, v in enumerate(values.tolist()):
        ranks[k] = order[v]
    return ranks[inverse]


def sort_permutation(pvar) -> np.ndarray:
    """Stable variant permutation by (contig rank, numeric POS)."""
    ranks = _contig_ranks(pvar)
    pos_col = pvar.get_column_bytes("POS")
    try:
        pos = pos_col.astype(np.int64)
    except (ValueError, OverflowError):
        bad = next(
            p for p in pos_col.tolist() if not p.lstrip(b"+-").isdigit()
        )
        raise ValueError(
            f"sort: non-numeric POS value {bad.decode('utf-8', 'replace')!r} "
            f"in {pvar.path}"
        ) from None
    # lexsort is stable per key: primary = last key (contig rank),
    # secondary = POS, ties keep input order
    return np.lexsort((pos, ranks))


def sort_pgen(
    pfile_prefix: str,
    out_prefix: str | None = None,
    check_only: bool = False,
    block_variants: int = DEFAULT_BLOCK,
) -> SortResult:
    timer = StageTimer()
    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        read_metadata(f"{pfile_prefix}.psam").column_index("IID")
    if pvar.num_rows != header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar has {pvar.num_rows} rows but the pgen "
            f"holds {header.num_variants} variant records"
        )
    with timer.stage("sort_keys"):
        perm = sort_permutation(pvar)
        already = bool(np.array_equal(perm, np.arange(len(perm))))
    if check_only:
        return SortResult(None, header.num_variants, header.num_samples, already, timer)

    out_prefix = f"{pfile_prefix}.sorted" if out_prefix is None else str(out_prefix)
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    with timer.stage("write_pgen"):
        _write_subset_pgen(
            f"{out_prefix}.pgen",
            records,
            perm,
            header.num_samples,
            contiguous=already,
            block=block_variants,
        )
    with timer.stage("write_meta"):
        _write_meta_subset(pvar, perm, f"{out_prefix}.pvar")
        shutil.copyfile(f"{pfile_prefix}.psam", f"{out_prefix}.psam")
    return SortResult(
        out_prefix, header.num_variants, header.num_samples, already, timer
    )
