"""Split one pgen fileset into many: the inverse of `concat`.

bcftools +split / plink2 --chr analog, absent from the reference (its
only outputs are whole-query VCFs, pgen-rs/src/pfile.rs:104).
Two modes:

  --by-chrom   one fileset per distinct CHROM value, first-appearance
               order; rows keep .pvar order within each output
  --parts N    N near-equal contiguous variant ranges (the same ranges
               --shards uses), so `concat part1..partN` reproduces the
               input byte-exactly — tested both ways

All samples pass through: each output's .psam is a verbatim byte copy,
and contiguous ranges stream .pgen records without re-coding (records
are fixed-width, SURVEY.md C9). Non-contiguous chrom groups block-gather
rows through the same path filter --out-format pgen uses.

Copied from ``pgen_tpu/pipeline/split.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import re
import shutil
import struct
from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    read_pgen_header,
)
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.pipeline.pgen_out_host import _write_meta_subset
from pgen_tpu_torch.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16


@dataclass
class SplitResult:
    out_prefixes: list
    num_variants: int
    num_samples: int
    timer: StageTimer


def _safe_name(chrom: str) -> str:
    """Contig value -> filesystem-safe output-name fragment."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", chrom) or "_"


def _chrom_groups(pvar):
    """Ordered (chrom, row-index array) groups, first-appearance order."""
    col = pvar.get_column_bytes("CHROM")
    values, first, inverse = np.unique(col, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    groups = []
    for rank in order:
        idx = np.flatnonzero(inverse == rank)
        groups.append((values[rank].decode("utf-8"), idx))
    return groups


def _part_ranges(num_variants: int, parts: int):
    """N near-equal contiguous ranges covering [0, num_variants)."""
    if parts < 1:
        raise ValueError(f"--parts must be >= 1, got {parts}")
    bounds = np.linspace(0, num_variants, parts + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(parts)]


def _write_subset_pgen(out_path, records, idx, num_samples, contiguous, block):
    with open(out_path, "wb") as f:
        f.write(PGEN_MAGIC)
        f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
        f.write(struct.pack("<II", len(idx), num_samples))
        f.write(bytes([MODE2_FORMAT_BYTE]))
        if contiguous and len(idx):
            lo, hi = int(idx[0]), int(idx[-1]) + 1
            f.write(np.ascontiguousarray(records[lo:hi]).tobytes())
        else:
            for blo in range(0, len(idx), block):
                blk = _gather_rows(records, idx[blo : blo + block])
                f.write(np.ascontiguousarray(blk).tobytes())


def split_pgen(
    pfile_prefix: str,
    out_prefix: str,
    by_chrom: bool = False,
    parts: int | None = None,
    block_variants: int = DEFAULT_BLOCK,
) -> SplitResult:
    if by_chrom == (parts is not None):
        raise ValueError("pass exactly one of --by-chrom / --parts N")
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
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    if by_chrom:
        groups = [
            (f"{out_prefix}.{_safe_name(chrom)}", idx, False)
            for chrom, idx in _chrom_groups(pvar)
        ]
        # sanitized contig names may collide ("chr?1" and "chr.1"); keep
        # every output by suffixing later collisions
        seen: dict = {}
        uniq = []
        for name, idx, contiguous in groups:
            if name in seen:
                seen[name] += 1
                name = f"{name}.{seen[name]}"
            else:
                seen[name] = 1
            uniq.append((name, idx, contiguous))
        groups = uniq
    else:
        width = len(str(parts))
        groups = [
            (f"{out_prefix}.part{i + 1:0{width}d}", np.arange(lo, hi), True)
            for i, (lo, hi) in enumerate(_part_ranges(header.num_variants, parts))
        ]

    outs = []
    for name, idx, contiguous in groups:
        with timer.stage("write_pgen"):
            _write_subset_pgen(
                f"{name}.pgen",
                records,
                idx,
                header.num_samples,
                contiguous,
                block_variants,
            )
        with timer.stage("write_meta"):
            _write_meta_subset(pvar, idx, f"{name}.pvar")
            shutil.copyfile(f"{pfile_prefix}.psam", f"{name}.psam")
        outs.append(name)
    return SplitResult(
        out_prefixes=outs,
        num_variants=header.num_variants,
        num_samples=header.num_samples,
        timer=timer,
    )
