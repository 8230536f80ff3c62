"""The host half of ``pgen_tpu/pipeline/bed_import.py``, copied: the
PLINK1 ``.bed``/``.bim``/``.fam`` -> mode-0x02 fileset converter
(``import_bed``: a 256-entry byte LUT over the records and a pad-bit mask,
no device work in pgen_tpu either), its code maps and byte LUTs, the
result and error types, the table reader and ``_sex_code``. Only the
imports differ. Left out: ``filter_to_bed``, whose sample re-pack runs
pgen_tpu's ``_subset_block``; the port's is ``pipeline/bed_import.py``.

pgen_tpu's module docstring, on the format:

PLINK1's variant-major .bed shares the mode-0x02 record geometry exactly —
ceil(S/4) bytes per variant, 2 bits per sample, LSB-first — so genotype
conversion is a single 256-entry byte LUT over the record stream:

  plink1 code            pgen hard call (ALT dosage)
  00 hom A1 (ALT)   ->   2
  01 missing        ->   3
  10 het            ->   1
  11 hom A2 (REF)   ->   0

(A1 maps to ALT and A2 to REF, as plink2's own converter does.) The last
record byte's pad bits are cleared to the canonical zero padding the rest
of this codebase emits (plink1 zero-pads, which would remap to code 2).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
)
from pgen_tpu_torch.utils.timer import StageTimer

BED_MAGIC = b"\x6c\x1b\x01"
DEFAULT_CHUNK_ROWS = 1 << 16

# plink1 2-bit code -> pgen 2-bit code (and its inverse for export),
# expanded to whole bytes
_CODE_MAP = np.array([2, 3, 1, 0], dtype=np.uint8)
_CODE_MAP_INV = np.array([3, 2, 0, 1], dtype=np.uint8)


def _byte_lut(code_map: np.ndarray) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    for b in range(256):
        v = 0
        for k in range(4):
            v |= int(code_map[(b >> (2 * k)) & 3]) << (2 * k)
        lut[b] = v
    return lut


_BYTE_LUT = _byte_lut(_CODE_MAP)
_BYTE_LUT_INV = _byte_lut(_CODE_MAP_INV)


class BedImportError(ValueError):
    """The .bed/.bim/.fam fileset violated a conversion invariant."""


@dataclass
class BedImportResult:
    out_prefix: str
    num_variants: int
    num_samples: int
    timer: StageTimer


def _read_table(path: str, n_cols_expected: tuple, what: str) -> list:
    """Whitespace-delimited, headerless PLINK1 table -> list of row tuples."""
    rows = []
    with open(path, "rb") as fh:
        for i, line in enumerate(fh):
            parts = line.split()
            if not parts:
                continue
            if len(parts) not in n_cols_expected:
                raise BedImportError(
                    f"{path}: {what} row {i + 1} has {len(parts)} fields, "
                    f"expected {' or '.join(map(str, n_cols_expected))}"
                )
            rows.append(parts)
    return rows


def import_bed(
    bed_path: str | Path,
    out_prefix: str | Path | None = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> BedImportResult:
    """Convert PREFIX.bed/.bim/.fam into OUT_PREFIX.pgen/.pvar/.psam."""
    bed_path = str(bed_path)
    if not bed_path.endswith(".bed"):
        raise BedImportError(f"{bed_path}: expected a .bed path")
    prefix_in = bed_path[: -len(".bed")]
    out_prefix = str(out_prefix) if out_prefix is not None else prefix_in
    timer = StageTimer()

    with timer.stage("metadata"):
        bim = _read_table(f"{prefix_in}.bim", (6,), ".bim")
        fam = _read_table(f"{prefix_in}.fam", (6,), ".fam")
    num_variants, num_samples = len(bim), len(fam)
    rec_size = (num_samples + 3) // 4  # == ceil(2S/8), same geometry

    mm = np.memmap(bed_path, dtype=np.uint8, mode="r")
    if mm.nbytes < 3 or bytes(mm[:3]) != BED_MAGIC:
        if mm.nbytes >= 3 and bytes(mm[:2]) == BED_MAGIC[:2] and mm[2] == 0:
            raise BedImportError(
                f"{bed_path}: sample-major .bed (third byte 0x00) is not "
                f"supported — regenerate variant-major with plink"
            )
        raise BedImportError(f"{bed_path}: bad magic, want 6C 1B 01 (variant-major)")
    want = 3 + num_variants * rec_size
    if mm.nbytes != want:
        raise BedImportError(
            f"{bed_path}: size {mm.nbytes} != 3 + {num_variants} x {rec_size} "
            f"(V from .bim, S from .fam)"
        )

    # tail-byte pad mask: keep only the 2*(S%4) used bits
    tail_used = num_samples % 4
    tail_mask = np.uint8((1 << (2 * tail_used)) - 1) if tail_used else np.uint8(0xFF)

    with timer.stage("pvar"):
        with open(f"{out_prefix}.pvar", "wb") as f:
            f.write(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            out = []
            for chrom, vid, _cm, pos, a1, a2 in bim:
                out.append(b"\t".join([chrom, pos, vid, a2, a1, b".", b".", b"."]))
            f.write(b"\n".join(out) + (b"\n" if out else b""))
    with timer.stage("psam"):
        with open(f"{out_prefix}.psam", "wb") as f:
            f.write(b"#FID\tIID\tPAT\tMAT\tSEX\tPHENO1\n")
            f.write(b"\n".join(b"\t".join(r) for r in fam) + (b"\n" if fam else b""))

    with open(f"{out_prefix}.pgen", "wb") as pgen:
        pgen.write(PGEN_MAGIC + bytes([FIXED_WIDTH_STORAGE_MODE]))
        pgen.write(struct.pack("<II", num_variants, num_samples))
        pgen.write(bytes([MODE2_FORMAT_BYTE]))
        body = mm[3:]
        for lo in range(0, num_variants, chunk_rows):
            hi = min(lo + chunk_rows, num_variants)
            with timer.stage("remap", (hi - lo) * rec_size):
                blk = _BYTE_LUT[
                    np.asarray(body[lo * rec_size : hi * rec_size]).reshape(
                        hi - lo, rec_size
                    )
                ]
                if rec_size:
                    blk[:, -1] &= tail_mask
            with timer.stage("write", blk.nbytes):
                pgen.write(blk.tobytes())

    return BedImportResult(
        out_prefix=out_prefix,
        num_variants=num_variants,
        num_samples=num_samples,
        timer=timer,
    )


def _sex_code(v: str) -> str:
    u = v.strip().upper()
    if u in ("1", "M", "MALE"):
        return "1"
    if u in ("2", "F", "FEMALE"):
        return "2"
    return "0"
