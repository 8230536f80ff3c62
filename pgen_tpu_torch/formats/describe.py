"""General (variable-record) PGEN header introspector.

TPU-native counterpart of the reference's ``Pgen`` diagnostic path
(pgen-rs/src/pgen.rs:5-259, dead at runtime there but part of the
component inventory, SURVEY.md C12). Given a non-mode-0x02 .pgen it reports:

* storage mode byte, variant/sample counts (pgen.rs:32-48)
* format byte decomposition: record storage mode (low 4 bits), allele count
  bytes (bits 4-5), provisional-ref storage (bits 6-7, must be 0b01)
  (pgen.rs:55-58)
* derived record-type width (4 or 8 bits) and record-length width (1..4
  bytes) (pgen.rs:60-67)
* the 65536-variant block index: ascending u64 LE block offsets
  (pgen.rs:140-169) and, per block, the packed record-type and record-length
  arrays — the distinct record types/lengths observed (pgen.rs:172-258).

Unlike the reference it does everything vectorized with numpy instead of
byte-at-a-time reads, and reports to a returned structure instead of stdout.

Copied from ``pgen_tpu/formats/describe.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from pgen_tpu_torch.formats.header import PGEN_MAGIC, PgenFormatError

VARIANT_BLOCK_SIZE = 1 << 16


@dataclass
class PgenDescription:
    path: str
    storage_mode: int
    num_variants: int
    num_samples: int
    record_type_bits: int
    record_length_bytes: int
    allele_count_bytes: int
    provisional_ref_storage: int
    block_offsets: np.ndarray  # u64 per 65536-variant block
    record_types: np.ndarray  # distinct record types observed
    record_lengths: np.ndarray  # distinct record lengths observed
    variant_records_offset: int

    def summary(self) -> str:
        lines = [
            f"pgen: {self.path}",
            f"storage mode: 0x{self.storage_mode:02x}",
            f"variants: {self.num_variants}",
            f"samples: {self.num_samples}",
            f"record type bits: {self.record_type_bits}",
            f"record length bytes: {self.record_length_bytes}",
            f"allele count bytes: {self.allele_count_bytes}",
            f"variant blocks: {len(self.block_offsets)}"
            f" (first offset {self.block_offsets[0]}, last {self.block_offsets[-1]})",
            f"distinct record types: {[f'{t:#06b}' for t in self.record_types.tolist()]}",
            f"distinct record lengths: {self.record_lengths.tolist()}",
            f"variant records offset: {self.variant_records_offset}",
        ]
        return "\n".join(lines)


def _types_block_nbytes(count: int, type_bits: int) -> int:
    # ceil at nibble granularity: 4-bit types pack two per byte.
    if type_bits == 4:
        return (count + 1) // 2
    return count


def describe_pgen(path: str | Path) -> PgenDescription:
    path = str(path)
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    if len(raw) < 12:
        raise PgenFormatError(f"{path}: truncated header")
    if raw[:2].tobytes() != PGEN_MAGIC:
        raise PgenFormatError(f"{path}: bad magic")
    storage_mode = int(raw[2])
    num_variants = int(raw[3:7].view(np.uint32)[0])
    num_samples = int(raw[7:11].view(np.uint32)[0])
    fmt = int(raw[11])

    if storage_mode == 0x02:
        # fixed-width mode has no variant-block index / record-type arrays;
        # the format byte 0x40 is not a general-header format byte.
        raise PgenFormatError(
            f"{path}: storage mode 0x02 is the fixed-width hard-call mode; "
            f"it has no general header to introspect"
        )

    record_storage_mode = fmt & 0b1111
    allele_count_bytes = (fmt >> 4) & 0b11
    provisional_ref_storage = (fmt >> 6) & 0b11
    if provisional_ref_storage != 0b01:
        raise PgenFormatError(
            f"{path}: provisional-ref storage {provisional_ref_storage:#04b}, want 0b01"
        )
    if record_storage_mode // 4 == 0:
        record_type_bits = 4
    elif record_storage_mode // 4 == 1:
        record_type_bits = 8
    else:
        raise PgenFormatError(f"{path}: invalid record storage mode {record_storage_mode}")
    record_length_bytes = record_storage_mode % 4 + 1

    n_blocks = (num_variants + VARIANT_BLOCK_SIZE - 1) // VARIANT_BLOCK_SIZE
    off = 12
    block_offsets = raw[off : off + 8 * n_blocks].view(np.uint64).copy()
    if len(block_offsets) != n_blocks:
        raise PgenFormatError(f"{path}: truncated variant block offset index")
    if not np.all(np.diff(block_offsets.astype(np.int64)) > 0) and n_blocks > 1:
        raise PgenFormatError(f"{path}: variant block offsets are not ascending")
    off += 8 * n_blocks

    record_types: set = set()
    record_lengths: set = set()
    for block in range(n_blocks):
        count = (
            num_variants - block * VARIANT_BLOCK_SIZE
            if block == n_blocks - 1
            else VARIANT_BLOCK_SIZE
        )
        tsize = _types_block_nbytes(count, record_type_bits)
        tbytes = raw[off : off + tsize]
        if record_type_bits == 4:
            record_types.update(np.unique(tbytes >> 4).tolist())
            record_types.update(np.unique(tbytes & 0b1111).tolist())
        else:
            record_types.update(np.unique(tbytes).tolist())
        off += tsize
        lsize = count * record_length_bytes
        lraw = raw[off : off + lsize]
        if record_length_bytes == 1:
            lens = lraw.astype(np.uint64)
        else:
            padded = np.zeros((count, 8), dtype=np.uint8)
            padded[:, :record_length_bytes] = lraw.reshape(count, record_length_bytes)
            lens = padded.view(np.uint64).ravel()
        record_lengths.update(np.unique(lens).tolist())
        off += lsize

    return PgenDescription(
        path=path,
        storage_mode=storage_mode,
        num_variants=num_variants,
        num_samples=num_samples,
        record_type_bits=record_type_bits,
        record_length_bytes=record_length_bytes,
        allele_count_bytes=allele_count_bytes,
        provisional_ref_storage=provisional_ref_storage,
        block_offsets=block_offsets,
        record_types=np.array(sorted(record_types), dtype=np.uint8),
        record_lengths=np.array(sorted(record_lengths), dtype=np.uint64),
        variant_records_offset=off,
    )
