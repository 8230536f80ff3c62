"""Mode-0x02 PGEN header parsing and record geometry.

Behavior parity with the reference engine's header path
(pgen-rs/src/pfile.rs:38-76):

* magic number ``0x6C 0x1B`` (pfile.rs:47)
* storage mode byte must be ``0x02`` — the fixed-width unphased hard-call
  byte matrix (pfile.rs:53)
* little-endian u32 variant count then sample count (pfile.rs:57,62)
* a final format byte that must be ``0x40`` (pfile.rs:69)
* the header is exactly 12 bytes; variant records are laid out back-to-back
  starting at offset 12 (pfile.rs:165)
* per-variant record size is ``ceil(2 * num_samples / 8)`` bytes
  (pfile.rs:196-200), i.e. 4 two-bit hard calls per byte.

All violations raise ``PgenFormatError`` (the reference fail-fast asserts;
SURVEY.md §5 "Failure detection").

Copied from ``pgen_tpu/formats/header.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

PGEN_MAGIC = b"\x6c\x1b"
FIXED_WIDTH_STORAGE_MODE = 0x02
MODE2_FORMAT_BYTE = 0x40
HEADER_SIZE = 12


class PgenFormatError(ValueError):
    """A .pgen file violated a format invariant."""


@dataclass(frozen=True)
class PgenHeader:
    """Parsed 12-byte mode-0x02 header."""

    path: str
    num_variants: int
    num_samples: int

    @property
    def record_size(self) -> int:
        """Bytes per variant record: ceil(2*S/8)."""
        return variant_record_size(self.num_samples)

    @property
    def records_offset(self) -> int:
        return HEADER_SIZE

    def record_offset(self, variant_index: int) -> int:
        return HEADER_SIZE + variant_index * self.record_size

    @property
    def expected_file_size(self) -> int:
        return HEADER_SIZE + self.num_variants * self.record_size


def variant_record_size(num_samples: int) -> int:
    """ceil(2*num_samples/8) bytes per variant record (pfile.rs:196-200)."""
    return (2 * num_samples + 7) // 8


def parse_pgen_header(raw: bytes, path: str = "<bytes>") -> PgenHeader:
    if len(raw) < HEADER_SIZE:
        raise PgenFormatError(f"{path}: truncated header ({len(raw)} < {HEADER_SIZE} bytes)")
    magic, storage_mode = raw[:2], raw[2]
    if magic != PGEN_MAGIC:
        raise PgenFormatError(f"{path}: bad magic {magic!r}, want {PGEN_MAGIC!r}")
    if storage_mode != FIXED_WIDTH_STORAGE_MODE:
        raise PgenFormatError(
            f"{path}: unsupported storage mode 0x{storage_mode:02x}; only the "
            f"fixed-width hard-call mode 0x02 is supported (use `pgen-tpu "
            f"describe` to introspect other modes)"
        )
    num_variants, num_samples = struct.unpack_from("<II", raw, 3)
    fmt = raw[11]
    if fmt != MODE2_FORMAT_BYTE:
        raise PgenFormatError(f"{path}: bad mode-0x02 format byte 0x{fmt:02x}, want 0x40")
    return PgenHeader(path=path, num_variants=num_variants, num_samples=num_samples)


def read_pgen_header(path: str | Path) -> PgenHeader:
    path = str(path)
    with open(path, "rb") as f:
        raw = f.read(HEADER_SIZE)
    return parse_pgen_header(raw, path)
