"""Mode-0x02 .pgen writer: the pack twin of the decode path.

The reference only reads .pgen (writing is listed as future work,
pgen-rs/README.md:217-219), but a writer falls out of the pinned
geometry (SURVEY.md C3/C9/C10) and is required here to regenerate the fixture
.pgen blobs stripped from the reference mount (C13) and to enable
pgen-to-pgen filtering output.

Layout written (mirrors what the mode-0x02 reader demands):
  bytes 0-1   magic 0x6C 0x1B
  byte  2     storage mode 0x02
  bytes 3-6   LE u32 num_variants
  bytes 7-10  LE u32 num_samples
  byte  11    format byte 0x40
  then num_variants records of ceil(2*num_samples/8) bytes; within each byte
  the 4 samples' 2-bit codes are packed LSB-first (pfile.rs:171-175).

Copied from ``pgen_tpu/formats/writer.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    variant_record_size,
)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack a (variants, samples) uint8 matrix of 2-bit codes (0..3) into the
    (variants, ceil(S/4)) packed byte matrix, LSB-first within each byte."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.ndim != 2:
        raise ValueError(f"codes must be 2-D (variants, samples), got {codes.shape}")
    if codes.size and codes.max() > 3:
        raise ValueError("genotype codes must be in 0..3")
    nvar, nsamp = codes.shape
    rec_size = variant_record_size(nsamp)
    padded = np.zeros((nvar, rec_size * 4), dtype=np.uint8)
    padded[:, :nsamp] = codes
    quads = padded.reshape(nvar, rec_size, 4)
    weights = np.array([1, 4, 16, 64], dtype=np.uint8)
    # uint8 accumulate is safe: max 3*(1+4+16+64) = 255
    return (quads * weights).sum(axis=2, dtype=np.uint16).astype(np.uint8)


def write_pgen(path: str | Path, codes: np.ndarray) -> None:
    """Write a mode-0x02 .pgen holding the given (variants, samples) codes."""
    packed = pack_codes(codes)
    nvar, nsamp = codes.shape
    with open(path, "wb") as f:
        f.write(PGEN_MAGIC)
        f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
        f.write(struct.pack("<II", nvar, nsamp))
        f.write(bytes([MODE2_FORMAT_BYTE]))
        f.write(packed.tobytes())


def write_pgen_packed(path: str | Path, packed: np.ndarray, num_samples: int) -> None:
    """Write already-packed records (variants, rec_size) without unpacking."""
    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    if packed.shape[1] != variant_record_size(num_samples):
        raise ValueError(
            f"record size {packed.shape[1]} != ceil(2*{num_samples}/8)"
        )
    with open(path, "wb") as f:
        f.write(PGEN_MAGIC)
        f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
        f.write(struct.pack("<II", nvar, num_samples))
        f.write(bytes([MODE2_FORMAT_BYTE]))
        f.write(packed.tobytes())
