"""Plain readers of a PLINK2 mode-0x02 fileset: the ``.pgen`` records, the
``.pvar`` text and the ``.psam`` IIDs, and the 2-bit codes of a block."""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

GT_TEXT = (b"0/0", b"0/1", b"1/1", b"./.")  # codes 0 hom-ref, 1 het, 2 hom-alt, 3 missing


def read_records(prefix) -> tuple[np.ndarray, int]:
    """((V, R) uint8 memory map of the records, number of samples)."""
    path = f"{prefix}.pgen"
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:3] != b"\x6c\x1b\x02" or head[11] != 0x40:
        raise ValueError(f"{path} is not a mode-0x02 .pgen")
    nvar, nsam = struct.unpack("<II", head[3:11])
    rec = (2 * nsam + 7) // 8
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=12, shape=(nvar, rec))
    return mm, nsam


def read_iids(prefix) -> list[str]:
    with open(f"{prefix}.psam") as f:
        rows = f.read().splitlines()
    return [r.split("\t")[0] for r in rows[1:] if r]


@dataclass
class Pvar:
    """A ``.pvar``: its bytes, the ``##`` lines, the ``#CHROM`` line, each
    data row's [start, end) in ``buf`` without the newline, and each row's
    ALT field."""

    buf: np.ndarray
    comments: bytes
    header_line: bytes
    starts: np.ndarray
    ends: np.ndarray
    alt_starts: np.ndarray
    alt_ends: np.ndarray

    def alt_is(self, allele: bytes) -> np.ndarray:
        """(V,) bool: the row's ALT field is ``allele``."""
        n = len(allele)
        hit = (self.alt_ends - self.alt_starts) == n
        for j, ch in enumerate(allele):
            hit &= self.buf[np.minimum(self.alt_starts + j, len(self.buf) - 1)] == ch
        return hit


def read_pvar(prefix) -> Pvar:
    buf = np.fromfile(f"{prefix}.pvar", dtype=np.uint8)
    nl = np.flatnonzero(buf == 10)
    line_starts = np.concatenate(([0], nl[:-1] + 1))
    first = buf[line_starts] == ord("#")
    n_head = int(np.argmin(first)) if not first.all() else len(first)
    head_end = int(line_starts[n_head]) if n_head < len(line_starts) else len(buf)
    comments = buf[: int(line_starts[n_head - 1])].tobytes()
    header_line = buf[int(line_starts[n_head - 1]) : head_end - 1].tobytes()
    starts, ends = line_starts[n_head:], nl[n_head:]
    tabs = np.flatnonzero(buf[head_end:] == 9) + head_end
    per_row = len(tabs) // max(len(starts), 1)
    if per_row * len(starts) != len(tabs):
        raise ValueError("every .pvar row must have as many fields")
    tabs = tabs.reshape(len(starts), per_row)
    return Pvar(buf, comments, header_line, starts, ends, tabs[:, 3] + 1, tabs[:, 4])


def codes(block: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(rows, R) uint8 records -> (rows, num_samples) uint8 2-bit codes
    (sample s in bits 2(s % 4) of byte s // 4)."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=block.device)
    return ((block[:, :, None] >> shifts) & 3).reshape(block.shape[0], -1)[:, :num_samples]


def lines_wrong(got: bytes | None, want: bytes) -> int:
    """Lines of ``want`` that ``got`` does not hold at the same place, plus
    any extra lines of ``got``; every line when there is no output."""
    if got == want:
        return 0
    want_lines = want.split(b"\n")
    if got is None:
        return len(want_lines)
    got_lines = got.split(b"\n")
    wrong = sum(a != b for a, b in zip(got_lines, want_lines))
    return wrong + abs(len(got_lines) - len(want_lines))


def read_output(path) -> bytes | None:
    """A job's output file, or None when it is missing."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None
