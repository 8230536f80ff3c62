"""Plain reference of a filter to VCF: the rows whose ALT is one allele,
the GT text of a few samples, and the header, as bytes.

The row of variant v is its ``.pvar`` line (CHROM to INFO), ``\tGT``, then
``\t`` and the GT text of each kept sample in ``.psam`` order, and a
newline. The header is ``##fileformat=VCFv4.2``, ``##source=pgen-rs``, the
``.pvar``'s ``##`` lines, its ``#CHROM`` line with ``\tFORMAT`` and the kept
IIDs. The control writes a missing call as ``0/0``, as a lossy converter
that reads missing as hom-ref does.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.fileset import GT_TEXT, Pvar

SOURCE_TAG = b"pgen-rs"


def expected_vcf(records: np.ndarray, pvar: Pvar, iids: list, alt: bytes, samples,
                 control: bool = False) -> bytes:
    """The VCF a filter of ``records`` to the rows with ALT == ``alt`` and the
    ``samples`` (indices) writes."""
    samples = sorted(int(s) for s in samples)
    header = (b"##fileformat=VCFv4.2\n##source=" + SOURCE_TAG + b"\n" + pvar.comments
              + pvar.header_line + b"\tFORMAT\t" + "\t".join(iids[s] for s in samples).encode()
              + b"\n")
    rows = np.flatnonzero(pvar.alt_is(alt))
    table = np.frombuffer(b"".join(b"\t" + t for t in GT_TEXT), dtype=np.uint8).reshape(4, 4)
    if control:
        table = table.copy()
        table[3] = table[0]
    k = len(samples)
    gt = np.empty((len(rows), 4 * k), dtype=np.uint8)
    for j, s in enumerate(samples):
        c = (records[rows, s >> 2] >> (2 * (s & 3))) & 3
        gt[:, 4 * j : 4 * j + 4] = table[c]
    plen = pvar.ends[rows] - pvar.starts[rows]
    rlen = plen + 3 + 4 * k + 1
    off = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(rlen, out=off[1:])
    out = np.empty(int(off[-1]), dtype=np.uint8)
    # each row's line bytes: row r's byte j at off[r] + j from starts[r] + j
    row_of = np.repeat(np.arange(len(rows)), plen)
    within = np.arange(len(row_of), dtype=np.int64) - np.repeat(np.cumsum(plen) - plen, plen)
    out[off[row_of] + within] = pvar.buf[pvar.starts[rows][row_of] + within]
    at = off[:-1] + plen
    for j, ch in enumerate(b"\tGT"):
        out[at + j] = ch
    cols = at[:, None] + 3 + np.arange(4 * k)
    out[cols] = gt
    out[off[1:] - 1] = 10
    return header + out.tobytes()
