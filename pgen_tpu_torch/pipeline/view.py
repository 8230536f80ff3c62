"""`view`: print (regions of) an existing .vcf.gz — the tabix/bcftools-view
read side of the index this tool emits.

Without -r the whole file streams through the bounded-memory BGZF member
decoder. With -r, only the blocks whose index bins overlap the requested
spans are decompressed (formats/tabix.py fetch_region), so a region pull
from a multi-GB file touches kilobytes. The ':'-in-contig ambiguity of
region specs (GRCh38 HLA alts) resolves against the index's own contig
list, exactly as bcftools resolves it against the header.

The reference can only scan whole filesets (pgen-rs/src/pfile.rs:78).

Copied from ``pgen_tpu/pipeline/view.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import sys

import numpy as np

from pgen_tpu_torch.query.regions import RegionSpecError, _pos_int

_HUGE_END = 1 << 60


class VcfViewError(ValueError):
    """The view request cannot be served."""


def parse_region_coords(spec: str, known_contigs=()) -> list:
    """-r spec -> [(chrom, beg0, end0)] 0-based half-open coordinate spans.

    known_contigs settles CHROM-containing-':' ambiguity: a token that IS
    a known contig name matches the whole contig even if it looks like
    CHROM:SPAN."""
    out = []
    known = set(known_contigs)
    for raw in spec.split(","):
        tok = raw.strip()
        if not tok:
            continue
        if ":" not in tok or tok in known:
            out.append((tok, 0, _HUGE_END))
            continue
        chrom, _, span = tok.rpartition(":")
        if not chrom:
            raise RegionSpecError(f"bad region {tok!r}: empty contig name")
        if "-" in span:
            beg_s, _, end_s = span.partition("-")
            beg = _pos_int(beg_s, tok)
            if end_s:
                end = _pos_int(end_s, tok)
                if end < beg:
                    raise RegionSpecError(f"bad region {tok!r}: end < start")
                out.append((chrom, beg - 1, end))
            else:
                out.append((chrom, beg - 1, _HUGE_END))
        else:
            pos = _pos_int(span, tok)
            out.append((chrom, pos - 1, pos))
    if not out:
        raise RegionSpecError(f"empty region spec {spec!r}")
    return out


def _find_index(gz_path: str) -> str:
    import os

    for ext in (".tbi", ".csi"):
        p = gz_path + ext
        if os.path.exists(p):
            return p
    raise VcfViewError(
        f"{gz_path}: no .tbi/.csi index found — run `pgen-tpu index "
        f"{gz_path}` first (region view needs random access)"
    )


def _index_contigs(index_path: str) -> list:
    import gzip

    from pgen_tpu_torch.formats.tabix import CSI_MAGIC, read_csi, read_tbi

    magic = gzip.decompress(open(index_path, "rb").read())[:4]
    if magic == CSI_MAGIC:
        names = read_csi(index_path)[0]
    else:
        names = read_tbi(index_path)[0]
    return list(names)


def _header_bytes(gz_path: str) -> bytes:
    """The leading '#' lines, decompressed member by member (the header is
    tiny vs the body; each window rescans at most the header region)."""
    from pgen_tpu_torch.pipeline.vcf_import_host import _gz_windows

    windows, _ = _gz_windows(gz_path, 1 << 20)
    buf = b""
    for win in windows:
        buf += bytes(np.asarray(win))
        pos = 0
        while pos < len(buf):
            if not buf.startswith(b"#", pos):
                return buf[:pos]
            nl = buf.find(b"\n", pos)
            if nl < 0:
                break  # line incomplete: decode another window
            pos = nl + 1
    return buf  # header-only file


def view_vcf_gz(
    gz_path: str,
    regions: str | None = None,
    header: bool = True,
    out=None,
) -> int:
    """Write (regions of) the VCF to ``out`` (default stdout). Returns the
    number of data rows written."""
    from pgen_tpu_torch.formats.tabix import fetch_region

    sink = out if out is not None else sys.stdout.buffer
    rows = 0
    if regions is None:
        from pgen_tpu_torch.pipeline.vcf_import_host import _gz_windows

        windows, _ = _gz_windows(gz_path, 32 << 20)
        in_header = True
        carry = b""
        for win in windows:
            buf = carry + bytes(np.asarray(win))
            cut = buf.rfind(b"\n") + 1
            complete, carry = buf[:cut], buf[cut:]
            pos = 0
            if in_header:
                while pos < len(complete) and complete.startswith(b"#", pos):
                    pos = complete.find(b"\n", pos) + 1
                if pos < len(complete):
                    in_header = False
                if header:
                    sink.write(complete[:pos])
            body = complete[pos:]
            rows += body.count(b"\n")
            sink.write(body)
        if carry:  # final line without a trailing newline
            if in_header and carry.startswith(b"#"):
                if header:
                    sink.write(carry)
            else:
                sink.write(carry)
                rows += 1
        return rows
    index_path = _find_index(gz_path)
    contigs = _index_contigs(index_path)
    coords = parse_region_coords(regions, contigs)
    if header:
        sink.write(_header_bytes(gz_path))
    for chrom, beg, end in coords:
        for line in fetch_region(gz_path, index_path, chrom, beg, end):
            sink.write(line)
            sink.write(b"\n")
            rows += 1
    return rows
