"""Columnar .pvar/.psam metadata loader.

Parity notes (reference: pgen-rs/src/pfile.rs):

* Header location rule (pfile.rs:248-268): the leading run of ``#`` lines ends
  the header; the LAST ``#`` line holds the column names, and the reference
  seeks to just past its ``#`` before handing the file to csv. Consequence:
  expression variable names are the column names with the leading ``#``
  stripped from the first column (``CHROM``, ``POS``, …, ``IID``, …).
* VCF passthrough (pfile.rs:202-220): every leading ``#`` line except the last
  is copied verbatim into the output VCF; the last becomes the ``#CHROM…``
  column line.
* The reference parses rows with a strict tab-delimited csv reader
  (pfile.rs:270-283); rows whose field count differs from the header are a
  hard error there, and are here too.

TPU-native design: instead of the reference's per-row csv iteration, the whole
data region is loaded once and field boundaries are recovered with vectorized
byte scans (one pass); per-column padded byte matrices are materialized lazily
for the predicate compiler (SURVEY.md C5/C7). Raw row bytes are kept so the
VCF writer can emit pvar columns byte-exactly without re-joining.

Copied from ``pgen_tpu/formats/metadata.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


class MetadataFormatError(ValueError):
    """A .pvar/.psam file violated a format invariant."""


@dataclass
class MetadataTable:
    path: str
    comments: str  # leading '#' lines except the last, verbatim (incl. newlines)
    header_line: str  # the last '#' line, without trailing newline, incl. '#'
    columns: tuple  # column names; first has '#' stripped
    num_rows: int
    # Data region internals (vectorized access):
    _buf: np.ndarray = field(repr=False)  # uint8 view of the data region
    _tabs: np.ndarray = field(repr=False)  # (rows, cols-1) int64 tab positions
    _line_starts: np.ndarray = field(repr=False)  # (rows,) int64
    _line_ends: np.ndarray = field(repr=False)  # (rows,) int64, excl. newline
    _col_cache: dict = field(default_factory=dict, repr=False)

    # -- column access ------------------------------------------------------

    def field_starts(self, j: int) -> np.ndarray:
        """Start offsets of column j in every row (derived from the tab
        index lazily — no (rows, cols) offset matrices are materialized)."""
        return self._line_starts if j == 0 else self._tabs[:, j - 1] + 1

    def field_ends(self, j: int) -> np.ndarray:
        return self._line_ends if j == len(self.columns) - 1 else self._tabs[:, j]

    def column_index(self, name: str) -> int:
        try:
            return self.columns.index(name)
        except ValueError:
            raise MetadataFormatError(
                f"{name} not among the headers of {self.path}"
            ) from None

    def get_column_padded(self, name: str):
        """Return (codes, lengths): a (rows, width) uint8 matrix of the
        column's bytes padded with zeros, and per-row byte lengths.

        This is the device-friendly representation the predicate compiler
        ships to TPU (zero-padded u8 tiles; SURVEY.md C7).
        """
        key = ("padded", name)
        if key not in self._col_cache:
            j = self.column_index(name)
            starts = self.field_starts(j)
            ends = self.field_ends(j)
            lens = ends - starts
            width = max(int(lens.max(initial=0)), 1)
            try:
                from pgen_tpu_torch.native import HAVE_NATIVE, native
            except ImportError:
                HAVE_NATIVE = False
            if HAVE_NATIVE and self.num_rows > 4096:
                # one memcpy pass; the numpy fallback's fancy-index gather
                # builds a rows*width int64 index matrix (query hot spot)
                mat = native.extract_column(self._buf, starts, lens, width)
            else:
                offs = np.arange(width, dtype=np.int64)
                idx = starts[:, None] + offs[None, :]
                np.minimum(idx, len(self._buf) - 1, out=idx)
                mat = self._buf[idx]
                mat[offs[None, :] >= lens[:, None]] = 0
            self._col_cache[key] = (mat, lens.astype(np.int32))
        return self._col_cache[key]

    def column_equals(self, name: str, literal: bytes) -> np.ndarray:
        """Vectorized ``column == literal`` without materializing the padded
        column matrix: length compare + one byte-gather pass per literal
        byte. The hot path of keep-K predicates over millions of rows."""
        j = self.column_index(name)
        starts = self.field_starts(j)
        ends = self.field_ends(j)
        try:
            from pgen_tpu_torch.native import HAVE_NATIVE, native
        except ImportError:
            HAVE_NATIVE = False
        if HAVE_NATIVE and self.num_rows > 4096:
            return native.column_equals(self._buf, starts, ends, literal)
        lens = ends - starts
        mask = lens == len(literal)
        for k, ch in enumerate(literal):
            if not mask.any():
                break
            idx = np.minimum(starts + k, len(self._buf) - 1)
            mask &= self._buf[idx] == ch
        return mask

    def get_column_bytes(self, name: str) -> np.ndarray:
        """Column as a numpy 'S' fixed-width bytes array (host predicates)."""
        key = ("S", name)
        if key not in self._col_cache:
            mat, _ = self.get_column_padded(name)
            width = mat.shape[1]
            arr = np.ascontiguousarray(mat).view(f"S{width}").ravel()
            self._col_cache[key] = arr
        return self._col_cache[key]

    def get_virtual_bytes(self, name: str):
        """Virtual columns: ``INFO_<KEY>`` resolves to the KEY subfield of
        the INFO column (reference "next steps", README.md:205-207 —
        bcftools' INFO/AF equivalent). Value semantics: the subfield's
        string value; ``"1"`` for a bare flag; ``"."`` when absent.
        Returns an 'S' array, or None if the name isn't a known virtual.
        """
        if not name.startswith("INFO_") or len(name) <= 5 or "INFO" not in self.columns:
            return None
        key = ("virt", name)
        if key not in self._col_cache:
            subkey = name[5:].encode("utf-8")
            j = self.column_index("INFO")
            starts = self.field_starts(j)
            ends = self.field_ends(j)
            vs, vl = self._info_extract(starts, ends, subkey)
            lens = np.where(vl >= 0, vl, 1)
            width = max(int(lens.max(initial=0)), 1)
            offs = np.arange(width, dtype=np.int64)
            idx = np.where(vl >= 0, vs, 0)[:, None] + offs[None, :]
            np.minimum(idx, max(len(self._buf) - 1, 0), out=idx)
            mat = (
                self._buf[idx]
                if len(self._buf)
                else np.zeros((len(vs), width), np.uint8)
            )
            mat[offs[None, :] >= lens[:, None]] = 0
            absent = vl == -1
            flag = vl == -2
            mat[absent, 0] = ord(".")
            mat[absent, 1:] = 0
            mat[flag, 0] = ord("1")
            mat[flag, 1:] = 0
            self._col_cache[key] = (
                np.ascontiguousarray(mat).view(f"S{width}").ravel()
            )
        return self._col_cache[key]

    def get_virtual_strs(self, name: str):
        arr = self.get_virtual_bytes(name)
        if arr is None:
            return None
        key = ("virtstr", name)
        if key not in self._col_cache:
            self._col_cache[key] = [b.decode("utf-8") for b in arr]
        return self._col_cache[key]

    def _info_extract(self, starts, ends, subkey: bytes):
        try:
            from pgen_tpu_torch.native import HAVE_NATIVE, native
        except ImportError:
            HAVE_NATIVE = False
        if HAVE_NATIVE and self.num_rows > 1024:
            return native.info_extract(self._buf, starts, ends, subkey)
        vs = np.zeros(self.num_rows, dtype=np.int64)
        vl = np.full(self.num_rows, -1, dtype=np.int64)
        buf = self._buf
        for i in range(self.num_rows):
            s, e = int(starts[i]), int(ends[i])
            field = buf[s:e].tobytes()
            pos = 0
            while pos < len(field):
                semi = field.find(b";", pos)
                seg_end = semi if semi >= 0 else len(field)
                if field[pos:seg_end].startswith(subkey):
                    after = pos + len(subkey)
                    if after == seg_end:
                        vl[i] = -2
                        break
                    if field[after : after + 1] == b"=":
                        vs[i] = s + after + 1
                        vl[i] = seg_end - (after + 1)
                        break
                pos = seg_end + 1
        return vs, vl

    def get_column_strs(self, name: str) -> list:
        """Column as Python strings (row-interpreter fallback path)."""
        key = ("str", name)
        if key not in self._col_cache:
            self._col_cache[key] = [
                b.decode("utf-8") for b in self.get_column_bytes(name)
            ]
        return self._col_cache[key]

    # -- row access ---------------------------------------------------------

    def row_bytes(self, i: int) -> bytes:
        """Raw bytes of data row i (no trailing newline)."""
        return self._buf[self._line_starts[i] : self._line_ends[i]].tobytes()

    def row_fields(self, i: int) -> list:
        return [
            self._buf[self.field_starts(j)[i] : self.field_ends(j)[i]]
            .tobytes()
            .decode("utf-8")
            for j in range(len(self.columns))
        ]

    def row_line_spans(self) -> tuple:
        """(starts, ends) of every data row within the data buffer."""
        return self._line_starts, self._line_ends

    @property
    def data_buffer(self) -> np.ndarray:
        return self._buf


class _HasCarriageReturns(Exception):
    """Internal: the data region contains CR bytes; re-read + normalize."""


def _scan_separators(buf: np.ndarray) -> tuple:
    """(newline_positions, tab_positions, cr_count), via the native SIMD
    scan when available (one pass) else numpy."""
    try:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
    except ImportError:
        HAVE_NATIVE = False
    if HAVE_NATIVE and buf.nbytes > (1 << 16):
        tabs, nls, crs = native.scan_seps(buf)
        return nls, tabs, crs
    return (
        np.flatnonzero(buf == ord("\n")),
        np.flatnonzero(buf == ord("\t")),
        int((buf == ord("\r")).sum()),
    )


def _locate_header(raw: bytes, path: str) -> tuple:
    """Return (comments, header_line, data_offset) per the reference rule."""
    pos = 0
    comment_spans = []
    n = len(raw)
    while pos < n and raw[pos : pos + 1] == b"#":
        nl = raw.find(b"\n", pos)
        end = n if nl < 0 else nl + 1
        comment_spans.append((pos, end))
        pos = end
    if not comment_spans:
        raise MetadataFormatError(
            f"{path}: no '#' header line found; the last leading '#' line must "
            f"hold the column names"
        )
    hdr_start, hdr_end = comment_spans[-1]
    comments = raw[: hdr_start].decode("utf-8")
    header_line = raw[hdr_start:hdr_end].decode("utf-8").rstrip("\r\n")
    return comments, header_line, pos


_HEAD_PROBE = 1 << 20


def read_metadata(path: str | Path) -> MetadataTable:
    """Load a .pvar/.psam. Fast path maps the file read-only (no copy, no
    page-zeroing of a fresh buffer); any carriage return anywhere falls
    back to a full read with CRLF normalization (plink2 writes bare \\n)."""
    path = str(path)
    import os

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(min(size, _HEAD_PROBE))
    use_mmap = size > len(head)
    if use_mmap and b"\r" not in head:
        try:
            comments, header_line, data_off = _locate_header(head, path)
        except MetadataFormatError:
            use_mmap = False  # header may extend past the probe; re-read
        else:
            if data_off >= len(head):
                use_mmap = False
            else:
                mm = np.memmap(path, dtype=np.uint8, mode="r")
                try:
                    return _parse_data_region(
                        path, comments, header_line, mm[data_off:]
                    )
                except _HasCarriageReturns:
                    pass  # rare CRLF data: re-read + normalize below
    if size <= len(head):
        raw = head
    else:
        with open(path, "rb") as f:
            raw = f.read()
    if b"\r\n" in raw:
        raw = raw.replace(b"\r\n", b"\n")
    comments, header_line, data_off = _locate_header(raw, path)
    return _parse_data_region(
        path,
        comments,
        header_line,
        np.frombuffer(raw, dtype=np.uint8)[data_off:],
        allow_cr=True,
    )


def _parse_data_region(path, comments, header_line, buf, allow_cr=False) -> MetadataTable:
    # Column names: the header line minus its leading '#'.
    columns = tuple(header_line[1:].split("\t"))
    ncols = len(columns)
    nl_pos, tab_pos, cr_count = _scan_separators(buf)
    if cr_count and not allow_cr:
        raise _HasCarriageReturns
    if len(buf) and (len(nl_pos) == 0 or nl_pos[-1] != len(buf) - 1):
        # final line lacks a trailing newline; treat end-of-buffer as a break
        nl_pos = np.append(nl_pos, len(buf))
    line_starts = np.concatenate(([0], nl_pos[:-1] + 1)) if len(nl_pos) else np.empty(0, np.int64)
    line_ends = nl_pos
    # drop empty trailing lines (e.g. file ending in '\n')
    keep = line_ends > line_starts
    if not keep.all():
        line_starts, line_ends = line_starts[keep], line_ends[keep]
    line_starts = np.asarray(line_starts, dtype=np.int64)
    line_ends = np.asarray(line_ends, dtype=np.int64)
    nrows = len(line_starts)

    if nrows:
        # Fast path: a well-formed file has exactly ncols-1 tabs per row, so
        # the sorted tab positions reshape directly; the bounds check below
        # catches any misalignment (then the slow path names the bad row).
        if len(tab_pos) == nrows * (ncols - 1):
            if ncols > 1:
                tabs = tab_pos.reshape(nrows, ncols - 1)
                # first tab may sit AT line start (empty first field); all
                # tabs sorted, so first/last in-bounds => all in-bounds
                ok = (tabs[:, 0] >= line_starts).all() and (
                    tabs[:, -1] < line_ends
                ).all()
            else:
                tabs = np.empty((nrows, 0), np.int64)
                ok = True
        else:
            ok = False
        if not ok:
            _raise_ragged_row(path, ncols, tab_pos, line_starts, line_ends)
    else:
        tabs = np.empty((0, max(ncols - 1, 0)), np.int64)

    return MetadataTable(
        path=path,
        comments=comments,
        header_line=header_line,
        columns=columns,
        num_rows=nrows,
        _buf=buf,
        _tabs=tabs,
        _line_starts=line_starts,
        _line_ends=line_ends,
    )


def _raise_ragged_row(path, ncols, tab_pos, line_starts, line_ends):
    """Slow path: locate and report the first row whose field count differs
    from the header's (strict-csv error parity with the reference)."""
    nrows = len(line_starts)
    row_of_tab = np.searchsorted(line_ends, tab_pos, side="left")
    in_line = (row_of_tab < nrows) & (
        tab_pos >= line_starts[np.minimum(row_of_tab, nrows - 1)]
    )
    tabs_per_row = np.bincount(row_of_tab[in_line], minlength=nrows)
    bad = np.flatnonzero(tabs_per_row != ncols - 1)
    i = int(bad[0]) if len(bad) else 0
    raise MetadataFormatError(
        f"{path}: row {i} has {int(tabs_per_row[i]) + 1} fields, "
        f"header has {ncols}"
    )
