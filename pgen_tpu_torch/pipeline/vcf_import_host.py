"""The host half of ``pgen_tpu/pipeline/vcf_import.py``, copied: the
streaming reader of a ``.vcf``/``.vcf.gz`` and its numpy parse into codes
and ``.pvar`` rows. Only the imports differ, and ``pgen-rs/`` stands for
the reference tool's sources in citations. Left out: ``_pack`` (its
device branch runs jax), ``_resolve_provider`` and ``import_vcf``; the
port's import is ``pipeline/vcf_import.py``.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.utils.timer import StageTimer

VCF_FIXED_COLUMNS = ("CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT")
DEFAULT_CHUNK_BYTES = 64 << 20

_TAB = 9
_NL = 10
_DOT = ord(".")
_COLON = ord(":")
_SLASH = ord("/")
_PIPE = ord("|")
_G = ord("G")
_T = ord("T")


class VcfImportError(ValueError):
    """The input VCF violated an import invariant."""


@dataclass
class ImportResult:
    out_prefix: str
    num_variants: int
    num_samples: int
    bytes_read: int
    timer: StageTimer


def _bgzf_member_spans(comp: np.ndarray):
    """Walk a BGZF member chain: [(offset, member_len, decoded_len)], or
    None when `comp` is not well-formed BGZF (generic gzip fallback)."""
    n = comp.nbytes
    off = 0
    spans = []
    while off < n:
        if n - off < 28:
            return None
        hdr = bytes(np.asarray(comp[off : off + 12]))
        if hdr[0] != 0x1F or hdr[1] != 0x8B or hdr[2] != 8 or not (hdr[3] & 4):
            return None
        xlen = hdr[10] | (hdr[11] << 8)
        if n - off < 12 + xlen + 8:
            return None
        extra = bytes(np.asarray(comp[off + 12 : off + 12 + xlen]))
        bsize = -1
        x = 0
        while x + 4 <= xlen:
            slen = extra[x + 2] | (extra[x + 3] << 8)
            if extra[x] == 0x42 and extra[x + 1] == 0x43 and slen == 2 and x + 6 <= xlen:
                bsize = (extra[x + 4] | (extra[x + 5] << 8)) + 1
                break
            x += 4 + slen
        if bsize < 12 + xlen + 8 or off + bsize > n:
            return None
        tail = bytes(np.asarray(comp[off + bsize - 4 : off + bsize]))
        spans.append((off, bsize, int.from_bytes(tail, "little")))
        off += bsize
    return spans


def _gz_windows(path: str, target: int):
    """(windows generator, total decoded size or None) for a .gz input.

    BGZF members are independent, so decode happens in ~target-byte
    member GROUPS — bounded memory, never the whole file at once (the
    native parallel CRC-checked decoder when available; the gzip module
    handles each group too, since members are plain concatenated gzip
    streams). Non-BGZF gzip has no random access: whole-file fallback."""
    comp = np.memmap(path, dtype=np.uint8, mode="r")
    spans = _bgzf_member_spans(comp)
    if spans is None:
        raw = gzip.decompress(bytes(comp))

        def whole():
            yield np.frombuffer(raw, dtype=np.uint8)

        return whole(), len(raw)
    try:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
    except ImportError:
        HAVE_NATIVE = False
    use_native = HAVE_NATIVE and getattr(native, "has_bgzf_decompress", False)

    def gen():
        i = 0
        while i < len(spans):
            j, out_sz = i, 0
            while j < len(spans) and out_sz < target:
                out_sz += spans[j][2]
                j += 1
            a = spans[i][0]
            b = spans[j - 1][0] + spans[j - 1][1]
            grp = np.ascontiguousarray(comp[a:b])
            if use_native:
                out = native.bgzf_decompress(grp)
                if out is None:
                    raise VcfImportError(
                        f"{path}: corrupt BGZF member near byte {a} "
                        f"(CRC/size mismatch)"
                    )
            else:
                out = np.frombuffer(gzip.decompress(grp.tobytes()), dtype=np.uint8)
            if len(out):
                yield out
            i = j

    return gen(), sum(s[2] for s in spans)


def _find_nl(buf: np.ndarray, pos: int) -> int:
    """Index of the first newline at/after pos, or -1 (windowed scan so a
    multi-GB body is never swept for a header-region line break)."""
    n = len(buf)
    cur, win = pos, 1 << 16
    while cur < n:
        end = min(cur + win, n)
        rel = np.flatnonzero(buf[cur:end] == _NL)
        if len(rel):
            return cur + int(rel[0])
        cur = end
        win *= 4
    return -1


def _parse_header(buf: np.ndarray, path: str):
    """Split leading '#' lines: (comment_bytes, sample_ids, body_start)."""
    # find end of the header region line by line (header is tiny vs body)
    pos = 0
    comments_end = 0
    column_line = None
    n = len(buf)
    while pos < n and buf[pos] == ord("#"):
        line_end = _find_nl(buf, pos)
        if line_end < 0:
            raise VcfImportError(f"{path}: unterminated header line at byte {pos}")
        if pos + 1 < n and buf[pos + 1] == ord("#"):
            comments_end = line_end + 1
        else:
            column_line = bytes(buf[pos:line_end])
        pos = line_end + 1
    if column_line is None:
        raise VcfImportError(f"{path}: no #CHROM column header line found")
    cols = column_line.decode().split("\t")
    if cols[0].lstrip("#") != "CHROM" or tuple(c for c in cols[1:9]) != VCF_FIXED_COLUMNS[1:]:
        raise VcfImportError(
            f"{path}: unsupported column layout {cols[:9]}; need "
            f"#CHROM..INFO,FORMAT (GT-bearing VCF)"
        )
    samples = cols[9:]
    if not samples:
        raise VcfImportError(f"{path}: no sample columns after FORMAT (nothing to import)")
    return bytes(buf[:comments_end]), samples, pos


def _raise_bad_row(path: str, row0: int, what: str):
    raise VcfImportError(f"{path}: data row {row0 + 1}: {what}")


def _parse_chunk_numpy(chunk: np.ndarray, n_samples: int, path: str, row_base: int):
    """(codes (rows, N) u8, pvar_bytes, rows) for one newline-terminated chunk."""
    # pad so reads at start+3 of a final '.' field never leave the buffer
    buf = np.empty(len(chunk) + 4, dtype=np.uint8)
    buf[: len(chunk)] = chunk
    buf[len(chunk) :] = _NL
    nls = np.flatnonzero(buf[: len(chunk)] == _NL)
    tabs = np.flatnonzero(buf[: len(chunk)] == _TAB)
    rows = len(nls)
    per = 8 + n_samples
    if len(tabs) != rows * per:
        # locate the first row whose tab count is off
        cnt = np.searchsorted(tabs, nls)
        cnt = np.diff(np.concatenate([[0], cnt]))
        bad = int(np.argmax(cnt != per))
        _raise_bad_row(
            path, row_base + bad, f"expected {per} tab-separated field breaks, found {int(cnt[bad])}"
        )
    t = tabs.reshape(rows, per)
    line_starts = np.concatenate([[0], nls[:-1] + 1])
    if rows and (np.any(t[:, 0] <= line_starts) or np.any(t[:, -1] >= nls)):
        bad = int(np.argmax((t[:, 0] <= line_starts) | (t[:, -1] >= nls)))
        _raise_bad_row(path, row_base + bad, "tab/field layout is ragged")

    # FORMAT must lead with GT (VCF spec requires GT first when present);
    # FORMAT is field 9: it starts after tab 7 (post-INFO) and ends at tab 8
    f = t[:, 7] + 1
    okf = (buf[f] == _G) & (buf[f + 1] == _T) & ((buf[f + 2] == _TAB) | (buf[f + 2] == _COLON))
    if not okf.all():
        bad = int(np.argmax(~okf))
        _raise_bad_row(path, row_base + bad, "FORMAT does not begin with GT")

    s = t[:, 8:] + 1  # (rows, N) sample-field starts
    b0 = buf[s]
    b1 = buf[s + 1]
    b2 = buf[s + 2]
    after = buf[s + 3]
    # GT grammar (matches the native parser exactly): a lone '.'; or a
    # pair a{/|}b with a,b in {0,1,.}. Any '.' allele imports as missing
    # (plink2 hard-call semantics for partially-missing genotypes). The
    # byte after the token must terminate it (tab / ':' subfields / eol).
    d0 = (b0 == 48) | (b0 == 49)
    m0 = b0 == _DOT
    d2 = (b2 == 48) | (b2 == 49)
    m2 = b2 == _DOT
    sep = (b1 == _SLASH) | (b1 == _PIPE)
    term1 = (b1 == _TAB) | (b1 == _COLON) | (b1 == _NL)
    term3 = (after == _TAB) | (after == _COLON) | (after == _NL)
    pair = (d0 | m0) & sep & (d2 | m2) & term3
    lone = m0 & term1
    ok = pair | lone
    if not ok.all():
        flat = int(np.argmax(~ok))
        r, c = divmod(flat, n_samples)
        gt = bytes(buf[s[r, c] : s[r, c] + 3]).decode("latin1")
        _raise_bad_row(
            path,
            row_base + r,
            f"sample {c + 1}: unsupported GT {gt!r} (biallelic hard calls "
            f"0/0,0/1,1/1,./. only — mode-0x02 stores 2-bit codes)",
        )
    miss = lone | (m0 | m2)
    codes = np.where(miss, np.uint8(3), ((b0 - 48) + (b2 - 48)).astype(np.uint8))

    # pvar rows: span-gather [line_start, tab_after_INFO) + '\n'
    p_end = t[:, 7]
    lens = p_end - line_starts
    out_off = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    pos = np.arange(len(out), dtype=np.int64)
    row_of = np.repeat(np.arange(rows, dtype=np.int64), lens + 1)
    local = pos - out_off[row_of]
    src = np.minimum(line_starts[row_of] + local, len(buf) - 1)
    np.copyto(out, buf[src])
    out[out_off[1:] - 1] = _NL
    return codes, out.tobytes(), rows


def _chunk_spans(buf: np.ndarray, body_start: int, chunk_bytes: int):
    """Newline-aligned [start, end) spans covering buf[body_start:]."""
    n = len(buf)
    start = body_start
    while start < n:
        end = min(start + chunk_bytes, n)
        if end < n:
            # extend to the next newline (windowed: lines are short)
            nl = _find_nl(buf, end)
            end = n if nl < 0 else nl + 1
        yield start, end
        start = end


def _header_complete(buf: np.ndarray) -> bool:
    """True once `buf` contains the start of a non-'#' line (the header
    region is fully present)."""
    pos = 0
    n = len(buf)
    while pos < n:
        if buf[pos] != ord("#"):
            return True
        nl = _find_nl(buf, pos)
        if nl < 0:
            return False
        pos = nl + 1
    return False


def _stream_chunks(lead: np.ndarray, win_iter, chunk_bytes: int):
    """Newline-terminated chunks from a window stream, bounded memory.

    Carries the trailing partial line of each window into the next; a
    missing final newline is repaired by appending one."""
    pending = np.ascontiguousarray(lead)
    for w in win_iter:
        buf = w if not len(pending) else np.concatenate([pending, w])
        nls = np.flatnonzero(buf == _NL)
        if len(nls) == 0:
            pending = np.ascontiguousarray(buf)
            continue
        cut = int(nls[-1]) + 1
        pending = np.ascontiguousarray(buf[cut:])
        for s, e in _chunk_spans(buf[:cut], 0, chunk_bytes):
            yield np.ascontiguousarray(buf[s:e])
    if len(pending):
        if pending[-1] != _NL:  # repair a missing final newline only
            pending = np.concatenate([pending, np.array([_NL], dtype=np.uint8)])
        for s, e in _chunk_spans(pending, 0, chunk_bytes):
            yield np.ascontiguousarray(pending[s:e])
