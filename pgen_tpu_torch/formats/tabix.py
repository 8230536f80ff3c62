"""Tabix (.tbi) index emission for .vcf.gz outputs.

The reference positions itself as "bcftools for .pgen files"
(pgen-rs/README.md:3-5); the practical other half of
bcftools/tabix compatibility is a region index next to the compressed
VCF. This implements the tabix index format (SAM/tabix spec §"The Tabix
index file format"; htslib tbx.c semantics):

* UCSC binning: bin sizes 2^14..2^29, reg2bin over 0-based half-open
  [beg, end) with end = beg + len(REF) for VCF rows (htslib vcf parse).
* chunks: (virtual_start, virtual_end) runs of records per bin, merged
  when consecutive in file order (ti_index_core behavior).
* 16 kb linear index per reference: smallest virtual offset of any record
  overlapping each window, zero-gaps back-filled.
* virtual offsets: (compressed_block_offset << 16) | within_block_offset.
* the .tbi itself is BGZF-compressed and ends with the BGZF EOF block.

The writer never decompresses the VCF: every kept row's uncompressed
offset is known arithmetically at emission time, and the
uncompressed->virtual mapping comes from walking the BGZF member headers
of the written file (BSIZE in the gzip extra field, ISIZE in the footer —
a few bytes read per 64 KB member).

Copied from ``pgen_tpu/formats/tabix.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import struct

import numpy as np

TBX_MAGIC = b"TBI\x01"
CSI_MAGIC = b"CSI\x01"
_WINDOW_SHIFT = 14  # 16 kb linear-index windows
# .tbi's fixed 5-level/14-shift binning caps positions at 2^29 (512 Mb);
# longer contigs need the generalized .csi index (htslib behavior).
TBI_MAX_POS = 1 << 29
CSI_MIN_SHIFT = 14
CSI_DEPTH = 5


def reg2bin(beg: int, end: int) -> int:
    """UCSC bin for 0-based half-open [beg, end) (tabix spec reg2bin)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list:
    """All bins overlapping [beg, end) — the reader-side query set."""
    bins = [0]
    end -= 1
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def reg2bin_csi(beg: int, end: int, min_shift: int = CSI_MIN_SHIFT, depth: int = CSI_DEPTH) -> int:
    """Generalized CSI bin for [beg, end) (CSI spec reg2bin; at the
    default min_shift=14/depth=5 this equals the tabix binning but with
    no position ceiling)."""
    end -= 1
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    for level in range(depth, 0, -1):
        if beg >> s == end >> s:
            return t + (beg >> s)
        s += 3
        t -= 1 << ((level - 1) * 3)
    return 0


def reg2bins_csi(beg: int, end: int, min_shift: int = CSI_MIN_SHIFT, depth: int = CSI_DEPTH) -> list:
    """All CSI bins overlapping [beg, end) — the reader-side query set.

    Level l (1..depth) bins start at offset (8^l - 1)/7 and cover
    2^(min_shift + 3*(depth-l)) bases each."""
    bins = [0]
    end -= 1
    for level in range(1, depth + 1):
        off = ((1 << (level * 3)) - 1) // 7
        shift = min_shift + 3 * (depth - level)
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def reg2bin_vec(
    beg: np.ndarray,
    end: np.ndarray,
    min_shift: int = CSI_MIN_SHIFT,
    depth: int = CSI_DEPTH,
) -> np.ndarray:
    """Vectorized reg2bin over arrays (tabix binning == CSI at 14/5)."""
    beg = np.asarray(beg, dtype=np.int64)
    e = np.asarray(end, dtype=np.int64) - 1
    bins = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    for level in range(depth, 0, -1):
        hit = ~done & ((beg >> s) == (e >> s))
        bins[hit] = t + (beg[hit] >> s)
        done |= hit
        s += 3
        t -= 1 << ((level - 1) * 3)
    return bins  # rows not matched at any level land in bin 0


def _bulk_bins_chunks(bins: np.ndarray, vbeg: np.ndarray, vend: np.ndarray):
    """File-order chunk runs per bin, vectorized.

    Rows arrive in file order; a bin's chunks merge runs of rows that are
    adjacent both in the bin and in the file (vend[i-1] == vbeg[i]) —
    identical to the scalar add()'s merge rule. Returns
    {bin: [[cb, ce], ...]} with bins iterated in ascending order.
    """
    out: dict = {}
    if len(bins) == 0:
        return out
    order = np.argsort(bins, kind="stable")  # file order within each bin
    b_s = bins[order]
    vb_s = vbeg[order]
    ve_s = vend[order]
    brk = np.ones(len(order), dtype=bool)
    brk[1:] = (b_s[1:] != b_s[:-1]) | (vb_s[1:] != ve_s[:-1])
    starts = np.flatnonzero(brk)
    ends_i = np.append(starts[1:], len(order)) - 1
    cbin = b_s[starts]
    cbeg = vb_s[starts]
    cend = ve_s[ends_i]
    for b, cb, ce in zip(cbin.tolist(), cbeg.tolist(), cend.tolist()):
        out.setdefault(b, []).append([cb, ce])
    return out


def _bulk_lidx(
    beg: np.ndarray, end: np.ndarray, vbeg: np.ndarray, window_shift: int
) -> list:
    """Linear index (min voffset per window a row overlaps), vectorized;
    0 marks untouched windows (same sentinel as the scalar path)."""
    if len(beg) == 0:
        return []
    w0 = beg >> window_shift
    w1 = np.maximum(end - 1, beg) >> window_shift
    nwin = int(w1.max()) + 1
    acc = np.full(nwin, np.iinfo(np.int64).max, dtype=np.int64)
    k = 0
    while True:
        # voffset 0 is the "unset" sentinel (htslib; scalar add() matches):
        # a record at virtual offset 0 can't occur after a VCF header
        m = (w0 + k <= w1) & (vbeg > 0)
        if not (w0 + k <= w1).any():
            break
        if m.any():
            np.minimum.at(acc, (w0 + k)[m], vbeg[m])
        k += 1
    acc[acc == np.iinfo(np.int64).max] = 0
    return acc.tolist()


def bgzf_member_table(path: str):
    """Walk a BGZF file's member headers.

    Returns (c_offsets, u_offsets) int64 arrays: member i occupies
    compressed bytes [c_offsets[i], c_offsets[i+1]) and carries
    uncompressed bytes [u_offsets[i], u_offsets[i+1]).
    """
    c_offs = [0]
    u_offs = [0]
    with open(path, "rb") as f:
        pos = 0
        while True:
            head = f.read(18)
            if len(head) < 18:
                if head:
                    raise ValueError(f"{path}: truncated BGZF member header")
                break
            if head[:4] != b"\x1f\x8b\x08\x04" or head[12:14] != b"BC":
                raise ValueError(f"{path}: not a BGZF member at offset {pos}")
            bsize = struct.unpack("<H", head[16:18])[0] + 1
            f.seek(pos + bsize - 4)
            isize = struct.unpack("<I", f.read(4))[0]
            pos += bsize
            f.seek(pos)
            c_offs.append(pos)
            u_offs.append(u_offs[-1] + isize)
    return np.asarray(c_offs, dtype=np.int64), np.asarray(u_offs, dtype=np.int64)


def virtual_offsets(u_positions: np.ndarray, c_offs: np.ndarray, u_offs: np.ndarray):
    """Map uncompressed byte positions to BGZF virtual offsets (vectorized)."""
    u_positions = np.asarray(u_positions, dtype=np.int64)
    # member index holding each position (u_offs is the member-start table)
    idx = np.searchsorted(u_offs[1:-1], u_positions, side="right")
    within = u_positions - u_offs[idx]
    if np.any(within >= 1 << 16):
        raise ValueError("BGZF member larger than 64 KiB: invalid stream")
    return (c_offs[idx] << 16) | within


class TbiWriter:
    """Accumulate (ref, beg, end, vbeg, vend) records in file order and
    serialize the .tbi. Records must arrive grouped by reference (VCF row
    order); positions may be unsorted within a reference (chunks simply
    don't merge then)."""

    def __init__(self):
        self._refs: dict = {}  # name -> (bins {bin: [chunks]}, lidx list)
        self._order: list = []

    def add(self, ref: str, beg: int, end: int, vbeg: int, vend: int):
        if ref not in self._refs:
            self._refs[ref] = ({}, [])
            self._order.append(ref)
        bins, lidx = self._refs[ref]
        beg = max(beg, 0)  # POS=0 telomere rows: htslib clamps beg<0 to 0
        b = reg2bin(beg, max(end, beg + 1))
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend  # merge file-order-adjacent records
        else:
            chunks.append([vbeg, vend])
        # linear index: min voffset per 16 kb window the record overlaps
        w0 = beg >> _WINDOW_SHIFT
        w1 = max(end - 1, beg) >> _WINDOW_SHIFT
        if len(lidx) <= w1:
            lidx.extend([0] * (w1 + 1 - len(lidx)))
        for w in range(w0, w1 + 1):
            if lidx[w] == 0 or vbeg < lidx[w]:
                lidx[w] = vbeg

    def add_many(self, ref: str, beg, end, vbeg, vend) -> None:
        """Bulk-vectorized add of one reference's rows (file order).

        ~50x the per-row add() at chr22 scale; the ref must not have been
        added before (build_index_for_vcf_gz feeds whole-ref slices).
        """
        if ref in self._refs:
            raise ValueError(f"add_many: {ref} already populated")
        beg = np.maximum(np.asarray(beg, dtype=np.int64), 0)  # htslib clamp
        end = np.maximum(np.asarray(end, dtype=np.int64), beg + 1)
        vbeg = np.asarray(vbeg, dtype=np.int64)
        vend = np.asarray(vend, dtype=np.int64)
        bins = reg2bin_vec(beg, end)
        self._refs[ref] = (
            _bulk_bins_chunks(bins, vbeg, vend),
            _bulk_lidx(beg, end, vbeg, _WINDOW_SHIFT),
        )
        self._order.append(ref)

    def serialize(self) -> bytes:
        out = bytearray()
        out += TBX_MAGIC
        names_blob = b"".join(n.encode() + b"\x00" for n in self._order)
        out += struct.pack(
            "<8i",
            len(self._order),
            2,  # format: VCF
            1,  # seq column
            2,  # begin column
            0,  # end column (derived from REF length)
            ord("#"),  # meta char
            0,  # lines to skip
            len(names_blob),
        )
        out += names_blob
        for name in self._order:
            bins, lidx = self._refs[name]
            # back-fill zero windows with the previous value (htslib)
            filled = list(lidx)
            for i in range(1, len(filled)):
                if filled[i] == 0:
                    filled[i] = filled[i - 1]
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            out += struct.pack("<i", len(filled))
            for v in filled:
                out += struct.pack("<Q", v)
        return bytes(out)

    def write(self, path: str) -> None:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
        from pgen_tpu_torch.pipeline.filter_host import BGZF_EOF

        if not HAVE_NATIVE:
            raise RuntimeError(".tbi emission requires the native runtime")
        payload = self.serialize()
        comp = native.bgzf_compress(np.frombuffer(payload, dtype=np.uint8))
        with open(path, "wb") as f:
            f.write(bytes(comp))
            f.write(BGZF_EOF)


class CsiWriter:
    """CSI (.csi) index writer: the generalized binning index with no
    2^29 position ceiling (htslib csi spec). Same ``add`` interface as
    TbiWriter; the tabix column configuration travels in the aux blob so
    htslib readers treat the file as a tabix index."""

    def __init__(self, min_shift: int = CSI_MIN_SHIFT, depth: int = CSI_DEPTH):
        self.min_shift = min_shift
        self.depth = depth
        self._refs: dict = {}  # name -> ({bin: [chunks]}, lidx list)
        self._order: list = []

    def add(self, ref: str, beg: int, end: int, vbeg: int, vend: int):
        if ref not in self._refs:
            self._refs[ref] = ({}, [])
            self._order.append(ref)
        bins, lidx = self._refs[ref]
        beg = max(beg, 0)  # POS=0 telomere rows: htslib clamps beg<0 to 0
        b = reg2bin_csi(beg, max(end, beg + 1), self.min_shift, self.depth)
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend
        else:
            chunks.append([vbeg, vend])
        # finest-level linear index (min_shift windows): min voffset of any
        # record overlapping each window — the source of bin loffsets
        # (htslib update_loff semantics)
        w0 = beg >> self.min_shift
        w1 = max(end - 1, beg) >> self.min_shift
        if len(lidx) <= w1:
            lidx.extend([0] * (w1 + 1 - len(lidx)))
        for w in range(w0, w1 + 1):
            if lidx[w] == 0 or vbeg < lidx[w]:
                lidx[w] = vbeg

    def add_many(self, ref: str, beg, end, vbeg, vend) -> None:
        """Bulk-vectorized add of one reference's rows (file order)."""
        if ref in self._refs:
            raise ValueError(f"add_many: {ref} already populated")
        beg = np.maximum(np.asarray(beg, dtype=np.int64), 0)  # htslib clamp
        end = np.maximum(np.asarray(end, dtype=np.int64), beg + 1)
        vbeg = np.asarray(vbeg, dtype=np.int64)
        vend = np.asarray(vend, dtype=np.int64)
        bins = reg2bin_vec(beg, end, self.min_shift, self.depth)
        self._refs[ref] = (
            _bulk_bins_chunks(bins, vbeg, vend),
            _bulk_lidx(beg, end, vbeg, self.min_shift),
        )
        self._order.append(ref)

    def _bin_bot(self, b: int) -> int:
        """First finest-level window covered by bin b (htslib hts_bin_bot)."""
        level = 0
        while b >= ((1 << ((level + 1) * 3)) - 1) // 7:
            level += 1
        first = ((1 << (level * 3)) - 1) // 7
        return (b - first) << (3 * (self.depth - level))

    def serialize(self) -> bytes:
        out = bytearray()
        out += CSI_MAGIC
        names_blob = b"".join(n.encode() + b"\x00" for n in self._order)
        aux = struct.pack(
            "<7i", 2, 1, 2, 0, ord("#"), 0, len(names_blob)
        ) + names_blob  # tabix conf: VCF preset, CHROM/POS columns
        out += struct.pack("<3i", self.min_shift, self.depth, len(aux))
        out += aux
        out += struct.pack("<i", len(self._order))
        for name in self._order:
            bins, lidx = self._refs[name]
            filled = list(lidx)
            for i in range(1, len(filled)):
                if filled[i] == 0:
                    filled[i] = filled[i - 1]
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                bot = self._bin_bot(b)
                loff = filled[bot] if bot < len(filled) else 0
                out += struct.pack("<IQi", b, loff, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
        return bytes(out)

    def write(self, path: str) -> None:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
        from pgen_tpu_torch.pipeline.filter_host import BGZF_EOF

        if not HAVE_NATIVE:
            raise RuntimeError(".csi emission requires the native runtime")
        payload = self.serialize()
        comp = native.bgzf_compress(np.frombuffer(payload, dtype=np.uint8))
        with open(path, "wb") as f:
            f.write(bytes(comp))
            f.write(BGZF_EOF)


def build_index_for_vcf_gz(
    gz_path: str,
    chroms: list,
    pos_1based: np.ndarray,
    ref_lens: np.ndarray,
    row_u_starts: np.ndarray,
    row_u_ends: np.ndarray,
    tbi_path: str | None = None,
    fmt: str = "auto",
) -> str:
    """Emit ``{gz_path}.tbi`` (or ``.csi``) from per-row metadata +
    uncompressed offsets.

    chroms: per kept row reference name (file order); pos_1based/ref_lens:
    VCF POS and len(REF); row_u_starts/row_u_ends: each row's uncompressed
    byte span in the VCF stream (known arithmetically at emission time).
    fmt: "tbi", "csi", or "auto" (csi iff any end exceeds the .tbi 2^29
    position ceiling — htslib's switch-over rule).
    """
    c_offs, u_offs = bgzf_member_table(gz_path)
    vbeg = virtual_offsets(row_u_starts, c_offs, u_offs)
    vend = virtual_offsets(row_u_ends, c_offs, u_offs)
    pos0 = np.asarray(pos_1based, dtype=np.int64) - 1
    ends = pos0 + np.maximum(np.asarray(ref_lens, dtype=np.int64), 1)
    if fmt == "auto":
        fmt = "csi" if len(ends) and int(ends.max()) > TBI_MAX_POS else "tbi"
    if fmt not in ("tbi", "csi"):
        raise ValueError(f"unknown index format {fmt!r} (tbi/csi/auto)")
    if fmt == "tbi" and len(ends) and int(ends.max()) > TBI_MAX_POS:
        raise ValueError(
            f"position {int(ends.max())} exceeds the .tbi 2^29 limit; "
            "use the .csi format"
        )
    if fmt == "tbi":
        w = TbiWriter()
    else:
        # depth must cover the max coordinate: capacity is
        # 2^(min_shift + 3*depth) (htslib idx_check_range; it suggests
        # deeper n_lvls for out-of-range positions — we just compute it)
        max_end = int(ends.max()) if len(ends) else 0
        depth = CSI_DEPTH
        while (1 << (CSI_MIN_SHIFT + 3 * depth)) <= max_end:
            depth += 1
        w = CsiWriter(depth=depth)
    # feed whole per-ref slices to the vectorized bulk path (chroms arrive
    # grouped by reference — VCF row order)
    names = np.asarray(chroms)
    if len(names):
        run_starts = np.flatnonzero(
            np.concatenate(([True], names[1:] != names[:-1]))
        )
        run_ends = np.append(run_starts[1:], len(names))
        for lo, hi in zip(run_starts.tolist(), run_ends.tolist()):
            name = names[lo]
            name = name.decode() if isinstance(name, bytes) else str(name)
            w.add_many(
                name, pos0[lo:hi], ends[lo:hi], vbeg[lo:hi], vend[lo:hi]
            )
    tbi_path = tbi_path or f"{gz_path}.{fmt}"
    w.write(tbi_path)
    return tbi_path


# -- reader side (for tests and region queries) -----------------------------


def read_tbi(path: str):
    """Parse a .tbi file -> (names, refs) where refs[name] = (bins, lidx)."""
    import gzip

    data = gzip.decompress(open(path, "rb").read())
    if data[:4] != TBX_MAGIC:
        raise ValueError(f"{path}: bad tabix magic")
    (n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm) = struct.unpack(
        "<8i", data[4:36]
    )
    names = data[36 : 36 + l_nm].split(b"\x00")[:-1]
    names = [n.decode() for n in names]
    off = 36 + l_nm
    refs = {}
    for name in names:
        (n_bin,) = struct.unpack("<i", data[off : off + 4])
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack("<Ii", data[off : off + 8])
            off += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack("<QQ", data[off : off + 16])
                off += 16
                chunks.append((cb, ce))
            bins[b] = chunks
        (n_intv,) = struct.unpack("<i", data[off : off + 4])
        off += 4
        lidx = list(
            struct.unpack(f"<{n_intv}Q", data[off : off + 8 * n_intv])
        )
        off += 8 * n_intv
        refs[name] = (bins, lidx)
    return names, refs


def read_csi(path: str):
    """Parse a .csi file -> (names, refs, min_shift, depth) where
    refs[name] = {bin: (loffset, chunks)}."""
    import gzip

    data = gzip.decompress(open(path, "rb").read())
    if data[:4] != CSI_MAGIC:
        raise ValueError(f"{path}: bad CSI magic")
    min_shift, depth, l_aux = struct.unpack("<3i", data[4:16])
    aux = data[16 : 16 + l_aux]
    names = []
    if len(aux) >= 28:
        (l_nm,) = struct.unpack("<i", aux[24:28])
        names = [n.decode() for n in aux[28 : 28 + l_nm].split(b"\x00")[:-1]]
    off = 16 + l_aux
    (n_ref,) = struct.unpack("<i", data[off : off + 4])
    off += 4
    refs = {}
    for r in range(n_ref):
        (n_bin,) = struct.unpack("<i", data[off : off + 4])
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, loff, n_chunk = struct.unpack("<IQi", data[off : off + 16])
            off += 16
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack("<QQ", data[off : off + 16])
                off += 16
                chunks.append((cb, ce))
            bins[b] = (loff, chunks)
        name = names[r] if r < len(names) else str(r)
        refs[name] = bins
    return names, refs, min_shift, depth


def fetch_region(gz_path: str, tbi_path: str, ref: str, beg: int, end: int):
    """Region query via the index: decompress only the chunks whose bins
    overlap [beg, end) (0-based half-open), return matching VCF lines.
    Dispatches on the index magic (.tbi or .csi).

    This is the reader-side validation of the index structure (no tabix
    binary in the environment): results must equal a brute-force scan.
    """
    import gzip
    import zlib

    magic = gzip.decompress(open(tbi_path, "rb").read())[:4]
    chunks = []
    if magic == CSI_MAGIC:
        names, refs, min_shift, depth = read_csi(tbi_path)
        if ref not in refs:
            return []
        # clamp open-ended spans to the binning capacity so reg2bins stays
        # bounded (a whole-contig query passes a huge end)
        end = min(end, 1 << (min_shift + 3 * depth))
        bins = refs[ref]
        # min_off: loffset of the smallest bin containing beg
        min_off = 0
        b_beg = reg2bin_csi(beg, beg + 1, min_shift, depth)
        if b_beg in bins:
            min_off = bins[b_beg][0]
        for b in reg2bins_csi(beg, max(end, beg + 1), min_shift, depth):
            ent = bins.get(b)
            if ent is None:
                continue
            for cb, ce in ent[1]:
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
    else:
        names, refs = read_tbi(tbi_path)
        if ref not in refs:
            return []
        end = min(end, TBI_MAX_POS)
        bins, lidx = refs[ref]
        min_off = 0
        w = beg >> _WINDOW_SHIFT
        if lidx:
            min_off = lidx[min(w, len(lidx) - 1)]
        for b in reg2bins(beg, max(end, beg + 1)):
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
    # merge overlapping/adjacent chunks (the same record range can appear
    # via several bins): content-level dedup would wrongly collapse
    # legitimately byte-identical duplicate VCF rows
    chunks.sort()
    merged = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ce)
        else:
            merged.append([cb, ce])
    chunks = merged
    lines = []
    with open(gz_path, "rb") as f:
        for cb, ce in chunks:
            c_block, u_off = cb >> 16, cb & 0xFFFF
            c_end_block, u_end = ce >> 16, ce & 0xFFFF
            buf = b""
            pos = c_block
            while pos <= c_end_block:
                f.seek(pos)
                head = f.read(18)
                if len(head) < 18:
                    break
                bsize = struct.unpack("<H", head[16:18])[0] + 1
                f.seek(pos)
                member = f.read(bsize)
                raw = zlib.decompress(member[18:-8], -15)
                if pos == c_end_block:
                    raw = raw[:u_end]
                if pos == c_block:
                    raw = raw[u_off:]
                buf += raw
                pos += bsize
            for line in buf.split(b"\n"):
                if not line or line.startswith(b"#"):
                    continue
                cols = line.split(b"\t", 4)
                if cols[0].decode() != ref:
                    continue
                p0 = max(int(cols[1]) - 1, 0)  # htslib clamp (POS=0 rows)
                rend = p0 + max(len(cols[3]), 1)
                if p0 < end and rend > beg:
                    lines.append(line)
    return lines
