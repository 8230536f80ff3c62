"""Standalone `index`: tabix-index an EXISTING .vcf.gz file.

The `tabix -p vcf` / `bcftools index` analog. `filter --index` computes
every row's uncompressed offset arithmetically while writing and never
re-reads the output; this path instead serves files written elsewhere:
BGZF members decompress in bounded groups (the import decoder,
pipeline/vcf_import.py), rows scan with the native SIMD separator scan,
and the same writers emit the .tbi/.csi (formats/tabix.py).

The reference has no index support at all (it positions itself as
"bcftools for .pgen files", pgen-rs/README.md:3-5 — the index is
the practical other half of that compatibility).

Copied from ``pgen_tpu/pipeline/index_vcf.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

from pgen_tpu_torch.formats.metadata import _scan_separators
from pgen_tpu_torch.utils.timer import StageTimer

_HASH = ord("#")
_NL = ord("\n")


class VcfIndexError(ValueError):
    """The input cannot be tabix-indexed."""


def _extract_padded(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Zero-padded (rows, width) u8 matrix of the given byte spans."""
    width = int(lens.max()) if len(lens) else 1
    width = max(width, 1)
    try:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
    except ImportError:
        HAVE_NATIVE = False
    if HAVE_NATIVE:
        return native.extract_column(buf, starts, lens, width)
    out = np.zeros((len(starts), width), dtype=np.uint8)
    for i, (s, ln) in enumerate(zip(starts, lens)):
        out[i, :ln] = buf[s : s + ln]
    return out


def _parse_rows(body: np.ndarray, base: int, path: str, state: dict):
    """Accumulate (chrom, pos, ref_len, u_start, u_end) for each row in
    ``body`` (complete '\\n'-terminated lines; a final unterminated line is
    allowed and treated as ending at the buffer edge)."""
    nl_pos, tab_pos, _crs = _scan_separators(body)
    n = len(body)
    if len(nl_pos) == 0 or nl_pos[-1] != n - 1:
        nl_pos = np.append(nl_pos, n)
    starts = np.concatenate(([0], nl_pos[:-1] + 1))
    ends = nl_pos
    keep = ends > starts  # blank lines carry no record
    starts, ends = starts[keep], ends[keep]
    if len(starts) == 0:
        return
    if (body[starts] == _HASH).any():
        bad = int(starts[np.flatnonzero(body[starts] == _HASH)[0]])
        raise VcfIndexError(
            f"{path}: '#' header line after the first data row "
            f"(uncompressed offset {base + bad})"
        )
    k0 = np.searchsorted(tab_pos, starts)
    if len(tab_pos) < 4:
        bad = np.ones(len(starts), dtype=bool)
    else:
        bad = (k0 + 3 >= len(tab_pos)) | (
            tab_pos[np.minimum(k0 + 3, len(tab_pos) - 1)] >= ends
        )
    if bad.any():
        short = int(np.flatnonzero(bad)[0])
        raise VcfIndexError(
            f"{path}: data row at uncompressed offset "
            f"{base + int(starts[short])} has fewer than 5 fields"
        )
    t0 = tab_pos[k0]
    t1 = tab_pos[k0 + 1]
    t2 = tab_pos[k0 + 2]
    t3 = tab_pos[k0 + 3]
    chrom_mat = _extract_padded(body, starts, t0 - starts)
    chroms = np.ascontiguousarray(chrom_mat).view(f"S{chrom_mat.shape[1]}").ravel()
    pos_mat = _extract_padded(body, t0 + 1, t1 - t0 - 1)
    pos_s = np.ascontiguousarray(pos_mat).view(f"S{pos_mat.shape[1]}").ravel()
    try:
        pos = pos_s.astype(np.int64)
    except (ValueError, OverflowError) as e:
        raise VcfIndexError(f"{path}: non-integer POS value: {e}") from None
    state["chroms"].append(chroms)
    state["pos"].append(pos)
    state["ref_lens"].append(t3 - t2 - 1)
    state["u_starts"].append(base + starts)
    state["u_ends"].append(base + ends + 1)


def index_vcf_gz(
    gz_path: str,
    fmt: str = "auto",
    chunk_bytes: int = 64 << 20,
    timer: StageTimer | None = None,
) -> str:
    """Build {gz_path}.tbi (or .csi) by scanning the file. Returns the
    index path."""
    from pgen_tpu_torch.formats.tabix import build_index_for_vcf_gz
    from pgen_tpu_torch.pipeline.vcf_import_host import _bgzf_member_spans, _gz_windows

    timer = timer or StageTimer()
    comp = np.memmap(gz_path, dtype=np.uint8, mode="r")
    if _bgzf_member_spans(comp) is None:
        raise VcfIndexError(
            f"{gz_path}: not BGZF (blocked gzip) — tabix indexes need the "
            "random-access block structure; re-compress with a BGZF writer "
            "(e.g. pgen-tpu filter -o out.vcf.gz)"
        )
    del comp
    windows, total = _gz_windows(gz_path, chunk_bytes)
    state = {"chroms": [], "pos": [], "ref_lens": [], "u_starts": [], "u_ends": []}
    carry = np.empty(0, dtype=np.uint8)
    consumed = 0  # uncompressed bytes fully processed (base of carry)
    body_started = False
    with timer.stage("scan_rows"):
        for win in windows:
            buf = np.concatenate((carry, win)) if len(carry) else win
            base = consumed
            nls = np.flatnonzero(buf == _NL)
            if len(nls) == 0:
                carry = buf
                continue
            cut = int(nls[-1]) + 1
            complete, carry = buf[:cut], buf[cut:]
            consumed = base + cut
            pos = 0
            if not body_started:
                # step over leading '#' lines via the precomputed newline
                # positions (header lines are few; no rescan per line)
                while pos < cut and complete[pos] == _HASH:
                    pos = int(nls[np.searchsorted(nls, pos)]) + 1
                if pos < cut:
                    body_started = True
            if pos < cut:
                _parse_rows(complete[pos:cut], base + pos, gz_path, state)
        if len(carry):
            if not body_started and carry[0] == _HASH:
                raise VcfIndexError(f"{gz_path}: unterminated header line")
            _parse_rows(carry, consumed, gz_path, state)
    if not state["pos"]:
        raise VcfIndexError(f"{gz_path}: no data rows to index")
    with timer.stage("build_index"):
        cw = max(c.dtype.itemsize for c in state["chroms"])
        chroms = np.concatenate([c.astype(f"S{cw}") for c in state["chroms"]])
        return build_index_for_vcf_gz(
            gz_path,
            chroms,
            np.concatenate(state["pos"]),
            np.concatenate(state["ref_lens"]),
            np.concatenate(state["u_starts"]),
            np.concatenate(state["u_ends"]),
            fmt=fmt,
        )
