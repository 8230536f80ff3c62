"""The host half of ``pgen_tpu/pipeline/annotate.py``, copied: the column
rewrites (``replace_column_bytes``, ``gather_spans``), ``--set-id``,
``--rename-chrs``/``--rename-samples``, ``--annotations`` (``-a``,
``--columns``), ``-x``, and ``--fill-info``'s tags and text
(``_parse_fill_tags``, ``_fill_info_values`` with the HWE test as it is,
``_strip_tags_py``). Only the imports differ. Left out: ``fill_info_column``
(its counts are pgen_tpu's host or jax providers) and ``annotate_pgen``; the
port's are ``pipeline/annotate.py``, which counts on the device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class AnnotateResult:
    out_prefix: str
    num_variants: int
    num_samples: int
    timer: StageTimer


def gather_spans(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate buf[starts[i] : starts[i]+lens[i]] for all i — one
    fancy-index gather, no Python-level loop."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    out_ends = np.cumsum(lens)
    out_starts = out_ends - lens
    idx = np.arange(total, dtype=np.int64)
    idx += np.repeat(starts.astype(np.int64) - out_starts, lens)
    return buf[idx]


def replace_column_bytes(table, col_name: str, new_vals: np.ndarray) -> np.ndarray:
    """Rows of ``table`` with column ``col_name`` replaced by ``new_vals``
    (numpy 'S' array, one value per row), newline-terminated, as uint8."""
    j = table.column_index(col_name)
    line_starts, line_ends = table.row_line_spans()
    fs = table.field_starts(j)
    fe = table.field_ends(j)
    buf = table.data_buffer

    new_vals = np.asarray(new_vals)
    width = new_vals.dtype.itemsize
    new_mat = np.ascontiguousarray(new_vals).view(np.uint8).reshape(-1, width)
    new_lens = np.char.str_len(new_vals).astype(np.int64)
    if (new_lens == 0).any():
        bad = int(np.flatnonzero(new_lens == 0)[0])
        raise ValueError(f"annotate: empty {col_name} value for row {bad}")
    # a tab or newline inside a value would corrupt the table geometry
    offs = np.arange(width, dtype=np.int64)
    in_value = offs[None, :] < new_lens[:, None]
    if (((new_mat == 9) | (new_mat == 10)) & in_value).any():
        raise ValueError(
            f"annotate: {col_name} values must not contain tabs or newlines"
        )
    # one source buffer for all three pieces: data buffer, then the new
    # values (padded matrix — spans address only the real bytes), then \n
    src = np.concatenate(
        [buf, new_mat.reshape(-1), np.frombuffer(b"\n", dtype=np.uint8)]
    )
    new_starts = len(buf) + np.arange(len(new_vals), dtype=np.int64) * width
    nl = np.int64(len(src) - 1)
    n = table.num_rows
    starts = np.empty((n, 4), dtype=np.int64)
    lens = np.empty((n, 4), dtype=np.int64)
    starts[:, 0] = line_starts
    lens[:, 0] = fs - line_starts
    starts[:, 1] = new_starts
    lens[:, 1] = new_lens
    starts[:, 2] = fe
    lens[:, 2] = line_ends - fe
    starts[:, 3] = nl
    lens[:, 3] = 1
    return gather_spans(src, starts.reshape(-1), lens.reshape(-1))


def _read_pairs(path: str, what: str) -> dict:
    """Parse "old<whitespace>new" mapping lines; '#' comments skipped."""
    mapping: dict = {}
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(
                    f"{what} file {path}:{ln}: expected 'old new', got {line!r}"
                )
            mapping[parts[0].encode()] = parts[1].encode()
    return mapping


def _read_names_or_pairs(path: str, what: str):
    """reheader -s semantics: all-pairs -> mapping dict; otherwise a
    plain list of new names (one per line, positional)."""
    lines = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                lines.append(line.split())
    if lines and all(len(p) == 2 for p in lines):
        return {old.encode(): new.encode() for old, new in lines}
    if any(len(p) != 1 for p in lines):
        raise ValueError(
            f"{what} file {path}: use 'old new' pairs OR one name per line"
        )
    return [p[0].encode() for p in lines]


def _remap(col: np.ndarray, mapping: dict) -> np.ndarray:
    """Apply mapping to an 'S' column (unlisted values pass through)."""
    values, inverse = np.unique(col, return_inverse=True)
    out_vals = [mapping.get(v, v) for v in values.tolist()]
    width = max((len(v) for v in out_vals), default=1)
    return np.array(out_vals, dtype=f"S{max(width, 1)}")[inverse]


def _remap_contig_comments(comments: str, mapping: dict) -> str:
    def sub(m: re.Match) -> str:
        old = m.group(2).encode()
        new = mapping.get(old, old).decode()
        return f"{m.group(1)}{new}"

    return re.sub(r"(##contig=<[^>]*?\bID=)([^,>]+)", sub, comments)


def _fstring_column(expr: str, table, extra=None) -> np.ndarray:
    """Evaluate an fstring expression for every row -> 'S' array."""
    from pgen_tpu_torch.query.compile import compile_fstring

    vals = compile_fstring(expr, table, extra=extra)
    width = max((len(v.encode("utf-8")) for v in vals), default=1)
    return np.array([v.encode("utf-8") for v in vals], dtype=f"S{max(width, 1)}")


FILL_INFO_TAGS = ("AC", "AN", "AF", "MAF", "NS", "F_MISSING", "HWE")

_INFO_DECLS = {
    "AC": '##INFO=<ID=AC,Number=A,Type=Integer,Description='
    '"Allele count in genotypes">\n',
    "AN": '##INFO=<ID=AN,Number=1,Type=Integer,Description='
    '"Total number of alleles in called genotypes">\n',
    "AF": '##INFO=<ID=AF,Number=A,Type=Float,Description='
    '"Allele frequency">\n',
    "MAF": '##INFO=<ID=MAF,Number=1,Type=Float,Description='
    '"Minor allele frequency">\n',
    "NS": '##INFO=<ID=NS,Number=1,Type=Integer,Description='
    '"Number of samples with data">\n',
    "F_MISSING": '##INFO=<ID=F_MISSING,Number=1,Type=Float,Description='
    '"Fraction of missing genotypes">\n',
    "HWE": '##INFO=<ID=HWE,Number=1,Type=Float,Description='
    '"HWE exact test p-value">\n',
}


def _parse_fill_tags(spec: str) -> list:
    if spec.strip().lower() == "all":
        return list(FILL_INFO_TAGS)
    tags = [t.strip().upper() for t in spec.split(",") if t.strip()]
    bad = [t for t in tags if t not in FILL_INFO_TAGS]
    if bad:
        raise ValueError(
            f"--fill-info: unsupported tag(s) {','.join(bad)}; "
            f"supported: {','.join(FILL_INFO_TAGS)} or 'all'"
        )
    if not tags:
        raise ValueError("--fill-info: no tags given")
    return tags


def _fill_info_values(tags, counts, n_cohort) -> np.ndarray:
    """Per-variant 'TAG=val;TAG=val' byte strings from a (V,4) count
    matrix — vectorized formatting (np.char.mod), no per-row Python."""
    homref, het, homalt, missing = (
        counts[:, k].astype(np.int64) for k in range(4)
    )
    ac = het + 2 * homalt
    nobs = homref + het + homalt
    an = 2 * nobs
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(an > 0, ac / np.maximum(an, 1), 0.0)
    vals = {}
    for t in tags:
        if t == "AC":
            vals[t] = np.char.mod(b"%d", ac)
        elif t == "AN":
            vals[t] = np.char.mod(b"%d", an)
        elif t == "NS":
            vals[t] = np.char.mod(b"%d", nobs)
        elif t == "AF":
            vals[t] = np.char.mod(b"%.6g", af)
        elif t == "MAF":
            vals[t] = np.char.mod(b"%.6g", np.minimum(af, 1.0 - af))
        elif t == "F_MISSING":
            denom = max(n_cohort, 1)
            vals[t] = np.char.mod(b"%.6g", missing / denom)
        elif t == "HWE":
            from pgen_tpu_torch.ops.hwe import hwe_exact_p

            vals[t] = np.char.mod(b"%.6g", hwe_exact_p(counts))
    parts = None
    for t in tags:
        piece = np.char.add(f"{t}=".encode(), vals[t])
        parts = piece if parts is None else np.char.add(
            np.char.add(parts, b";"), piece
        )
    return parts


def _strip_tags_py(info: bytes, tags) -> bytes:
    """Remove existing 'TAG=...' fields (boundary-exact) from one INFO."""
    fields = [
        f for f in info.split(b";")
        if f.split(b"=", 1)[0].decode("latin-1") not in tags
    ]
    return b";".join(fields)


def _match_annotation_rows(pvar, src_pvar):
    """Row matching on CHROM:POS:REF:ALT (bcftools annotate -a keying).

    Returns (matched (V,) bool, src_row (V,) i64 — the FIRST source row
    holding each target key, valid only where matched)."""
    from pgen_tpu_torch.pipeline.isec import _variant_keys

    tkeys = _variant_keys(pvar, "full")
    skeys = _variant_keys(src_pvar, "full")
    if len(skeys) == 0 or len(tkeys) == 0:
        return np.zeros(len(tkeys), dtype=bool), np.zeros(len(tkeys), np.int64)
    order = np.argsort(skeys, kind="stable")
    skeys_sorted = skeys[order]
    uniq_mask = np.ones(len(skeys_sorted), dtype=bool)
    uniq_mask[1:] = skeys_sorted[1:] != skeys_sorted[:-1]
    s_uniq = skeys_sorted[uniq_mask]
    s_first = order[uniq_mask]  # stable argsort -> first occurrence
    pos = np.searchsorted(s_uniq, tkeys)
    pos_c = np.minimum(pos, len(s_uniq) - 1)
    matched = s_uniq[pos_c] == tkeys
    return matched, s_first[pos_c]


def _extract_info_field(info: bytes, tag: str):
    """The full 'TAG=val' (or flag 'TAG') field from one INFO, or None."""
    for f in info.split(b";"):
        if f.partition(b"=")[0].decode("latin-1") == tag:
            return f
    return None


def _transfer_one(pvar, src_pvar, spec: str, comments: str):
    """One --columns entry -> (column_name, new values, comments).

    ID / INFO replace the whole column on matched rows; INFO/TAG splices
    the source's TAG field into the target INFO (replacing any existing
    instance), leaving other fields intact. Unmatched rows, and matched
    rows whose source lacks the tag, keep their current value. Matching
    ##INFO declarations are copied from the source header when absent."""
    matched, src_row = _match_annotation_rows(pvar, src_pvar)
    if spec == "ID":
        old = pvar.get_column_bytes("ID")
        src = src_pvar.get_column_bytes("ID")
        width = max(old.dtype.itemsize, src.dtype.itemsize)
        new = old.astype(f"S{width}")
        new[matched] = src[src_row[matched]]
        return "ID", new, comments
    if spec == "INFO":
        old = pvar.get_column_bytes("INFO")
        src = src_pvar.get_column_bytes("INFO")
        width = max(old.dtype.itemsize, src.dtype.itemsize)
        new = old.astype(f"S{width}")
        new[matched] = src[src_row[matched]]
        for line in src_pvar.comments.splitlines(keepends=True):
            if line.startswith("##INFO=<ID=") and line not in comments:
                comments += line
        return "INFO", new, comments
    if spec.startswith("INFO/"):
        tag = spec[5:]
        if not tag:
            raise ValueError("--columns: empty INFO/ tag")
        old = pvar.get_column_bytes("INFO").astype(object)
        src = src_pvar.get_column_bytes("INFO")
        tagset = {tag}
        changed = np.zeros(len(old), dtype=bool)
        for i in np.flatnonzero(matched):
            field = _extract_info_field(src[src_row[i]], tag)
            if field is None:
                continue
            base = _strip_tags_py(old[i], tagset)
            if base in (b"", b"."):
                old[i] = field
            else:
                old[i] = base + b";" + field
            changed[i] = True
        width = max(max((len(v) for v in old), default=1), 1)
        new = np.array(list(old), dtype=f"S{width}")
        decl_prefix = f"##INFO=<ID={tag},"
        if decl_prefix not in comments:
            for line in src_pvar.comments.splitlines(keepends=True):
                if line.startswith(decl_prefix):
                    comments += line
                    break
        return "INFO", new, comments
    raise ValueError(
        f"--columns: unknown entry {spec!r} (supported: ID, INFO, INFO/TAG)"
    )


def _drop_info_headers(comments: str, tags=None) -> str:
    """Remove ##INFO declarations (all when tags is None, else the named
    set) from the pvar comment block."""
    out = []
    for line in comments.splitlines(keepends=True):
        if line.startswith("##INFO=<ID="):
            tid = line[len("##INFO=<ID="):].split(",", 1)[0].split(">", 1)[0]
            if tags is None or tid in tags:
                continue
        out.append(line)
    return "".join(out)


def _remove_one(pvar, spec: str, comments: str):
    """One -x entry -> (column_name, new values, comments).

    ID / QUAL / FILTER / INFO blank the whole column to '.'; INFO/TAG
    strips that tag per row (boundary-exact, rows left empty become
    '.'). Matching ##INFO declarations drop from the header."""
    n = pvar.num_rows
    if spec in ("ID", "QUAL", "FILTER"):
        return spec, np.full(n, b".", dtype="S1"), comments
    if spec == "INFO":
        return "INFO", np.full(n, b".", dtype="S1"), _drop_info_headers(comments)
    if spec.startswith("INFO/"):
        tag = spec[5:]
        if not tag:
            raise ValueError("-x: empty INFO/ tag")
        infos = pvar.get_column_bytes("INFO")
        new = np.array(
            [_strip_tags_py(x, {tag}) or b"." for x in infos.tolist()]
        )
        return "INFO", new, _drop_info_headers(comments, {tag})
    raise ValueError(
        f"-x: unknown entry {spec!r} (supported: ID, QUAL, FILTER, INFO, "
        "INFO/TAG)"
    )


def _table_from_rows(src_table, comments: str, rows: np.ndarray):
    """Reparse spliced row bytes into a fresh MetadataTable (used when a
    later annotate step must see an earlier step's output)."""
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=".pvar")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(comments.encode("utf-8"))
            f.write(src_table.header_line.encode("utf-8"))
            f.write(b"\n")
            rows.tofile(f)
        return read_metadata(tmp)
    finally:
        os.unlink(tmp)
