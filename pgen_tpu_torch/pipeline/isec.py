"""`pgen-tpu isec`: variant set operations between two filesets.

bcftools-isec analog (extension — the reference never compares filesets,
pgen-rs/src/cli.rs:5-62 has only query/filter). Variants match by
key — CHROM:POS:REF:ALT (``--key full``, default) or CHROM:POS
(``--key pos``) — computed as one vectorized byte-join per side and
intersected with a single sorted membership pass (np.isin), no per-row
string work. Up to four output filesets:

    {out}.a_only   rows of A whose key is absent from B
    {out}.b_only   rows of B whose key is absent from A
    {out}.both_a   rows of A whose key is present in B (A's genotypes)
    {out}.both_b   rows of B whose key is present in A (B's genotypes)

Each output carries its source side's samples/psam verbatim; genotype
records are gathered, never re-coded (fixed-width geometry, SURVEY.md C9).
Duplicate keys within a side participate in membership like any other row.

Multi-file mode (`isec_pgen_multi`, CLI `-n/--nfiles`) follows bcftools'
`-n [=+-]INT | ~BITMAP` semantics over N >= 2 filesets: a variant key's
FILE COUNT (how many inputs contain it, presence not multiplicity) is
tested against the spec — `=k` exactly k, `+k` at least k, `-k` at most
k, `~1010` exactly the flagged files (first character = first input).
Outputs: one fileset per input ({out}.0000, {out}.0001, ...) holding that
input's rows whose key passes, plus {out}.sites.txt listing each passing
key once with its presence string ("110" = in inputs 1-2, not 3), in
byte-lexicographic key order.

Copied from ``pgen_tpu/pipeline/isec.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.pgen_out_host import _write_meta_subset
from pgen_tpu_torch.pipeline.split import _write_subset_pgen
from pgen_tpu_torch.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16
OUTPUTS = ("a_only", "b_only", "both_a", "both_b")


@dataclass
class IsecResult:
    out_prefixes: dict  # output name -> fileset prefix (written ones only)
    counts: dict  # output name -> row count (all four, always)
    timer: StageTimer


def _variant_keys(pvar, key: str) -> np.ndarray:
    """One 'S' byte-string key per row, ':'-joined."""
    cols = ("CHROM", "POS") if key == "pos" else ("CHROM", "POS", "REF", "ALT")
    out = None
    for c in cols:
        v = pvar.get_column_bytes(c)
        out = v if out is None else np.char.add(np.char.add(out, b":"), v)
    return out


def _load_side(prefix: str):
    header = read_pgen_header(f"{prefix}.pgen")
    pvar = read_metadata(f"{prefix}.pvar")
    read_metadata(f"{prefix}.psam").column_index("IID")
    if pvar.num_rows != header.num_variants:
        raise ValueError(
            f"{prefix}.pvar has {pvar.num_rows} rows but the pgen holds "
            f"{header.num_variants} variant records"
        )
    mm = np.memmap(f"{prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * header.record_size].reshape(
        header.num_variants, header.record_size
    )
    return header, pvar, records


def isec_pgen(
    prefix_a: str,
    prefix_b: str,
    out_prefix: str,
    key: str = "full",
    write=None,
    block_variants: int = DEFAULT_BLOCK,
) -> IsecResult:
    if key not in ("full", "pos"):
        raise ValueError(f"--key must be 'full' or 'pos', got {key!r}")
    selected = list(OUTPUTS) if write is None else [
        w.strip() for w in str(write).split(",") if w.strip()
    ]
    bad = [w for w in selected if w not in OUTPUTS]
    if bad or not selected:
        raise ValueError(
            f"--write: unknown output(s) {','.join(bad) or '(none)'}; "
            f"choose from {','.join(OUTPUTS)}"
        )
    timer = StageTimer()
    with timer.stage("metadata_load"):
        header_a, pvar_a, records_a = _load_side(prefix_a)
        header_b, pvar_b, records_b = _load_side(prefix_b)
    with timer.stage("keys"):
        keys_a = _variant_keys(pvar_a, key)
        keys_b = _variant_keys(pvar_b, key)
        in_b = np.isin(keys_a, keys_b)
        in_a = np.isin(keys_b, keys_a)
    plans = {
        "a_only": (prefix_a, header_a, pvar_a, records_a, np.flatnonzero(~in_b)),
        "b_only": (prefix_b, header_b, pvar_b, records_b, np.flatnonzero(~in_a)),
        "both_a": (prefix_a, header_a, pvar_a, records_a, np.flatnonzero(in_b)),
        "both_b": (prefix_b, header_b, pvar_b, records_b, np.flatnonzero(in_a)),
    }
    counts = {name: len(p[4]) for name, p in plans.items()}
    outs = {}
    import shutil

    for name in selected:
        src_prefix, header, pvar, records, idx = plans[name]
        dest = f"{out_prefix}.{name}"
        with timer.stage("write_pgen"):
            _write_subset_pgen(
                f"{dest}.pgen", records, idx, header.num_samples,
                contiguous=False, block=block_variants,
            )
        with timer.stage("write_meta"):
            _write_meta_subset(pvar, idx, f"{dest}.pvar")
            shutil.copyfile(f"{src_prefix}.psam", f"{dest}.psam")
        outs[name] = dest
    return IsecResult(out_prefixes=outs, counts=counts, timer=timer)


def _parse_nfiles(spec: str, n_inputs: int):
    """bcftools -n spec -> predicate over (counts, presence) arrays.

    counts: (U,) int file-counts per union key; presence: (U, N) bool."""
    s = spec.strip()
    if s.startswith("~"):
        bits = s[1:]
        if len(bits) != n_inputs or set(bits) - {"0", "1"}:
            raise ValueError(
                f"-n ~BITMAP needs one 0/1 per input ({n_inputs}), got {spec!r}"
            )
        want = np.array([b == "1" for b in bits])
        return lambda counts, presence: (presence == want).all(axis=1)
    mode = "="
    if s and s[0] in "=+-":
        mode, s = s[0], s[1:]
    try:
        k = int(s)
    except ValueError:
        raise ValueError(
            f"-n expects [=+-]INT or ~BITMAP (bcftools isec), got {spec!r}"
        ) from None
    if not 0 <= k <= n_inputs:
        raise ValueError(f"-n {spec!r}: count must be in [0, {n_inputs}]")
    if mode == "+":
        return lambda counts, presence: counts >= k
    if mode == "-":
        return lambda counts, presence: counts <= k
    return lambda counts, presence: counts == k


def isec_pgen_multi(
    prefixes,
    out_prefix: str,
    key: str = "full",
    nfiles: str = "+1",
    block_variants: int = DEFAULT_BLOCK,
) -> IsecResult:
    """bcftools `isec -n` over N filesets (see module docstring)."""
    if key not in ("full", "pos"):
        raise ValueError(f"--key must be 'full' or 'pos', got {key!r}")
    prefixes = list(prefixes)
    if len(prefixes) < 2:
        raise ValueError("isec -n needs at least two filesets")
    pred = _parse_nfiles(nfiles, len(prefixes))
    timer = StageTimer()
    with timer.stage("metadata_load"):
        sides = [_load_side(p) for p in prefixes]
    with timer.stage("keys"):
        keys = [_variant_keys(pvar, key) for _, pvar, _ in sides]
        union = np.unique(np.concatenate([np.unique(ks) for ks in keys]))
        presence = np.zeros((len(union), len(prefixes)), dtype=bool)
        for i, ks in enumerate(keys):
            presence[:, i] = np.isin(union, ks)
        sel_union = pred(presence.sum(axis=1), presence)
    import shutil

    outs = {}
    counts = {}
    for i, (header, pvar, records) in enumerate(sides):
        # every row key is in the union by construction: searchsorted is exact
        rowsel = sel_union[np.searchsorted(union, keys[i])]
        idx = np.flatnonzero(rowsel)
        name = f"{i:04d}"
        counts[name] = len(idx)
        dest = f"{out_prefix}.{name}"
        with timer.stage("write_pgen"):
            _write_subset_pgen(
                f"{dest}.pgen", records, idx, header.num_samples,
                contiguous=False, block=block_variants,
            )
        with timer.stage("write_meta"):
            _write_meta_subset(pvar, idx, f"{dest}.pvar")
            shutil.copyfile(f"{prefixes[i]}.psam", f"{dest}.psam")
        outs[name] = dest
    with timer.stage("write_sites"):
        sites_path = f"{out_prefix}.sites.txt"
        sel_idx = np.flatnonzero(sel_union)
        with open(sites_path, "wb") as fh:
            for u in sel_idx:
                fields = union[u].split(b":")
                mask = b"".join(
                    b"1" if presence[u, i] else b"0"
                    for i in range(len(prefixes))
                )
                fh.write(b"\t".join(fields) + b"\t" + mask + b"\n")
        outs["sites"] = sites_path
        counts["sites"] = len(sel_idx)
    return IsecResult(out_prefixes=outs, counts=counts, timer=timer)
