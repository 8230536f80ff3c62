"""Duplicate-variant extension variables for the predicate language.

plink2's `--rm-dup` removes variants that share an ID; the TPU build
exposes the underlying group facts as whole-column BOOLEAN variables so
every pipeline (single-process, worker shards, device mesh) inherits
them through the ordinary query string — no new parameters thread
through the 17 `compute_masks` call sites:

    DUP_FIRST     true on the FIRST occurrence of each ID (file order)
    DUP_UNIQUE    true iff the ID occurs exactly once
    DUPKEY_FIRST  same, keyed on CHROM:POS:REF:ALT (isec/diff's full key)
    DUPKEY_UNIQUE

`filter --rm-dup MODE` is CLI sugar over these (cli.py):
    force-first  -> AND DUP_FIRST      (keep one instance per ID)
    exclude-all  -> AND DUP_UNIQUE     (drop every duplicated ID)
    list         -> write {out}.rmdup.list, no filtering
    error        -> fail when any duplicate ID exists

The reference has no analog (its engine is row-at-a-time evalexpr,
pfile.rs:319-329, which cannot see across rows); plink2 --rm-dup is the
behavioral model for the ID key.

Copied from ``pgen_tpu/query/dup.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

DUP_VARIABLE_NAMES = (
    "DUP_FIRST",
    "DUP_UNIQUE",
    "DUPKEY_FIRST",
    "DUPKEY_UNIQUE",
)


def _first_and_unique(keys: np.ndarray):
    """(first_occurrence mask, count==1 mask) for a key column, file order."""
    uniq, first_idx, inv, counts = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True
    )
    first = np.zeros(len(keys), dtype=bool)
    first[first_idx] = True  # np.unique's index IS the first occurrence
    return first, counts[inv] == 1


def first_unique_within(keys: np.ndarray, cond: np.ndarray):
    """(first, unique) masks over the FULL row range, computed among the
    rows where ``cond`` holds; rows outside cond are False in both.
    Backs the dup_first_within/dup_unique_within query builtins (the
    post-filter --rm-dup semantics: dedup applies to the already-filtered
    variant set, like plink2's filter order)."""
    idx = np.flatnonzero(cond)
    first = np.zeros(len(keys), dtype=bool)
    unique = np.zeros(len(keys), dtype=bool)
    if len(idx):
        f, u = _first_and_unique(keys[idx])
        first[idx[f]] = True
        unique[idx[u]] = True
    return first, unique


def full_keys(pvar) -> np.ndarray:
    """CHROM:POS:REF:ALT byte keys (the isec/diff matching key)."""
    cols = [pvar.get_column_bytes(c) for c in ("CHROM", "POS", "REF", "ALT")]
    sep = np.bytes_(b":")
    key = cols[0]
    for c in cols[1:]:
        key = np.char.add(np.char.add(key, sep), c)
    return key


def dup_variables(pvar, used: set) -> dict | None:
    """Compute the requested DUP_* boolean columns from the pvar table."""
    used = set(used) & set(DUP_VARIABLE_NAMES)
    if not used:
        return None
    out = {}
    if {"DUP_FIRST", "DUP_UNIQUE"} & used:
        first, unique = _first_and_unique(pvar.get_column_bytes("ID"))
        out["DUP_FIRST"] = first
        out["DUP_UNIQUE"] = unique
    if {"DUPKEY_FIRST", "DUPKEY_UNIQUE"} & used:
        first, unique = _first_and_unique(full_keys(pvar))
        out["DUPKEY_FIRST"] = first
        out["DUPKEY_UNIQUE"] = unique
    return {k: v for k, v in out.items() if k in used}
