"""The host half of ``pgen_tpu/pipeline/score.py``, copied: the score file,
``--score-col-nums`` and ``--q-score-range`` readers and the run result.
Only the imports differ. Left out: ``score_pfile``, whose runs import
pgen_tpu's jax-importing ``ops/score.py``; the port's is
``pipeline/score.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class ScoreTable:
    """Parsed scoring file: aligned ID/allele/weight rows."""

    ids: list
    alleles: list
    weights: np.ndarray  # (M, K) f64
    names: list  # K score names


@dataclass
class ScoreRunResult:
    num_scored: int  # variants entering the matmul
    num_unmatched: int  # score lines with no pvar ID match
    num_mismatched: int  # matched but effect allele is neither REF nor ALT
    num_samples: int
    names: list
    sums: np.ndarray  # (S, K)
    avgs: np.ndarray  # (S, K)
    allele_ct: np.ndarray  # (S,)
    dosage_sum: np.ndarray  # (S,)
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def parse_col_nums(spec: str) -> tuple:
    """plink2-style 1-based column list: '3-5,7' -> (3, 4, 5, 7)."""
    out = []
    for raw in str(spec).split(","):
        tok = raw.strip()
        if not tok:
            continue
        lo, dash, hi = tok.partition("-")
        try:
            if dash:
                a, b = int(lo), int(hi)
                if b < a:
                    raise ValueError
                out.extend(range(a, b + 1))
            else:
                out.append(int(tok))
        except ValueError:
            raise ValueError(
                f"score: bad column list {spec!r} (want e.g. '3-5,7')"
            ) from None
    if not out:
        raise ValueError(f"score: empty column list {spec!r}")
    return tuple(out)


def _parse_float(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def read_score_file(
    path: str,
    var_id_col: int = 1,
    allele_col: int = 2,
    weight_cols=(3,),
    header_row: str = "auto",
) -> ScoreTable:
    """Parse the scoring table; 1-based column indices, plink2-style.
    `header_row` is "auto" (heuristic below), "yes", or "no"."""
    if header_row not in ("auto", "yes", "no"):
        raise ValueError(f"score: header_row must be auto/yes/no, "
                         f"got {header_row!r}")
    cols = [var_id_col, allele_col, *weight_cols]
    if min(cols) < 1:
        raise ValueError("score: column numbers are 1-based")
    if len(set(cols)) != len(cols):
        raise ValueError("score: ID/allele/weight columns must be distinct")
    ids, alleles, rows = [], [], []
    names = [f"SCORE{i + 1}" for i in range(len(weight_cols))]
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"score: {path} is empty")
    need = max(cols)
    first = lines[0].split()
    if len(first) < need:
        raise ValueError(
            f"score: {path} line 1 has {len(first)} fields, need {need}"
        )
    start = 0
    # Header heuristic: line 1 is a header only if EVERY weight cell
    # fails to parse as a number, none of them is a missing-value token
    # (a headerless file whose first weight is 'NA' is data with a bad
    # cell, reported below — not a header to drop silently), and the ID
    # cell is non-numeric too (guards numeric column names like '2019'
    # from swallowing a data row).
    missing_tokens = {"NA", "na", "N/A", ".", ""}
    w_first = [first[c - 1] for c in weight_cols]
    is_header = (
        all(_parse_float(w) is None for w in w_first)
        and not any(w in missing_tokens for w in w_first)
        and _parse_float(first[var_id_col - 1]) is None
    ) if header_row == "auto" else (header_row == "yes")
    if is_header:
        names = [first[c - 1] for c in weight_cols]
        start = 1
    for lineno, ln in enumerate(lines[start:], start + 1):
        f = ln.split()
        if len(f) < need:
            raise ValueError(
                f"score: {path} line {lineno} has {len(f)} fields, need {need}"
            )
        w = []
        for c in weight_cols:
            v = _parse_float(f[c - 1])
            if v is None:
                hint = (
                    " (line 1 is treated as data because its ID/weight "
                    "cells look numeric or missing-valued; pass "
                    "--header-row to force a header)"
                    if lineno == 1 else ""
                )
                raise ValueError(
                    f"score: {path} line {lineno} col {c}: "
                    f"{f[c - 1]!r} is not a number{hint}"
                )
            w.append(v)
        ids.append(f[var_id_col - 1])
        alleles.append(f[allele_col - 1])
        rows.append(w)
    if not ids:
        raise ValueError(f"score: {path} has no data rows")
    weights = np.asarray(rows, dtype=np.float64)
    dup = len(ids) - len(set(ids))
    if dup:
        raise ValueError(f"score: {path} has {dup} duplicate variant ID(s)")
    return ScoreTable(ids, alleles, weights, names)


def read_q_ranges(path: str) -> list:
    """plink --q-score-range range file: NAME MIN MAX per line
    (whitespace-separated; blank/# lines skipped)."""
    ranges = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) != 3:
                raise ValueError(
                    f"--q-score-range: bad range line {ln!r} "
                    "(need NAME MIN MAX)"
                )
            try:
                ranges.append((parts[0], float(parts[1]), float(parts[2])))
            except ValueError:
                raise ValueError(
                    f"--q-score-range: non-numeric bound in {ln!r}"
                ) from None
    if not ranges:
        raise ValueError(f"--q-score-range: {path} has no ranges")
    return ranges


def read_q_data(path: str, data_col: int = 2) -> dict:
    """plink --q-score-range data file: variant ID (col 1) -> value
    (1-based data_col, default 2). A first line whose value cell does
    not parse is treated as a header. First occurrence wins."""
    vals: dict = {}
    with open(path) as fh:
        for ln_no, ln in enumerate(fh):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) < data_col:
                continue
            try:
                v = float(parts[data_col - 1])
            except ValueError:
                if ln_no == 0:
                    continue  # header line
                continue  # NA-style value: variant lands in no range
            vals.setdefault(parts[0], v)
    if not vals:
        raise ValueError(f"--q-score-range: {path} has no data rows")
    return vals
