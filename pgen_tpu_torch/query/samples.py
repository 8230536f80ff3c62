"""bcftools-style sample lists desugared into include-sam expressions.

`--samples NA1,NA2` / `--samples-file FILE` restrict the sample axis the
same way `--regions` restricts the variant axis (query/regions.py): the
list compiles to ONE expression node —

    str::regex_matches(IID, "^(?:NA1|NA2)$")

— so a thousand-sample list stays a single vectorized pass over the
(small) psam instead of a thousand-deep `||` chain, and every pipeline
inherits it by AND-ing with any `--include-sam`. A leading `^` excludes
the listed samples (bcftools semantics). Output sample order remains the
fileset's .psam order (the engine's filtering is order-stable); bcftools
reorders to list order — documented difference.

The reference has no sample-list support (its sample axis is
include-expressions only, pgen-rs/src/cli.rs:43-61).

Copied from ``pgen_tpu/query/samples.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import re


class SampleListError(ValueError):
    """A --samples spec or file could not be parsed."""


def _to_expr(names: list, negate: bool) -> str:
    if not names:
        raise SampleListError("empty sample list")
    for n in names:
        if '"' in n or "\\" in n:
            raise SampleListError(f"unsupported character in sample name {n!r}")
    alts = "|".join(re.escape(n) for n in names)
    # the expression parser unescapes string literals, so regex backslashes
    # must be doubled to survive into the pattern
    alts = alts.replace("\\", "\\\\")
    expr = f'str::regex_matches(IID, "^(?:{alts})$")'
    return f"!({expr})" if negate else expr


def samples_to_expr(spec: str) -> str:
    """Comma-separated sample IDs (leading ^ excludes) -> include-sam expr."""
    negate = spec.startswith("^")
    if negate:
        spec = spec[1:]
    names = [t.strip() for t in spec.split(",") if t.strip()]
    return _to_expr(names, negate)


def samples_file_to_expr(path: str) -> str:
    """One sample ID per line (blank/# lines skipped; a leading ^ on the
    first NAME — comments and blanks don't count — excludes the list)."""
    with open(path) as fh:
        names = [
            line.strip()
            for line in fh
            if line.strip() and not line.strip().startswith("#")
        ]
    negate = bool(names) and names[0].startswith("^")
    if negate:
        names[0] = names[0][1:]
        names = [n for n in names if n]
    if not names:
        raise SampleListError(f"{path}: no sample names found")
    return _to_expr(names, negate)


def keep_remove_file_to_names(path: str) -> list:
    """plink2 --keep/--remove file: one sample per line, either a bare
    IID or plink's FID IID pair (whitespace-separated; the IID is the
    SECOND field when two or more are present). Blank/# lines skipped."""
    names = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            names.append(fields[1] if len(fields) >= 2 else fields[0])
    if not names:
        raise SampleListError(f"{path}: no sample names found")
    return names


def apply_keep_remove(
    sam_query: str | None, keep: str | None, remove: str | None
) -> str | None:
    """Fold plink2 --keep/--remove ID files into an include-sam expr.

    Both may be given: keep ∧ ¬remove, AND-ed with any existing query."""
    for path, negate in ((keep, False), (remove, True)):
        if not path:
            continue
        expr = _to_expr(keep_remove_file_to_names(path), negate)
        sam_query = expr if sam_query is None else f"({expr}) && ({sam_query})"
    return sam_query


def apply_samples(
    sam_query: str | None, samples: str | None, samples_file: str | None
) -> str | None:
    """Fold --samples/--samples-file into an (optional) --include-sam."""
    if samples and samples_file:
        raise SampleListError("pass --samples or --samples-file, not both")
    if samples:
        expr = samples_to_expr(samples)
    elif samples_file:
        expr = samples_file_to_expr(samples_file)
    else:
        return sam_query
    if sam_query is None:
        return expr
    return f"({expr}) && ({sam_query})"
