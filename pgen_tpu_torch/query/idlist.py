"""plink2-style variant-ID lists desugared into include-var expressions.

`--extract FILE` keeps only the variants whose IDs appear in FILE (one ID
per line, blank/# lines skipped); `--exclude FILE` drops them — the
plink2 flag pair. Like the sample/region lists (query/samples.py,
query/regions.py), the list compiles to ONE expression node —

    in_list(ID, "rs1,rs2,...")

— a single vectorized np.isin membership sweep over the ID column
(query/compile.py), so hundred-thousand-ID lists stay O(one pass), and
every pipeline (workers, shards, device mesh) inherits the restriction
by AND-composition with any --include-var.

IDs containing a comma cannot ride the in_list literal; such lists fall
back to the regex form the sample lists use (same vectorized pass).

Copied from ``pgen_tpu/query/idlist.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import re


class IdListError(ValueError):
    """A variant-ID list file could not be parsed."""


def _ids_from_file(path: str) -> list:
    with open(path) as fh:
        ids = [
            line.strip()
            for line in fh
            if line.strip() and not line.strip().startswith("#")
        ]
    if not ids:
        raise IdListError(f"{path}: no variant IDs found")
    for i in ids:
        if '"' in i or "\\" in i:
            raise IdListError(f"unsupported character in variant ID {i!r}")
    return ids


def ids_to_expr(ids: list, negate: bool) -> str:
    if any("," in i for i in ids):
        alts = "|".join(re.escape(i) for i in ids).replace("\\", "\\\\")
        expr = f'str::regex_matches(ID, "^(?:{alts})$")'
    else:
        expr = f'in_list(ID, "{",".join(ids)}")'
    return f"!({expr})" if negate else expr


def apply_id_lists(
    var_query: str | None, extract: str | None, exclude: str | None
) -> str | None:
    """Fold --extract / --exclude ID-list files into an --include-var."""
    for path, negate in ((extract, False), (exclude, True)):
        if not path:
            continue
        expr = ids_to_expr(_ids_from_file(path), negate)
        var_query = expr if var_query is None else f"({expr}) && ({var_query})"
    return var_query
