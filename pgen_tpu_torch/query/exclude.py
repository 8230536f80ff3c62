"""bcftools-style exclude expressions desugared into include-expressions.

`-e/--exclude EXPR` (query) and `--exclude-var/--exclude-sam EXPR`
(filter/stats) keep the rows where EXPR is *false* — the complement of
include, exactly bcftools' `-e` vs `-i`. A spec desugars to `!(EXPR)`
AND-ed with any include expression, so every pipeline (single-process,
--workers, --shards, the device mesh) inherits it unchanged and the
engine's expression semantics apply verbatim: EXPR must evaluate to a
Boolean per row, exactly like include, and GT_* genotype-stat variables
work wherever the matching include flag accepts them.

The reference has include-expressions only
(pgen-rs/src/cli.rs:43-61).

Copied from ``pgen_tpu/query/exclude.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations


def apply_exclude(include: str | None, exclude: str | None) -> str | None:
    """Fold an exclude-expression into an (optional) include-expression."""
    if not exclude:
        return include
    neg = f"!({exclude})"
    if include is None:
        return neg
    return f"{neg} && ({include})"
