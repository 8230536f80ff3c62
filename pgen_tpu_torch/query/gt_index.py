"""Per-sample genotype indexing in query expressions.

Closes the reference's wished-for redesign — "indexing into genotypes in
their queries (for both filters and format strings)"
(pgen-rs/README.md:200-204, 259-264; the reference itself cannot
do this, bcftools can via %GT):

    GT("NA20900")       Int alt-allele dosage of that sample per variant:
                        0 / 1 / 2, missing call = -9 (plink missing code)
    GT(17)              same, by 0-based sample index (no psam lookup)
    GT_TEXT("NA20900")  the VCF genotype text per variant: "0/0", "0/1",
                        "1/1", "./." — byte-identical to filter's output
    GT_ROW              String variable: ALL samples' genotype texts for
                        the row, tab-joined (bcftools '[%GT\\t]' analog)

On the sample axis (query -s / --include-sam) the argument names a
VARIANT instead — GT("rs123") / GT(5) give each sample's dosage for that
variant, and GT_ROW is the sample's genotype texts across all variants.

Mechanics: the ASTs are rewritten once — each GT()/GT_TEXT() call with a
literal argument becomes an internal extension variable bound to a
whole-column numpy array, so both the vectorized compiler and the
row-exact interpreter see plain variables (never a per-row Python loop).
A single sample's column is a strided byte gather straight off the
packed record matrix (records[:, s//4] >> 2*(s%4) — no full decode);
GT_ROW decodes the full matrix once through the 4-token text table.

Referencing any of these opts the query into one pass over the packed
.pgen records, like the GT_* aggregate variables (pipeline/query.py);
every other query keeps the reference's metadata-only scaling property
(README.md:158-160).

Copied from ``pgen_tpu/query/gt_index.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

from pgen_tpu_torch.query.ast import (
    Assign,
    Binary,
    Call,
    Chain,
    ExprError,
    Lit,
    TupleExpr,
    Unary,
    Var,
    walk,
)

GT_CALL_NAMES = ("GT", "GT_TEXT")
GT_ROW_NAME = "GT_ROW"

# 2-bit storage code -> VCF genotype text (pfile.rs:177-183 mapping,
# LSB-first extraction handled by the shift below)
_GT_TOKENS = np.array([b"0/0", b"0/1", b"1/1", b"./."], dtype="S3")
# code -> alt dosage; 3 (missing) -> -9, the plink missing convention
_GT_DOSAGE = np.array([0, 1, 2, -9], dtype=np.int64)


def uses_gt_index(nodes) -> bool:
    """True if any AST references GT()/GT_TEXT() calls or GT_ROW."""
    for node in nodes:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Call) and n.name in GT_CALL_NAMES:
                return True
            if isinstance(n, Var) and n.name == GT_ROW_NAME:
                return True
    return False


def _call_spec(node: Call):
    """(builtin, key) for a GT/GT_TEXT call; validates the literal arg."""
    if len(node.args) != 1:
        raise ExprError(
            f"{node.name}: expected exactly one argument, got {len(node.args)}"
        )
    arg = node.args[0]
    if (
        not isinstance(arg, Lit)
        or isinstance(arg.value, bool)
        or not isinstance(arg.value, (str, int))
    ):
        raise ExprError(
            f"{node.name}: argument must be a String ID literal or an Int "
            "index (per-row genotype columns are bound once, up front)"
        )
    return node.name, arg.value


def _mangle(builtin: str, key) -> str:
    # internal extension-variable name; never produced by the parser
    return f"__{builtin}[{key!r}]__"


def _rewrite(node, repl: dict):
    if isinstance(node, Call):
        if node.name in GT_CALL_NAMES:
            return Var(repl[_mangle(*_call_spec(node))])
        return Call(node.name, tuple(_rewrite(a, repl) for a in node.args))
    if isinstance(node, Binary):
        return Binary(node.op, _rewrite(node.left, repl), _rewrite(node.right, repl))
    if isinstance(node, Unary):
        return Unary(node.op, _rewrite(node.operand, repl))
    if isinstance(node, TupleExpr):
        return TupleExpr(
            tuple(_rewrite(a, repl) for a in node.items), node.grouped
        )
    if isinstance(node, Chain):
        return Chain(tuple(_rewrite(a, repl) for a in node.exprs), node.trailing)
    if isinstance(node, Assign):
        return Assign(node.op, _rewrite(node.target, repl), _rewrite(node.value, repl))
    return node


def _codes_matrix(records: np.ndarray, num_samples: int) -> np.ndarray:
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    return unpack_codes_numpy(np.ascontiguousarray(records), num_samples)


def _row_texts(codes: np.ndarray) -> np.ndarray:
    """(rows, n) codes -> 'S(4n-1)' tab-joined genotype-text column."""
    rows, n = codes.shape
    toks = np.empty((4, 4), dtype=np.uint8)
    toks[:, :3] = _GT_TOKENS[:, None].view(np.uint8).reshape(4, 3)
    toks[:, 3] = ord("\t")
    body = toks[codes].reshape(rows, 4 * n)[:, : 4 * n - 1]
    return np.ascontiguousarray(body).view(f"S{4 * n - 1}").reshape(rows)


def bind_gt_index(
    nodes,
    records: np.ndarray,
    num_samples: int,
    table,
    axis_samples: bool,
    lookup_ids,
):
    """Rewrite GT()/GT_TEXT()/GT_ROW references into bound columns.

    nodes: iterable of AST-or-None (include predicate, fstring, ...).
    records: (num_variants, record_size) uint8 packed matrix (memmap ok).
    table: the metadata table the expressions evaluate over (pvar, or
    psam under -s) — GT_ROW defers to a real file column of that name.
    axis_samples: False = variant axis (argument is a sample IID/index),
    True = sample axis (argument is a variant ID/index).
    lookup_ids: callable () -> 'S' array of the OTHER axis's ID column
    (psam IID on the variant axis, pvar ID on the sample axis), called
    only when a string key needs resolving.

    Returns (rewritten_nodes, extra) where extra maps internal variable
    names to numpy columns ({} when nothing is referenced).
    """
    num_variants = records.shape[0]
    specs = {}
    for node in nodes:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Call) and n.name in GT_CALL_NAMES:
                builtin, key = _call_spec(n)
                specs[_mangle(builtin, key)] = (builtin, key)
    extra = {}
    ids = None
    axis_len = num_samples if axis_samples else num_variants
    other_len = num_variants if axis_samples else num_samples
    other_desc = "variant" if axis_samples else "sample"
    for name, (builtin, key) in specs.items():
        if isinstance(key, str):
            if ids is None:
                ids = lookup_ids()
            hit = np.flatnonzero(ids == key.encode("utf-8"))
            if len(hit) == 0:
                raise ExprError(
                    f"{builtin}: {other_desc} ID {key!r} not found"
                )
            idx = int(hit[0])  # first occurrence, like the IID column scan
        else:
            idx = key
        if not 0 <= idx < other_len:
            # also guards string-resolved rows past the pgen's axis (an
            # oversized metadata file must not read pad bits / crash)
            raise ExprError(
                f"{builtin}({key!r}): {other_desc} index {idx} out of "
                f"range (pgen holds {other_len})"
            )
        if axis_samples:
            # one record decoded for every sample
            codes = _codes_matrix(records[idx : idx + 1], num_samples)[0]
        else:
            # strided byte gather: sample idx's 2-bit field per variant
            col = np.asarray(records[:, idx >> 2])
            codes = (col >> np.uint8((idx & 3) * 2)) & np.uint8(3)
        extra[name] = (
            _GT_TOKENS[codes] if builtin == "GT_TEXT" else _GT_DOSAGE[codes]
        )
    needs_row = any(
        node is not None
        and any(
            isinstance(n, Var) and n.name == GT_ROW_NAME for n in walk(node)
        )
        for node in nodes
    ) and GT_ROW_NAME not in table.columns
    if needs_row:
        codes = _codes_matrix(records, num_samples)
        extra[GT_ROW_NAME] = _row_texts(codes.T if axis_samples else codes)
    if not specs and not needs_row:
        return list(nodes), extra
    new_nodes = [
        None if node is None else _rewrite(node, {k: k for k in specs})
        for node in nodes
    ]
    # clamp to the metadata row count (oversized pgen tolerated elsewhere)
    extra = {k: v[: table.num_rows] for k, v in extra.items()}
    return new_nodes, extra
