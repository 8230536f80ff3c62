"""Device lowering of include-predicates over padded column tensors: the
port of ``pgen_tpu/query/compile_device.py``.

Metadata columns reach the device as zero-padded ``(rows, width)`` uint8
matrices with int32 lengths (``MetadataTable.get_column_padded``, turned
into tensors by ``columns_to_device``), and the expression lowers to torch
boolean ops on them. Zero padding is safe: NUL sorts below every text byte,
so a padded byte compare is the lexicographic compare.

The supported subset is pgen_tpu's, construct for construct: anything
outside it raises ``DeviceFallback`` (callers then evaluate the predicate on
the host with ``pgen_tpu.query.compile``), type errors raise ``ExprError``.
Within the subset the mask equals ``pgen_tpu.query.interp``'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.query import Binary, ExprError, Lit, Unary, Var, parse


class DeviceFallback(Exception):
    """Expression leaves the device-lowerable subset."""


_MASK = "mask"
_COL = "col"  # (mat (N, W) u8, lens (N,) int32)
_SCALAR = "scalar"


def columns_to_device(cols: dict, device) -> dict:
    """{name: (mat u8 (N, W), lens (N,))} numpy pairs, as
    ``get_column_padded`` returns them -> the same pairs as tensors on
    ``device`` (lens as int32)."""
    return {
        name: (
            torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32)).to(device),
        )
        for name, (mat, lens) in cols.items()
    }


def _pad_lit(s: str, width: int, device) -> torch.Tensor:
    b = s.encode("utf-8")
    out = np.zeros(width, dtype=np.uint8)
    out[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return torch.from_numpy(out).to(device)


def _common_width(a: torch.Tensor, b: torch.Tensor):
    w = max(a.shape[1], b.shape[1])
    return F.pad(a, (0, w - a.shape[1])), F.pad(b, (0, w - b.shape[1]))


def _col_eq_lit(mat: torch.Tensor, lit: str) -> torch.Tensor:
    if len(lit.encode("utf-8")) > mat.shape[1]:
        return torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    return (mat == _pad_lit(lit, mat.shape[1], mat.device)[None, :]).all(dim=1)


def _col_cmp(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Lexicographic ordering of two (N, W) zero-padded byte matrices."""
    a, b = _common_width(a, b)
    diff = a != b
    any_diff = diff.any(dim=1)
    # argmax refuses bool; on u8 it returns the first maximum, the first
    # differing byte
    first = diff.to(torch.uint8).argmax(dim=1, keepdim=True)
    av = a.gather(1, first)[:, 0]
    bv = b.gather(1, first)[:, 0]
    if op == "<":
        return any_diff & (av < bv)
    if op == "<=":
        return (any_diff & (av < bv)) | ~any_diff
    if op == ">":
        return any_diff & (av > bv)
    return (any_diff & (av > bv)) | ~any_diff


def lower_device(node, cols: dict) -> torch.Tensor:
    """Lower an AST to a (rows,) bool mask over the given column tensors.

    ``cols`` maps column name -> (mat, lens) tensors on one device. Raises
    DeviceFallback for unsupported constructs, ExprError for type errors.
    """
    kind, v = _lower(node, cols)
    if kind == _SCALAR:
        if not isinstance(v, bool):
            raise ExprError("expected Boolean result")
    elif kind != _MASK:
        raise ExprError("expected Boolean result, got String")
    if isinstance(v, bool):  # a constant, e.g. `true` or `true && false`
        some = next(iter(cols.values()))[0]
        return torch.full((some.shape[0],), v, dtype=torch.bool, device=some.device)
    return v


def compile_predicate_device(expr, table, device="cuda") -> torch.Tensor:
    """Evaluate expr on ``device`` over a MetadataTable's padded columns: the
    card unless the caller asks for the CPU, as pgen_tpu's runs on its
    default device; without CUDA a call for the card raises."""
    from pgen_tpu_torch.query.ast import variables

    device = resolve_device(device)
    node = parse(expr) if isinstance(expr, str) else expr
    cols = {
        name: table.get_column_padded(name)
        for name in variables(node)
        if name in table.columns
    }
    if not cols:
        raise DeviceFallback("no column variables in expression")
    return lower_device(node, columns_to_device(cols, device))


def _lower(node, cols):
    if isinstance(node, Lit):
        return (_SCALAR, node.value)
    if isinstance(node, Var):
        if node.name not in cols:
            raise ExprError(f"variable identifier is not bound: {node.name}")
        return (_COL, cols[node.name])
    if isinstance(node, Unary):
        kind, v = _lower(node.operand, cols)
        if node.op == "!" and kind == _MASK:
            return (_MASK, (not v) if isinstance(v, bool) else ~v)
        if node.op == "!" and kind == _SCALAR and isinstance(v, bool):
            return (_SCALAR, not v)
        raise DeviceFallback(f"unary {node.op}")
    if isinstance(node, Binary):
        lk, lv = _lower(node.left, cols)
        rk, rv = _lower(node.right, cols)
        op = node.op
        if op in ("==", "!="):
            m = _eq(lk, lv, rk, rv)
            return (_MASK, ~m if op == "!=" else m)
        if op in ("<", "<=", ">", ">="):
            return (_MASK, _ord(op, lk, lv, rk, rv))
        if op in ("&&", "||"):
            lm = _as_mask(lk, lv)
            rm = _as_mask(rk, rv)
            return (_MASK, lm & rm if op == "&&" else lm | rm)
        raise DeviceFallback(f"operator {op}")
    raise DeviceFallback(type(node).__name__)


def _eq(lk, lv, rk, rv):
    if lk == _COL and rk == _SCALAR:
        if isinstance(rv, str):
            return _col_eq_lit(lv[0], rv)
        # a column holds strings: equal to no number or Boolean
        return torch.zeros(lv[0].shape[0], dtype=torch.bool, device=lv[0].device)
    if lk == _SCALAR and rk == _COL:
        return _eq(rk, rv, lk, lv)
    if lk == _COL and rk == _COL:
        a, b = _common_width(lv[0], rv[0])
        return (a == b).all(dim=1)
    raise DeviceFallback("equality shape")


def _ord(op, lk, lv, rk, rv):
    if lk == _COL and rk == _SCALAR:
        if not isinstance(rv, str):
            raise ExprError(f"{op}: cannot order String against non-String")
        mat = lv[0]
        # a literal longer than the column widens the compare
        w = max(mat.shape[1], len(rv.encode("utf-8")))
        litm = _pad_lit(rv, w, mat.device)[None, :].expand(mat.shape[0], w)
        return _col_cmp(mat, litm, op)
    if lk == _SCALAR and rk == _COL:
        flipped = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}[op]
        return _ord(flipped, rk, rv, lk, lv)
    if lk == _COL and rk == _COL:
        return _col_cmp(lv[0], rv[0], op)
    raise DeviceFallback("ordering shape")


def _as_mask(kind, v):
    if kind == _MASK:
        return v
    if kind == _SCALAR and isinstance(v, bool):
        return v
    # The host compiler implements evalexpr's short-circuited RHS type check
    # ('false && <string>' is all-false, not an error); defer to it rather
    # than duplicating that logic on the device.
    raise DeviceFallback("&&/||: non-Boolean operand")
