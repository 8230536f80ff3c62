"""Vectorized predicate/fstring compiler over columnar metadata.

The reference evaluates include-expressions by rebuilding a HashMapContext and
re-parsing values for EVERY row (pgen-rs/src/pfile.rs:319-329) — the
O(rows) hot spot of metadata filtering (SURVEY.md §3.1). Here the expression
is parsed ONCE and lowered to whole-column numpy (or JAX, see
compile_device.py) operations:

    ID == "rs8100066" || ALT == "G"
      -> (id_col == b"rs8100066") | (alt_col == b"G")   # two memcmp sweeps

Any construct outside the vectorizable subset (function calls, numeric
column math) falls back to the exact row interpreter, so evalexpr parity
never depends on compiler coverage. The compiled mask must agree with
interp.eval_boolean on every row; tests/test_expr.py enforces this on random
expressions.

Copied from ``pgen_tpu/query/compile.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

from pgen_tpu_torch.query.ast import Binary, Call, ExprError, Lit, Unary, Var
from pgen_tpu_torch.query.interp import (
    _apply_binary,
    _is_num,
    _type_name,
    eval_boolean,
    eval_string,
)
from pgen_tpu_torch.query.parser import parse

# Compiled value kinds
_MASK = "mask"  # np.bool_ (rows,)
_STRCOL = "strcol"  # np.bytes_ 'S' (rows,)
_NUMCOL = "numcol"  # int64/float64 (rows,) — extension variables (GT_*)
_SCALAR = "scalar"  # python constant
_COLREF = "colref"  # lazy column handle: materialized only when needed


class _Fallback(Exception):
    """Internal: expression leaves the vectorizable subset."""


class _ColRef:
    """Lazy handle to a metadata column.

    Equality against a string literal runs straight off the field-offset
    index (MetadataTable.column_equals) — no padded matrix, no big
    temporaries; any other use materializes the 'S' array once.
    """

    __slots__ = ("table", "name")

    def __init__(self, table, name):
        self.table = table
        self.name = name

    def materialize(self):
        return self.table.get_column_bytes(self.name)


def _lower(node, table, extra=None):
    if isinstance(node, Lit):
        return (_SCALAR, node.value)
    if isinstance(node, Var):
        if extra and node.name in extra:
            col = extra[node.name]
            dt = getattr(col, "dtype", None)
            if dt is not None and dt == bool:
                return (_MASK, col)  # DUP_* whole-column boolean variables
            if dt is not None and dt.kind == "S":
                return (_STRCOL, col)  # GT_TEXT()/GT_ROW string columns
            return (_NUMCOL, col)
        if node.name not in table.columns:
            virt = table.get_virtual_bytes(node.name)
            if virt is not None:
                return (_STRCOL, virt)
            raise ExprError(f"variable identifier is not bound: {node.name}")
        return (_COLREF, _ColRef(table, node.name))
    if isinstance(node, Unary):
        kind, v = _lower(node.operand, table, extra)
        if node.op == "!":
            if kind == _MASK:
                return (_MASK, ~v)
            if kind == _SCALAR:
                if not isinstance(v, bool):
                    raise ExprError(f"!: expected Boolean, got {_type_name(v)}")
                return (_SCALAR, not v)
            raise ExprError("!: expected Boolean, got String")
        if node.op == "neg":
            if kind == _SCALAR:
                if not _is_num(v):
                    raise ExprError(f"unary -: expected a number, got {_type_name(v)}")
                return (_SCALAR, -v)
            if kind == _NUMCOL:
                return (_NUMCOL, -v)
            raise ExprError("unary -: expected a number, got String")
        raise _Fallback
    if isinstance(node, Binary):
        try:
            lk, lv = _lower(node.left, table, extra)
        except _Fallback:
            lk = lv = None
        try:
            rk, rv = _lower(node.right, table, extra)
        except _Fallback:
            rk = rv = None
        except ExprError:
            # the left operand already fell back: unless the right side
            # holds a dup_* builtin (whose errors are real — the row
            # interpreter cannot evaluate it either), hand the WHOLE
            # expression to the interpreter, whose per-row
            # short-circuit may never evaluate the erroring side
            if lk is not None or _contains_dup(node.right):
                raise
            raise _Fallback from None
        if lk is None and rk is None:
            raise _Fallback
        if lk is None or rk is None:
            # One operand left the vectorizable subset. Normally the whole
            # expression falls back to the row interpreter — but if the
            # OTHER operand holds a dup_* builtin (whole-column by nature,
            # the interpreter cannot evaluate it), substitute that side's
            # compiled mask as a precomputed boolean variable and row-eval
            # the binary itself, keeping evalexpr's per-row short-circuit
            # semantics exact (r4 advisor finding).
            good_node = node.right if lk is None else node.left
            gk, gv = (rk, rv) if lk is None else (lk, lv)
            if node.op in ("&&", "||") and _contains_dup(good_node):
                if gk == _SCALAR and isinstance(gv, bool):
                    gk, gv = _MASK, np.full(table.num_rows, gv, dtype=bool)
                if gk == _MASK:
                    gv = (
                        np.broadcast_to(gv, (table.num_rows,))
                        if np.ndim(gv) == 0
                        else np.asarray(gv, dtype=bool)
                    )
                    name = "__dup_compiled__"
                    sub = Var(name)
                    # substitute the compiled (dup) side; keep the
                    # fallback side for row-exact evaluation
                    newnode = (
                        Binary(node.op, sub, node.right)
                        if rk is None
                        else Binary(node.op, node.left, sub)
                    )
                    extra2 = dict(extra or {})
                    extra2[name] = gv
                    return (_MASK, _fallback_mask(newnode, table, extra2))
            raise _Fallback
        return _lower_binary(node.op, lk, lv, rk, rv)
    if isinstance(node, Call):
        if node.name == "num" and len(node.args) == 1:
            kind, v = _lower(node.args[0], table, extra)
            if kind == _NUMCOL:
                return (_NUMCOL, v)
            if kind == _SCALAR:
                from pgen_tpu_torch.query.interp import _call_builtin

                return (_SCALAR, _call_builtin("num", [v]))
            if kind == _COLREF:
                kind, v = _STRCOL, v.materialize()
            if kind == _STRCOL:
                parsed = _parse_numeric_column(v)
                if parsed is None:
                    raise _Fallback  # mixed Int/Float tags: row-exact path
                return (_NUMCOL, parsed)
            raise ExprError("num: expected String or number, got Boolean")
        if node.name == "in_list" and len(node.args) == 2:
            return _lower_in_list(node, table, extra)
        if node.name in ("dup_first_within", "dup_unique_within") and len(
            node.args
        ) == 1:
            # post-filter duplicate-group semantics (plink2 --rm-dup):
            # true exactly on rows that are the first occurrence of their
            # ID (or whose ID is unique) AMONG rows satisfying the inner
            # condition; false elsewhere. Whole-column by nature, so only
            # this engine can evaluate it — an inner condition outside
            # the vectorizable subset (regex etc.) is evaluated with the
            # row-exact interpreter HERE rather than failing the whole
            # expression over to it.
            try:
                kind, v = _lower(node.args[0], table, extra)
            except _Fallback:
                kind, v = _MASK, _fallback_mask(node.args[0], table, extra)
            if kind == _SCALAR and isinstance(v, bool):
                kind, v = _MASK, np.full(table.num_rows, v, dtype=bool)
            if kind != _MASK:
                raise ExprError(
                    f"{node.name}: expected a Boolean condition"
                )
            cond = (
                np.broadcast_to(v, (table.num_rows,))
                if np.ndim(v) == 0
                else v
            )
            from pgen_tpu_torch.query.dup import first_unique_within

            first, unique = first_unique_within(
                table.get_column_bytes("ID"), cond
            )
            return (
                _MASK,
                first if node.name == "dup_first_within" else unique,
            )
        if node.name == "str::from" and len(node.args) == 1:
            kind, v = _lower(node.args[0], table, extra)
            if kind == _SCALAR:
                from pgen_tpu_torch.query.interp import _call_builtin

                return (_SCALAR, _call_builtin("str::from", [v]))
            if kind in (_COLREF, _STRCOL):
                return (kind, v)  # str::from(String) is the identity
            if kind == _NUMCOL and np.issubdtype(v.dtype, np.integer):
                return (_STRCOL, np.char.mod(b"%d", v))
            if kind == _MASK and np.ndim(v) == 1:
                return (
                    _STRCOL,
                    np.where(v, np.bytes_(b"true"), np.bytes_(b"false")),
                )
            # float columns: Python repr() formatting is row-exact territory
            raise _Fallback
        raise _Fallback
    raise _Fallback


def _contains_dup(node) -> bool:
    """True if the subtree references a dup_* whole-column builtin (only
    the compiler can evaluate those; the row interpreter has no binding)."""
    if isinstance(node, Call):
        return node.name in ("dup_first_within", "dup_unique_within") or any(
            _contains_dup(a) for a in node.args
        )
    if isinstance(node, Binary):
        return _contains_dup(node.left) or _contains_dup(node.right)
    if isinstance(node, Unary):
        return _contains_dup(node.operand)
    return False


def _lower_in_list(node, table, extra):
    """in_list(x, "a,b,c") -> one np.isin sweep over the column.

    Matches the interpreter's semantics exactly: a String needle compares
    items verbatim; a numeric needle (num(POS), GT_*) matches items that
    parse to the same variant tag (Int vs Float) and value.
    """
    from pgen_tpu_torch.query.interp import _call_builtin

    lk, lv = _lower(node.args[0], table, extra)
    rk, rv = _lower(node.args[1], table, extra)
    if rk != _SCALAR or not isinstance(rv, str):
        if rk in (_STRCOL, _COLREF):
            raise _Fallback  # per-row list strings: row-exact path
        if rk == _NUMCOL:
            tag = "Int" if np.issubdtype(rv.dtype, np.integer) else "Float"
            raise ExprError(f"in_list: expected a String list, got {tag}")
        raise ExprError(
            "in_list: expected a String list, got "
            + ("Boolean" if rk == _MASK else _type_name(rv))
        )
    items = rv.split(",")
    if lk == _SCALAR:
        return (_SCALAR, _call_builtin("in_list", [lv, rv]))
    if lk == _COLREF:
        lk, lv = _STRCOL, lv.materialize()
    if lk == _STRCOL:
        values = np.array(items, dtype=np.bytes_)
        return (_MASK, np.isin(lv, values))
    if lk == _NUMCOL:
        is_int = np.issubdtype(lv.dtype, np.integer)
        keep = []
        for item in items:
            try:
                parsed = _call_builtin("num", [item])
            except ExprError:
                continue
            if isinstance(parsed, int) == is_int:
                keep.append(parsed)
        if not keep:
            return (_MASK, np.zeros(len(lv), dtype=bool))
        return (_MASK, np.isin(lv, np.array(keep, dtype=lv.dtype)))
    raise ExprError("in_list: expected String or number, got Boolean")


def _parse_numeric_column(arr):
    """'S' column -> int64 (all rows Int) or float64 (no row Int) array.

    Returns None when per-row Int/Float tags would be heterogeneous — the
    interpreter's variant-tagged equality then needs the row-exact path.
    Unparseable rows also fall back (the interpreter raises there with the
    offending value).
    """
    try:
        return arr.astype(np.int64)
    except (ValueError, OverflowError):
        pass
    try:
        f = arr.astype(np.float64)
    except (ValueError, OverflowError):
        return None
    # float column is tag-uniform only if NO row parses as an Int
    maybe_int = np.char.isdigit(np.char.lstrip(arr, b"+-"))
    if maybe_int.any():
        return None
    return f


def _as_bytes(s: str) -> bytes:
    return s.encode("utf-8")


def _lower_binary(op, lk, lv, rk, rv):
    if lk == _SCALAR and rk == _SCALAR:
        return (_SCALAR, _apply_binary(op, lv, rv))

    # fast path: column == / != string literal straight off the offsets
    if op in ("==", "!="):
        if lk == _COLREF and rk == _SCALAR and isinstance(rv, str):
            m = lv.table.column_equals(lv.name, rv.encode("utf-8"))
            return (_MASK, ~m if op == "!=" else m)
        if rk == _COLREF and lk == _SCALAR and isinstance(lv, str):
            m = rv.table.column_equals(rv.name, lv.encode("utf-8"))
            return (_MASK, ~m if op == "!=" else m)
    if lk == _COLREF:
        lk, lv = _STRCOL, lv.materialize()
    if rk == _COLREF:
        rk, rv = _STRCOL, rv.materialize()

    if (lk == _NUMCOL or rk == _NUMCOL) and op not in ("&&", "||"):
        return _lower_numeric(op, lk, lv, rk, rv)

    if op in ("==", "!="):
        neg = op == "!="
        res = _equality(lk, lv, rk, rv)
        return (_MASK, ~res if neg else res)

    if op in ("<", "<=", ">", ">="):
        return (_MASK, _ordering(op, lk, lv, rk, rv))

    if op in ("&&", "||"):
        lm = _to_mask(lk, lv, op)
        try:
            rm = _to_mask(rk, rv, op)
        except ExprError:
            # evalexpr short-circuits the RHS *type check*: rows whose LHS
            # already decides the result ('false && x', 'true || x') never
            # inspect the RHS type (interp.py _apply_binary does the same
            # via Python's and/or). Only rows that would consult the RHS
            # may raise.
            if op == "&&" and not np.any(lm):
                return (_MASK, np.zeros_like(lm) if np.ndim(lm) else False)
            if op == "||" and np.all(lm):
                return (_MASK, np.ones_like(lm) if np.ndim(lm) else True)
            raise
        return (_MASK, lm & rm if op == "&&" else lm | rm)

    if op == "+":
        if lk == _STRCOL and rk == _STRCOL:
            return (_STRCOL, np.char.add(lv, rv))
        if lk == _STRCOL and rk == _SCALAR:
            if not isinstance(rv, str):
                raise ExprError(f"+: cannot concatenate String and {_type_name(rv)}")
            return (_STRCOL, np.char.add(lv, _as_bytes(rv)))
        if lk == _SCALAR and rk == _STRCOL:
            if not isinstance(lv, str):
                raise ExprError(f"+: cannot concatenate {_type_name(lv)} and String")
            return (_STRCOL, np.char.add(_as_bytes(lv), rv))
        raise ExprError("+: expected two numbers or two strings")

    if op in ("-", "*", "/", "%", "^"):
        # All metadata columns are strings; column arithmetic is a type error
        # on every row, exactly as the interpreter reports it.
        raise ExprError(f"{op}: expected two numbers, got String operand")

    raise _Fallback


def _lower_numeric(op, lk, lv, rk, rv):
    """Binary op where at least one side is a numeric extension column.

    Value semantics match the interpreter's per-row Int/Float rules:
    variant-tagged equality (Int vs Float or vs String is simply unequal),
    promoted ordering/arithmetic, truncating Int division/modulo.
    """

    def is_intcol(k, v):
        return k == _NUMCOL and np.issubdtype(v.dtype, np.integer)

    def num_scalar(v):
        return _is_num(v)

    other_k, other_v = (rk, rv) if lk == _NUMCOL else (lk, lv)
    if op in ("==", "!="):
        if lk == _NUMCOL and rk == _NUMCOL:
            same_tag = is_intcol(lk, lv) == is_intcol(rk, rv)
            res = (lv == rv) if same_tag else np.zeros(len(lv), dtype=bool)
        elif other_k == _SCALAR and num_scalar(other_v):
            col = lv if lk == _NUMCOL else rv
            tag_match = is_intcol(_NUMCOL, col) == isinstance(
                other_v, int
            ) and not isinstance(other_v, bool)
            res = (col == other_v) if tag_match else np.zeros(len(col), dtype=bool)
        else:
            # Int col vs String/Boolean/strcol: never equal
            n = len(lv) if lk == _NUMCOL else len(rv)
            res = np.zeros(n, dtype=bool)
        return (_MASK, ~res if op == "!=" else res)
    if op in ("<", "<=", ">", ">="):
        if (other_k == _SCALAR and not num_scalar(other_v)) or other_k in (
            _STRCOL,
            _MASK,
        ):
            raise ExprError(f"{op}: expected two numbers")
        fn = {"<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}[op]
        return (_MASK, fn(lv, rv))
    if op in ("+", "-", "*"):
        if (other_k == _SCALAR and not num_scalar(other_v)) or other_k in (
            _STRCOL,
            _MASK,
        ):
            raise ExprError(f"{op}: expected two numbers")
        fn = {"+": np.add, "-": np.subtract, "*": np.multiply}[op]
        return (_NUMCOL, fn(lv, rv))
    if op in ("/", "%"):
        if (other_k == _SCALAR and not num_scalar(other_v)) or other_k in (
            _STRCOL,
            _MASK,
        ):
            raise ExprError(f"{op}: expected two numbers")
        both_int = (
            (lk != _NUMCOL or is_intcol(lk, lv))
            and (rk != _NUMCOL or is_intcol(rk, rv))
            and not any(
                isinstance(x, float) for x in (lv, rv) if not isinstance(x, np.ndarray)
            )
        )
        if both_int:
            if np.any(np.asarray(rv) == 0):
                raise ExprError("division by zero" if op == "/" else "modulo by zero")
            if op == "/":
                q = np.trunc(np.true_divide(lv, rv)).astype(np.int64)
                return (_NUMCOL, q)
            return (_NUMCOL, np.fmod(np.asarray(lv), rv).astype(np.int64))
        res = np.true_divide(lv, rv) if op == "/" else np.fmod(lv, rv)
        return (_NUMCOL, np.asarray(res, dtype=np.float64))
    if op == "^":
        if (other_k == _SCALAR and not num_scalar(other_v)) or other_k in (
            _STRCOL,
            _MASK,
        ):
            raise ExprError("^: expected two numbers")
        return (_NUMCOL, np.power(np.asarray(lv, dtype=np.float64), rv))
    raise _Fallback


def _equality(lk, lv, rk, rv):
    if lk == _STRCOL and rk == _STRCOL:
        return lv == rv
    if lk == _STRCOL or rk == _STRCOL:
        col, scalar = (lv, rv) if lk == _STRCOL else (rv, lv)
        if isinstance(scalar, str):
            return col == _as_bytes(scalar)
        # Cross-type equality is variant-tagged: always unequal (interp.py).
        return np.zeros(len(col), dtype=bool)
    if lk == _MASK and rk == _MASK:
        return lv == rv
    if lk == _MASK or rk == _MASK:
        mask, scalar = (lv, rv) if lk == _MASK else (rv, lv)
        if isinstance(scalar, bool):
            return mask == scalar
        return np.zeros(len(mask), dtype=bool)
    raise _Fallback


def _ordering(op, lk, lv, rk, rv):
    ops = {
        "<": np.less,
        "<=": np.less_equal,
        ">": np.greater,
        ">=": np.greater_equal,
    }
    if lk == _STRCOL and rk == _STRCOL:
        return ops[op](lv, rv)
    if lk == _STRCOL and rk == _SCALAR:
        if not isinstance(rv, str):
            raise ExprError(f"{op}: cannot order String against {_type_name(rv)}")
        return ops[op](lv, _as_bytes(rv))
    if lk == _SCALAR and rk == _STRCOL:
        if not isinstance(lv, str):
            raise ExprError(f"{op}: cannot order {_type_name(lv)} against String")
        return ops[op](_as_bytes(lv), rv)
    if lk == _MASK or rk == _MASK:
        raise ExprError(f"{op}: cannot order Booleans")
    raise _Fallback


def _to_mask(kind, v, op):
    if kind == _MASK:
        return v
    if kind == _SCALAR:
        if not isinstance(v, bool):
            raise ExprError(f"{op}: expected Boolean, got {_type_name(v)}")
        return v  # numpy broadcasts python bool
    raise ExprError(f"{op}: expected Boolean, got String")


def _row_context(table, i, extra=None, virtuals=None):
    ctx = {name: table.get_column_strs(name)[i] for name in table.columns}
    if extra:
        for name, arr in extra.items():
            v = arr[i]
            if arr.dtype == bool:
                ctx[name] = bool(v)  # DUP_* boolean variables
            elif arr.dtype.kind == "S":
                ctx[name] = v.decode("utf-8")  # GT_TEXT()/GT_ROW strings
            else:
                ctx[name] = (
                    float(v)
                    if np.issubdtype(arr.dtype, np.floating)
                    else int(v)
                )
    if virtuals:
        for name, col in virtuals.items():
            ctx[name] = col[i]
    return ctx


def _referenced_virtuals(node, table, extra=None) -> dict:
    """Materialize INFO_* virtual columns the expression references, so the
    row-interpreter fallback sees the same variables as the compiler."""
    from pgen_tpu_torch.query.ast import variables

    virt = {}
    for name in variables(node):
        if name in table.columns or (extra and name in extra):
            continue
        col = table.get_virtual_strs(name)
        if col is not None:
            virt[name] = col
    return virt


def _fallback_mask(node, table, extra=None) -> np.ndarray:
    virtuals = _referenced_virtuals(node, table, extra)
    mask = np.empty(table.num_rows, dtype=bool)
    for i in range(table.num_rows):
        mask[i] = eval_boolean(node, _row_context(table, i, extra, virtuals))
    return mask


def compile_predicate(expr, table, extra=None) -> np.ndarray:
    """Evaluate a boolean include-expression over every metadata row.

    Returns a (num_rows,) bool mask. ``expr`` may be a source string or a
    parsed AST; ``None`` keeps every row (pfile.rs:93,321 map_or(true, ..)).
    ``extra`` maps extension variable names (e.g. GT_AC) to numeric arrays.
    """
    if expr is None:
        return np.ones(table.num_rows, dtype=bool)
    node = parse(expr) if isinstance(expr, str) else expr
    if table.num_rows == 0:
        # The reference never evaluates the expression when there are no
        # rows, so even an ill-typed expression succeeds vacuously.
        return np.zeros(0, dtype=bool)
    try:
        kind, v = _lower(node, table, extra)
    except _Fallback:
        return _fallback_mask(node, table, extra)
    if kind == _SCALAR:
        if not isinstance(v, bool):
            raise ExprError(f"expected Boolean result, got {_type_name(v)}")
        return np.full(table.num_rows, v, dtype=bool)
    if kind == _NUMCOL:
        raise ExprError("expected Boolean result, got a number")
    if kind != _MASK:
        raise ExprError("expected Boolean result, got String")
    return np.broadcast_to(v, (table.num_rows,)) if np.ndim(v) == 0 else v


def compile_fstring_bytes(expr, table, rows, extra=None) -> np.ndarray | None:
    """Vectorized fstring evaluation straight to output bytes.

    Returns a uint8 buffer of newline-terminated result lines for the given
    rows, or None when the expression needs the row-interpreter fallback.
    Avoids materializing per-row Python strings on the query hot path.
    """
    node = parse(expr) if isinstance(expr, str) else expr
    rows = np.asarray(rows)
    if len(rows) == 0 and table.num_rows == 0:
        return np.zeros(0, dtype=np.uint8)
    try:
        kind, v = _lower(node, table, extra)
    except _Fallback:
        return None
    if kind == _COLREF:
        kind, v = _STRCOL, v.materialize()
    if kind == _SCALAR:
        if not isinstance(v, str):
            raise ExprError(f"expected String result, got {_type_name(v)}")
        line = v.encode("utf-8") + b"\n"
        return np.frombuffer(line * len(rows), dtype=np.uint8)
    if kind == _NUMCOL:
        raise ExprError("expected String result, got a number")
    if kind != _STRCOL:
        raise ExprError("expected String result, got Boolean")
    if len(rows) == 0:
        return np.zeros(0, dtype=np.uint8)
    sel = np.ascontiguousarray(v[rows])
    width = sel.dtype.itemsize
    mat = sel.view(np.uint8).reshape(len(sel), width)
    lens = np.char.str_len(sel).astype(np.int32)
    try:
        from pgen_tpu_torch.native import HAVE_NATIVE, native
    except ImportError:
        HAVE_NATIVE = False
    if HAVE_NATIVE:
        return native.join_lines(mat, lens)
    out = b"\n".join(bytes(x) for x in sel) + b"\n"
    return np.frombuffer(out, dtype=np.uint8)


def compile_fstring(expr, table, rows=None, extra=None) -> list:
    """Evaluate a -f/--fstring expression for the given rows (default: all).

    Returns a list of result strings (one per selected row), matching
    eval_string_with_context per row (pfile.rs:97).
    """
    node = parse(expr) if isinstance(expr, str) else expr
    if rows is None:
        rows = np.arange(table.num_rows)
    rows = np.asarray(rows)
    if len(rows) == 0:
        return []
    try:
        kind, v = _lower(node, table, extra)
    except _Fallback:
        virtuals = _referenced_virtuals(node, table, extra)
        return [
            eval_string(node, _row_context(table, int(i), extra, virtuals))
            for i in rows
        ]
    if kind == _SCALAR:
        if not isinstance(v, str):
            raise ExprError(f"expected String result, got {_type_name(v)}")
        return [v] * len(rows)
    if kind == _COLREF:
        kind, v = _STRCOL, v.materialize()
    if kind == _NUMCOL:
        raise ExprError("expected String result, got a number")
    if kind != _STRCOL:
        raise ExprError("expected String result, got Boolean")
    sel = v[rows]
    return [b.decode("utf-8") for b in sel]
