"""Row-wise expression interpreter (exact-parity fallback path).

Implements the evalexpr v11.3.0 value/type semantics the reference relies on
(pgen-rs/src/pfile.rs:93-97; README.md:268-280):

* ``==``/``!=`` compare values of ANY types; mismatched types are simply
  unequal (never an error) — so ``POS == 16647494`` is false while
  ``POS == "16647494"`` matches, because context variables are all strings.
* ``< <= > >=`` order two numbers (int/float mix promotes to float) or two
  strings (byte-wise lexicographic); anything else errors.
* ``+`` concatenates two strings or adds two numbers (int+int stays int);
  string+number errors.
* ``- * / % ^`` are numeric; int/int division and modulo stay integral
  (truncating, like Rust); ``^`` always yields a float.
* ``&&``/``||``/``!`` demand booleans; both operands evaluate eagerly.

The vectorized compiler (compile.py) must agree with this interpreter on
every expression it accepts; property tests enforce that.

Copied from ``pgen_tpu/query/interp.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import math

from pgen_tpu_torch.query.ast import (
    EMPTY,
    Assign,
    Binary,
    Call,
    Chain,
    ExprError,
    Lit,
    TupleExpr,
    Unary,
    Var,
)
from pgen_tpu_torch.query.parser import parse


def _type_name(v) -> str:
    if isinstance(v, bool):
        return "Boolean"
    if isinstance(v, int):
        return "Int"
    if isinstance(v, float):
        return "Float"
    if isinstance(v, str):
        return "String"
    if isinstance(v, tuple):
        return "Tuple"
    if v is EMPTY:
        return "Empty"
    return type(v).__name__


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _both_int(a, b) -> bool:
    return (
        isinstance(a, int)
        and isinstance(b, int)
        and not isinstance(a, bool)
        and not isinstance(b, bool)
    )


def _values_equal(a, b) -> bool:
    # evalexpr Value equality: variant-tagged, so Int(1) != Float(1.0) and no
    # cross-type coercion; Python needs explicit tag checks (bool vs int!).
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if _is_num(a) and _is_num(b):
        return type(a) is type(b) and a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(
            _values_equal(x, y) for x, y in zip(a, b)
        )
    if a is EMPTY and b is EMPTY:
        return True
    return False


def _expect_bool(v, op):
    if not isinstance(v, bool):
        raise ExprError(f"{op}: expected Boolean, got {_type_name(v)}")
    return v


def _numeric_pair(a, b, op):
    if not (_is_num(a) and _is_num(b)):
        raise ExprError(f"{op}: expected two numbers, got {_type_name(a)} and {_type_name(b)}")
    return a, b


def eval_value(node, context: dict):
    """Evaluate the AST against a {variable: value} context."""
    if isinstance(node, Lit):
        return node.value
    if isinstance(node, Var):
        try:
            return context[node.name]
        except KeyError:
            raise ExprError(f"variable identifier is not bound: {node.name}") from None
    if isinstance(node, Unary):
        v = eval_value(node.operand, context)
        if node.op == "!":
            return not _expect_bool(v, "!")
        if node.op == "neg":
            if not _is_num(v):
                raise ExprError(f"unary -: expected a number, got {_type_name(v)}")
            return -v
        raise ExprError(f"unknown unary operator {node.op}")
    if isinstance(node, Binary):
        a = eval_value(node.left, context)
        b = eval_value(node.right, context)
        return _apply_binary(node.op, a, b)
    if isinstance(node, Call):
        args = [eval_value(arg, context) for arg in node.args]
        return _call_builtin(node.name, args)
    if isinstance(node, TupleExpr):
        return tuple(eval_value(item, context) for item in node.items)
    if isinstance(node, Chain):
        v = EMPTY
        for e in node.exprs:
            v = eval_value(e, context)
        return EMPTY if node.trailing else v
    if isinstance(node, Assign):
        # the reference evaluates with an immutable context reference
        # (pfile.rs:93-97, eval_*_with_context &ctx): evalexpr rejects
        # every assignment there with ContextNotMutable
        raise ExprError(
            f"{node.op}: the context is immutable "
            "(evalexpr ContextNotMutable: assignments are not allowed "
            "in include/fstring expressions)"
        )
    raise ExprError(f"unknown AST node {node!r}")


def _apply_binary(op, a, b):
    if op == "==":
        return _values_equal(a, b)
    if op == "!=":
        return not _values_equal(a, b)
    if op in ("<", "<=", ">", ">="):
        if isinstance(a, str) and isinstance(b, str):
            pass  # lexicographic
        else:
            _numeric_pair(a, b, op)
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        return a >= b
    if op == "&&":
        return _expect_bool(a, "&&") and _expect_bool(b, "&&")
    if op == "||":
        return _expect_bool(a, "||") or _expect_bool(b, "||")
    if op == "+":
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        _numeric_pair(a, b, "+")
        return a + b
    if op == "-":
        _numeric_pair(a, b, "-")
        return a - b
    if op == "*":
        _numeric_pair(a, b, "*")
        return a * b
    if op == "/":
        _numeric_pair(a, b, "/")
        if _both_int(a, b):
            if b == 0:
                raise ExprError("division by zero")
            return int(a / b)  # truncate toward zero (Rust i64 division)
        if b == 0:
            return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)
        return a / b
    if op == "%":
        _numeric_pair(a, b, "%")
        if _both_int(a, b):
            if b == 0:
                raise ExprError("modulo by zero")
            return int(math.fmod(a, b))  # Rust % truncates toward zero
        return math.fmod(a, b)
    if op == "^":
        _numeric_pair(a, b, "^")
        return float(a) ** float(b)
    raise ExprError(f"unknown operator {op}")


_STR_FUNCS = {
    "str::to_lowercase": lambda s: s.lower(),
    "str::to_uppercase": lambda s: s.upper(),
    "str::trim": lambda s: s.strip(),
}


def _display(v) -> str:
    """str::from formatting: top-level strings stay raw (round-2 pinned
    behavior), booleans are true/false, floats keep their repr, tuples
    format as "(a, b)" with nested strings quoted, Empty is "()"."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, tuple):
        return "(" + ", ".join(_display_inner(x) for x in v) + ")"
    if v is EMPTY:
        return "()"
    return str(v)


def _display_inner(v) -> str:
    if isinstance(v, str):
        return '"' + v + '"'
    return _display(v)

# evalexpr's regex builtins are backed by the Rust `regex` crate; Python
# `re` covers the same common syntax (character classes, anchors,
# alternation, repetition). Differences only appear in exotic constructs
# (look-around is absent from BOTH engines).
def _regex_matches(s: str, pattern: str) -> bool:
    import re as _re

    try:
        return _re.search(pattern, s) is not None
    except _re.error as e:
        raise ExprError(f"str::regex_matches: invalid regex {pattern!r}: {e}")


def _regex_replace(s: str, pattern: str, repl: str) -> str:
    import re as _re

    try:
        return _re.sub(pattern, repl, s)
    except _re.error as e:
        raise ExprError(f"str::regex_replace: invalid regex {pattern!r}: {e}")


# ---- Rust f64 semantics for the math:: builtins -------------------------
# evalexpr backs math:: with Rust f64 methods, which return NaN/inf on
# domain violations instead of erroring (e.g. (-1.0).sqrt() is NaN,
# (0.0).ln() is -inf); Python's math module raises — these wrappers restore
# the Rust behavior.


def _rust_f(fn, *xs):
    try:
        return float(fn(*(float(x) for x in xs)))
    except ValueError:
        return math.nan
    except OverflowError:
        return math.inf


def _rust_log(x: float, ln_fn) -> float:
    x = float(x)
    if x == 0.0:
        return -math.inf
    if x < 0.0 or math.isnan(x):
        return math.nan
    return ln_fn(x)


def _rust_atanh(x: float) -> float:
    x = float(x)
    if x == 1.0:
        return math.inf
    if x == -1.0:
        return -math.inf
    return _rust_f(math.atanh, x)


def _rust_pow(x: float, y: float) -> float:
    x, y = float(x), float(y)
    if x == 0.0 and y < 0.0 and not math.isnan(y):
        return math.copysign(math.inf, 1.0 if not _neg_zero(x) else -1.0)
    return _rust_f(math.pow, x, y)


def _neg_zero(x: float) -> bool:
    return x == 0.0 and math.copysign(1.0, x) < 0


def _rust_round(x: float) -> float:
    # f64::round: nearest, ties away from zero (Python's round() is
    # banker's rounding — wrong parity here)
    x = float(x)
    if not math.isfinite(x):
        return x
    return math.copysign(math.floor(abs(x) + 0.5), x)


# one-arg math:: functions: name -> Rust-semantics float fn
_MATH_1 = {
    "math::ln": lambda x: _rust_log(x, math.log),
    "math::log2": lambda x: _rust_log(x, math.log2),
    "math::log10": lambda x: _rust_log(x, math.log10),
    "math::exp": lambda x: _rust_f(math.exp, x),
    "math::exp2": lambda x: _rust_f(lambda v: 2.0 ** v, x),
    "math::sqrt": lambda x: _rust_f(math.sqrt, x),
    "math::cbrt": lambda x: _rust_f(math.cbrt, x),
    "math::sin": lambda x: _rust_f(math.sin, x),
    "math::cos": lambda x: _rust_f(math.cos, x),
    "math::tan": lambda x: _rust_f(math.tan, x),
    "math::asin": lambda x: _rust_f(math.asin, x),
    "math::acos": lambda x: _rust_f(math.acos, x),
    "math::atan": lambda x: _rust_f(math.atan, x),
    "math::sinh": lambda x: _rust_f(math.sinh, x),
    "math::cosh": lambda x: _rust_f(math.cosh, x),
    "math::tanh": lambda x: _rust_f(math.tanh, x),
    "math::asinh": lambda x: _rust_f(math.asinh, x),
    "math::acosh": lambda x: _rust_f(math.acosh, x),
    "math::atanh": _rust_atanh,
}

# one-arg math:: predicates: Boolean results
_MATH_PRED = {
    "math::is_nan": lambda x: math.isnan(float(x)),
    "math::is_finite": lambda x: math.isfinite(float(x)),
    "math::is_infinite": lambda x: math.isinf(float(x)),
    "math::is_normal": lambda x: (
        math.isfinite(float(x))
        and float(x) != 0.0
        and abs(float(x)) >= 2.2250738585072014e-308  # f64::MIN_POSITIVE
    ),
}

_I64_MASK = (1 << 64) - 1


def _as_i64(v, name):
    if not isinstance(v, int) or isinstance(v, bool):
        raise ExprError(f"{name}: expected Int, got {_type_name(v)}")
    return v


def _wrap_i64(v: int) -> int:
    v &= _I64_MASK
    return v - (1 << 64) if v >= (1 << 63) else v


def _call_builtin(name, args):
    if name == "len":
        (v,) = _arity(name, args, 1)
        if isinstance(v, str):
            return len(v)
        if isinstance(v, tuple):
            return len(v)
        raise ExprError(f"len: expected String or Tuple, got {_type_name(v)}")
    if name in _STR_FUNCS:
        (v,) = _arity(name, args, 1)
        if not isinstance(v, str):
            raise ExprError(f"{name}: expected String, got {_type_name(v)}")
        return _STR_FUNCS[name](v)
    if name in ("min", "max"):
        if not args:
            raise ExprError(f"{name}: expected at least one argument")
        for v in args:
            if not _is_num(v):
                raise ExprError(f"{name}: expected numbers, got {_type_name(v)}")
        return min(args) if name == "min" else max(args)
    if name == "str::from":
        (v,) = _arity(name, args, 1)
        return _display(v)
    if name == "contains":
        a, b = _arity(name, args, 2)
        if isinstance(a, str) and isinstance(b, str):
            return b in a
        if isinstance(a, tuple):
            # evalexpr: tuple membership, variant-tagged equality
            return any(_values_equal(x, b) for x in a)
        raise ExprError(
            "contains: expected (String, String) or (Tuple, value), got "
            f"({_type_name(a)}, {_type_name(b)})"
        )
    if name == "contains_any":
        a, b = _arity(name, args, 2)
        if not isinstance(b, tuple):
            raise ExprError(
                f"contains_any: expected a Tuple of candidates, got "
                f"{_type_name(b)}"
            )
        if isinstance(a, str):
            # any candidate substring occurs in the string
            for cand in b:
                if not isinstance(cand, str):
                    raise ExprError(
                        "contains_any: String haystack needs String "
                        f"candidates, got {_type_name(cand)}"
                    )
                if cand in a:
                    return True
            return False
        if isinstance(a, tuple):
            return any(
                any(_values_equal(x, y) for y in b) for x in a
            )
        raise ExprError(
            f"contains_any: expected String or Tuple, got {_type_name(a)}"
        )
    if name == "typeof":
        (v,) = _arity(name, args, 1)
        return _type_name(v).lower()
    if name == "str::regex_matches":
        a, b = _arity(name, args, 2)
        if isinstance(a, str) and isinstance(b, str):
            return _regex_matches(a, b)
        raise ExprError("str::regex_matches: expected two Strings")
    if name == "str::regex_replace":
        a, b, c = _arity(name, args, 3)
        if all(isinstance(x, str) for x in (a, b, c)):
            return _regex_replace(a, b, c)
        raise ExprError("str::regex_replace: expected three Strings")
    if name == "str::substring":
        a, b, c = _arity(name, args, 3)
        if isinstance(a, str) and _is_num(b) and _is_num(c):
            return a[int(b) : int(c)]
        raise ExprError("str::substring: expected (String, Int, Int)")
    if name in ("math::abs", "abs"):
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return abs(v)
        raise ExprError(f"{name}: expected a number")
    if name == "floor":
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return float(math.floor(v))
        raise ExprError("floor: expected a number")
    if name == "ceil":
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return float(math.ceil(v))
        raise ExprError("ceil: expected a number")
    if name == "round":
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return _rust_round(v)
        raise ExprError("round: expected a number")
    if name in _MATH_1:
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return _MATH_1[name](v)
        raise ExprError(f"{name}: expected a number, got {_type_name(v)}")
    if name in _MATH_PRED:
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return _MATH_PRED[name](v)
        raise ExprError(f"{name}: expected a number, got {_type_name(v)}")
    if name == "math::log":
        a, b = _arity(name, args, 2)
        if _is_num(a) and _is_num(b):
            # f64::log(self, base) = self.ln() / base.ln() in Rust, with
            # IEEE division (0/0 and inf/inf are NaN, x/0 is signed inf)
            num = _rust_log(a, math.log)
            den = _rust_log(b, math.log)
            if math.isnan(num) or math.isnan(den):
                return math.nan
            if den == 0.0:
                return math.nan if num == 0.0 else math.copysign(
                    math.inf, num
                ) * math.copysign(1.0, den)
            if math.isinf(num) and math.isinf(den):
                return math.nan
            return num / den
        raise ExprError("math::log: expected two numbers")
    if name == "math::pow":
        a, b = _arity(name, args, 2)
        if _is_num(a) and _is_num(b):
            return _rust_pow(a, b)
        raise ExprError("math::pow: expected two numbers")
    if name == "math::hypot":
        a, b = _arity(name, args, 2)
        if _is_num(a) and _is_num(b):
            return _rust_f(math.hypot, a, b)
        raise ExprError("math::hypot: expected two numbers")
    if name == "math::atan2":
        a, b = _arity(name, args, 2)
        if _is_num(a) and _is_num(b):
            return _rust_f(math.atan2, a, b)
        raise ExprError("math::atan2: expected two numbers")
    if name in ("bitand", "bitor", "bitxor"):
        a, b = _arity(name, args, 2)
        a, b = _as_i64(a, name), _as_i64(b, name)
        if name == "bitand":
            return _wrap_i64(a & b)
        if name == "bitor":
            return _wrap_i64(a | b)
        return _wrap_i64(a ^ b)
    if name == "bitnot":
        (v,) = _arity(name, args, 1)
        return _wrap_i64(~_as_i64(v, name))
    if name in ("shl", "shr"):
        a, b = _arity(name, args, 2)
        a, b = _as_i64(a, name), _as_i64(b, name)
        if b < 0 or b >= 64:
            raise ExprError(f"{name}: shift amount {b} out of range for i64")
        if name == "shl":
            return _wrap_i64(a << b)
        return a >> b  # Python >> on ints is arithmetic, like Rust i64
    if name == "num":
        # extension: parse a string to Int (preferred) or Float; the
        # reference has no numeric typing at all (README.md:279-280)
        (v,) = _arity(name, args, 1)
        if _is_num(v):
            return v
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                pass
            try:
                return float(v)
            except ValueError:
                raise ExprError(f"num: cannot parse {v!r} as a number") from None
        raise ExprError(f"num: expected String or number, got {_type_name(v)}")
    if name == "if":
        c, t, f = _arity(name, args, 3)
        if not isinstance(c, bool):
            raise ExprError("if: expected Boolean condition")
        return t if c else f
    if name == "in_list":
        # extension: set membership against a comma-separated list literal,
        # vectorized to one np.isin pass by the compiler (query/compile.py)
        # — the backbone of --regions-file over large position lists. A
        # String needle matches list items verbatim; a numeric needle
        # parses each item with num() rules and equality stays
        # variant-tagged like == (Int never equals Float).
        v, lst = _arity(name, args, 2)
        if not isinstance(lst, str):
            raise ExprError(f"in_list: expected a String list, got {_type_name(lst)}")
        items = lst.split(",")
        if isinstance(v, str):
            return v in items
        if _is_num(v) and not isinstance(v, bool):
            for item in items:
                try:
                    parsed = _call_builtin("num", [item])
                except ExprError:
                    continue
                if isinstance(parsed, type(v)) and parsed == v:
                    return True
            return False
        raise ExprError(f"in_list: expected String or number, got {_type_name(v)}")
    if name in ("dup_first_within", "dup_unique_within"):
        # whole-column duplicate-group builtins exist only in the
        # vectorized compiler (query/compile.py); a row at a time there
        # is no duplicate group to consult
        raise ExprError(
            f"{name}: whole-column builtin is unavailable in row-exact "
            "evaluation; it composes only with vectorizable (or "
            "&&/||-sibling) subexpressions"
        )
    raise ExprError(f"function identifier is not bound: {name}")


def _arity(name, args, n):
    if len(args) != n:
        raise ExprError(f"{name}: expected {n} argument(s), got {len(args)}")
    return args


def eval_boolean(expr, context: dict) -> bool:
    """Evaluate ``expr`` (string or AST) to a boolean, erroring on any other
    result type (evalexpr eval_boolean_with_context parity, pfile.rs:328)."""
    node = parse(expr) if isinstance(expr, str) else expr
    v = eval_value(node, context)
    if not isinstance(v, bool):
        raise ExprError(f"expected Boolean result, got {_type_name(v)}")
    return v


def eval_string(expr, context: dict) -> str:
    """Evaluate ``expr`` to a string, erroring on any other result type
    (evalexpr eval_string_with_context parity, pfile.rs:97)."""
    node = parse(expr) if isinstance(expr, str) else expr
    v = eval_value(node, context)
    if not isinstance(v, str):
        raise ExprError(f"expected String result, got {_type_name(v)}")
    return v
