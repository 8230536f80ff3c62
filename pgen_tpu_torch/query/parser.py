"""Tokenizer + Pratt parser for the evalexpr-compatible expression subset.

Grammar (operators and precedences mirror evalexpr v11.3.0, the engine the
reference embeds — pgen-rs/Cargo.toml:13-15, README.md:268-280):

    ;              0   chain (value = last expr; trailing ; -> Empty)
    , (aggregation) 40 left (flat tuples; parenthesized tuples nest)
    = += -= *= /= %= ^= &&= ||=  50  (always an eval-time error here:
                                      the reference's context is immutable)
    ||            70   left
    &&            75   left
    == != < <= > >= 80 left
    + -           95   left
    * / %        100   left
    prefix ! -   110
    ^            120   right

Literals: double-quoted strings (``\\`` and ``\"`` escapes), integers,
floats, ``true``/``false``. Identifiers are variables; ``name(...)`` and
namespaced ``str::name(...)`` are function calls (the argument list is
evalexpr-style: one expression, a tuple aggregation fans out to args).

Copied from ``pgen_tpu/query/parser.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from pgen_tpu_torch.query.ast import (
    EMPTY,
    Assign,
    Binary,
    Call,
    Chain,
    Lit,
    ParseError,
    TupleExpr,
    Unary,
    Var,
)

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:::[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<op>&&=|\|\|=|\|\||&&|==|!=|<=|>=|[+\-*/%^]=|[<>+\-*/%^!()=;])
  | (?P<comma>,)
  | (?P<quote>")
    """,
    re.VERBOSE,
)

_ASSIGN_OPS = frozenset(
    ("=", "+=", "-=", "*=", "/=", "%=", "^=", "&&=", "||=")
)

_BIN_PRECEDENCE = {
    ",": 40,
    **{op: 50 for op in _ASSIGN_OPS},
    "||": 70,
    "&&": 75,
    "==": 80,
    "!=": 80,
    "<": 80,
    "<=": 80,
    ">": 80,
    ">=": 80,
    "+": 95,
    "-": 95,
    "*": 100,
    "/": 100,
    "%": 100,
    "^": 120,
}
_PREFIX_PRECEDENCE = 110


@dataclass
class _Tok:
    kind: str  # 'lit' | 'ident' | 'op' | ',' | '(' | ')'
    value: object
    pos: int


def _lex_string(src: str, start: int):
    """Lex a double-quoted string starting at the opening quote."""
    out = []
    i = start + 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= n:
                raise ParseError(f"unterminated escape at {i}")
            esc = src[i + 1]
            mapped = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r", "'": "'"}.get(esc)
            if mapped is None:
                raise ParseError(
                    f"unsupported escape '\\{esc}' at {i} (write '\\\\{esc}' "
                    f"for a literal backslash, e.g. in regex patterns)"
                )
            out.append(mapped)
            i += 2
        else:
            out.append(c)
            i += 1
    raise ParseError(f"unterminated string literal starting at {start}")


def tokenize(src: str) -> list:
    toks = []
    i = 0
    n = len(src)
    while i < n:
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise ParseError(f"unexpected character {src[i]!r} at {i} in {src!r}")
        if m.lastgroup == "ws":
            i = m.end()
            continue
        if m.lastgroup == "quote":
            text, end = _lex_string(src, i)
            toks.append(_Tok("lit", text, i))
            i = end
            continue
        text = m.group()
        if m.lastgroup == "float":
            toks.append(_Tok("lit", float(text), i))
        elif m.lastgroup == "int":
            toks.append(_Tok("lit", int(text), i))
        elif m.lastgroup == "ident":
            if text == "true":
                toks.append(_Tok("lit", True, i))
            elif text == "false":
                toks.append(_Tok("lit", False, i))
            else:
                toks.append(_Tok("ident", text, i))
        elif m.lastgroup == "comma":
            toks.append(_Tok(",", text, i))
        else:  # op
            kind = text if text in "()" else "op"
            toks.append(_Tok(kind, text, i))
        i = m.end()
    return toks


class _Parser:
    def __init__(self, toks, src):
        self.toks = toks
        self.src = src
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise ParseError(f"unexpected end of expression: {self.src!r}")
        self.i += 1
        return tok

    def expect(self, kind):
        tok = self.next()
        if tok.kind != kind:
            raise ParseError(f"expected {kind!r}, got {tok.value!r} at {tok.pos}")
        return tok

    def parse_expr(self, min_bp=0):
        left = self.parse_prefix()
        while True:
            tok = self.peek()
            if (
                tok is None
                or tok.kind not in ("op", ",")
                or tok.value not in _BIN_PRECEDENCE
            ):
                break
            bp = _BIN_PRECEDENCE[tok.value]
            if bp < min_bp:
                break
            self.next()
            if tok.value == ",":
                # aggregation: a bare comma chain builds ONE flat tuple;
                # a parenthesized tuple on the left nests instead
                right = self.parse_expr(bp + 1)
                if isinstance(left, TupleExpr) and not left.grouped:
                    left = TupleExpr(left.items + (right,))
                else:
                    left = TupleExpr((left, right))
                continue
            if tok.value in _ASSIGN_OPS:
                # right-associative; always an eval-time error against the
                # immutable filter/query context (evalexpr parity)
                right = self.parse_expr(bp)
                left = Assign(tok.value, left, right)
                continue
            # '^' is right-associative; everything else is left-associative.
            next_bp = bp if tok.value == "^" else bp + 1
            right = self.parse_expr(next_bp)
            left = Binary(tok.value, left, right)
        return left

    def parse_prefix(self):
        tok = self.next()
        if tok.kind == "lit":
            return Lit(tok.value)
        if tok.kind == "ident":
            nxt = self.peek()
            if nxt is not None and nxt.kind == "(":
                self.next()
                # evalexpr-style argument: ONE expression; a bare tuple
                # aggregation fans out into the argument list, while a
                # parenthesized tuple stays one (tuple-valued) argument
                if self.peek() is not None and self.peek().kind == ")":
                    self.next()
                    return Call(tok.value, ())
                inner = self.parse_expr(0)
                self.expect(")")
                if isinstance(inner, TupleExpr) and not inner.grouped:
                    return Call(tok.value, inner.items)
                return Call(tok.value, (inner,))
            return Var(tok.value)
        if tok.kind == "(":
            if self.peek() is not None and self.peek().kind == ")":
                self.next()
                return Lit(EMPTY)  # evalexpr '()' is the Empty value
            inner = self.parse_expr(0)
            self.expect(")")
            if isinstance(inner, TupleExpr):
                inner = TupleExpr(inner.items, grouped=True)
            return inner
        if tok.kind == "op" and tok.value == "!":
            return Unary("!", self.parse_expr(_PREFIX_PRECEDENCE))
        if tok.kind == "op" and tok.value == "-":
            return Unary("neg", self.parse_expr(_PREFIX_PRECEDENCE))
        raise ParseError(f"unexpected token {tok.value!r} at {tok.pos}")


def parse(src: str):
    """Parse an expression string into an AST. A top-level ``;`` chains
    expressions (evalexpr): the chain's value is the last expression's,
    or Empty when the source ends with ``;``."""
    parser = _Parser(tokenize(src), src)
    exprs = [parser.parse_expr(0)]
    trailing_semi = False
    while True:
        tok = parser.peek()
        if tok is None:
            break
        if tok.kind == "op" and tok.value == ";":
            parser.next()
            if parser.peek() is None:
                trailing_semi = True
                break
            exprs.append(parser.parse_expr(0))
            continue
        raise ParseError(
            f"unexpected trailing token {tok.value!r} at {tok.pos} in {src!r}"
        )
    if len(exprs) == 1 and not trailing_semi:
        return exprs[0]
    return Chain(tuple(exprs), trailing=trailing_semi)
