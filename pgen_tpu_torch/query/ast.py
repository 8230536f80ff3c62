"""AST and error types for the pgen_tpu expression language.

The language replicates the subset of the ``evalexpr`` crate (v11.3.0) the
reference exposes for ``-i/--include``, ``--include-var``, ``--include-sam``
and ``-f/--fstring`` (pgen-rs/src/pfile.rs:93-97,321-329;
README.md:268-280). Value model: String / Int / Float / Boolean; every
metadata variable is a String (pfile.rs:88-92 sets all columns as
Value::String).

Copied from ``pgen_tpu/query/ast.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from dataclasses import dataclass


class ExprError(ValueError):
    """Runtime expression evaluation error (evalexpr EvalexprError parity)."""


class _Empty:
    """evalexpr Value::Empty singleton: the value of ``()`` and of a
    ``;``-terminated expression chain."""

    __slots__ = ()

    def __repr__(self):
        return "()"


EMPTY = _Empty()


class ParseError(ExprError):
    """Expression syntax error."""


@dataclass(frozen=True)
class Lit:
    """Literal: str, int, float, or bool (Python-typed)."""

    value: object


@dataclass(frozen=True)
class Var:
    name: str


@dataclass(frozen=True)
class Unary:
    op: str  # '!' or 'neg'
    operand: object


@dataclass(frozen=True)
class Binary:
    op: str  # one of || && == != < <= > >= + - * / % ^
    left: object
    right: object


@dataclass(frozen=True)
class Call:
    name: str  # e.g. 'min', 'len', 'str::to_lowercase'
    args: tuple


@dataclass(frozen=True)
class TupleExpr:
    """evalexpr tuple aggregation: ``a, b, c``. ``grouped`` marks a
    parenthesized tuple so a following ``,`` nests instead of flattening
    (``(1, 2), 3`` is a 2-tuple whose head is a 2-tuple)."""

    items: tuple
    grouped: bool = False


@dataclass(frozen=True)
class Chain:
    """evalexpr ``;`` expression chain: value = last expression's value,
    or Empty when the chain ends with ``;``."""

    exprs: tuple
    trailing: bool = False


@dataclass(frozen=True)
class Assign:
    """Assignment operator (``= += -= *= /= %= ^= &&= ||=``). The
    reference evaluates against an immutable context reference
    (pgen-rs/src/pfile.rs:93-97), where evalexpr rejects every
    assignment at eval time — so this node always errors when evaluated."""

    op: str
    target: object  # usually Var; anything else errors like evalexpr
    value: object


def walk(node):
    """Yield every node in the expression tree."""
    yield node
    if isinstance(node, Unary):
        yield from walk(node.operand)
    elif isinstance(node, Binary):
        yield from walk(node.left)
        yield from walk(node.right)
    elif isinstance(node, Call):
        for a in node.args:
            yield from walk(a)
    elif isinstance(node, TupleExpr):
        for a in node.items:
            yield from walk(a)
    elif isinstance(node, Chain):
        for a in node.exprs:
            yield from walk(a)
    elif isinstance(node, Assign):
        yield from walk(node.target)
        yield from walk(node.value)


def variables(node) -> set:
    """Set of variable names referenced by the expression."""
    return {n.name for n in walk(node) if isinstance(n, Var)}
