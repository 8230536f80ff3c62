"""The expression engine of include-expressions, copied from
``pgen_tpu/query/`` (each module names its source), and the port's own
predicate lowering to torch ops, ``compile_device.py``."""

from pgen_tpu_torch.query.ast import Binary, Call, ExprError, Lit, ParseError, Unary, Var
from pgen_tpu_torch.query.parser import parse
from pgen_tpu_torch.query.interp import eval_boolean, eval_string, eval_value
from pgen_tpu_torch.query.compile import compile_predicate, compile_fstring

__all__ = [
    "parse",
    "eval_boolean",
    "eval_string",
    "eval_value",
    "compile_predicate",
    "compile_fstring",
    "ExprError",
    "ParseError",
    "Lit",
    "Var",
    "Unary",
    "Binary",
    "Call",
]
