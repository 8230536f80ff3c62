"""The port's device predicate lowering (pgen_tpu_torch.query.compile_device)
against pgen_tpu's (query/compile_device.py, jax on the CPU), its host
compiler and its row interpreter (query/interp.py).

Columns are zero-padded (rows, width) byte matrices, as
``MetadataTable.get_column_padded`` gives them; the port runs on CPU
tensors. Masks must be equal, and every expression must have the same
outcome in both packages: a mask, DeviceFallback, or ExprError.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.query import ExprError, compile_predicate, parse
from pgen_tpu.query import compile_device as jax_lowering
from pgen_tpu.query.interp import eval_boolean
from pgen_tpu_torch.query import ExprError as PortExprError
from pgen_tpu_torch.query import parse as port_parse
from pgen_tpu_torch.query.compile_device import (
    DeviceFallback,
    columns_to_device,
    compile_predicate_device,
    lower_device,
)
from test_expr import DEVICE_EXPRS


@pytest.fixture()
def table(tmp_path):
    """test_expr.py's table: 200 rows of seeded ALT and POS values."""
    rng = np.random.default_rng(5)
    alts = rng.choice(["A", "C", "G", "T"], 200)
    pos = rng.integers(1, 120, 200)
    rows = "".join(f"1\t{pos[i]}\trs{i % 17}\tA\t{alts[i]}\n" for i in range(200))
    p = tmp_path / "t.pvar"
    p.write_text("#CHROM\tPOS\tID\tREF\tALT\n" + rows)
    return read_metadata(p)


def _outcome(fn):
    """('mask', bool array) | ('fallback', None) | ('error', None); an
    ExprError of either package (the port has its own copy of the class)."""
    try:
        return "mask", np.asarray(fn()).astype(bool)
    except (DeviceFallback, jax_lowering.DeviceFallback):
        return "fallback", None
    except (ExprError, PortExprError):
        return "error", None


def _same(a, b):
    assert a[0] == b[0]
    if a[0] == "mask":
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("expr", DEVICE_EXPRS)
def test_lowering_matches_pgen_tpu_and_host(table, expr):
    got = compile_predicate_device(expr, table, "cpu")
    assert got.dtype == torch.bool and got.shape == (table.num_rows,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_lowering.compile_predicate_device(expr, table)))
    np.testing.assert_array_equal(got.numpy(), compile_predicate(expr, table))


def test_default_device_is_the_card(table, monkeypatch):
    """Without a device, compile_predicate_device runs on the card, as
    pgen_tpu's runs on its default device: on a machine without CUDA the
    call raises, and nothing is lowered on the CPU."""
    import pgen_tpu_torch.query.compile_device as port_lowering

    def lowered(*args):
        raise AssertionError("lowered without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_lowering, "lower_device", lowered)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        compile_predicate_device('ALT == "G"', table)


OUTSIDE = [
    ('len(ID) == 3', "fallback"),  # builtin call
    ('num(POS) < 50', "fallback"),  # the -r region form
    ('CHROM + POS == "17"', "fallback"),  # operator +
    ('-POS == "1"', "fallback"),  # unary minus
    ('true && ALT', "fallback"),  # && with a non-Boolean operand
    ('(ALT == "G") || POS', "fallback"),
    ('(ALT == "G") == true', "fallback"),  # equality of a mask
    ('(ALT == "G") < "x"', "fallback"),  # ordering of a mask
    ('GT_AC > 3', "error"),  # not a column: unbound
    ('POS < 50', "error"),  # String against Int
    ('7 > ALT', "error"),
    ('ALT', "error"),  # a String result
    ('"x"', "error"),
    ('7', "error"),
    ('ALT == true', "mask"),  # cross-type ==: all false
    ('POS != 7.5', "mask"),
    ('ALT == "GGGGGGGGGGGG"', "mask"),  # longer than the column: all false
    ('ALT < "GGGGGGGGGGGG"', "mask"),  # longer than the column: wider compare
    ('"GGGGGGGGGGGG" <= ALT', "mask"),
    ('true', "mask"),
    ('!(true && false) && ID != ""', "mask"),
    ('!(ALT == "G") || POS >= REF', "mask"),
]


@pytest.mark.parametrize("expr,kind", OUTSIDE)
def test_same_outcome_as_pgen_tpu(table, expr, kind):
    names = {"CHROM", "POS", "ID", "REF", "ALT"}
    np_cols = {n: table.get_column_padded(n) for n in names}
    node = parse(expr)
    port = _outcome(lambda: lower_device(port_parse(expr), columns_to_device(np_cols, "cpu")))
    jax_cols = {n: (jax_lowering.jnp.asarray(m), jax_lowering.jnp.asarray(ln)) for n, (m, ln) in np_cols.items()}
    want = _outcome(lambda: jax_lowering.lower_device(node, jax_cols))
    assert port[0] == kind
    _same(port, want)
    if kind == "mask":
        np.testing.assert_array_equal(port[1], compile_predicate(expr, table))


def test_no_column_variable_falls_back(table):
    with pytest.raises(DeviceFallback):
        compile_predicate_device('"a" == "a"', table, "cpu")


# -- property test against the row interpreter ----------------------------

_VALUES = ["", "a", "b", "ab", "ba", "abc", "abd", "b a", "zz", "~", "é"]
_LITERALS = _VALUES + ["abcdefghijkl"]  # wider than any column


def _padded(values):
    b = [v.encode("utf-8") for v in values]
    width = max(max(len(x) for x in b), 1)
    mat = np.zeros((len(b), width), dtype=np.uint8)
    for i, x in enumerate(b):
        mat[i, : len(x)] = np.frombuffer(x, dtype=np.uint8)
    return mat, np.array([len(x) for x in b], dtype=np.int32)


_atom = st.one_of(
    st.sampled_from(["A", "B"]),
    st.sampled_from(_LITERALS).map(lambda s: f'"{s}"'),
    st.sampled_from(["7", "true", "false"]),
)
_cmp = st.tuples(_atom, st.sampled_from(["==", "!=", "<", "<=", ">", ">="]), _atom).map(
    lambda t: f"{t[0]} {t[1]} {t[2]}"
)
_expr = st.recursive(
    _cmp,
    lambda inner: st.one_of(
        inner.map(lambda e: f"!({e})"),
        st.tuples(inner, st.sampled_from(["&&", "||"]), inner).map(lambda t: f"({t[0]}) {t[1]} ({t[2]})"),
    ),
    max_leaves=4,
)


@settings(max_examples=150, deadline=None)
@given(
    a=st.lists(st.sampled_from(_VALUES), min_size=1, max_size=12),
    b_extra=st.lists(st.sampled_from(_VALUES[:4]), min_size=0, max_size=12),
    expr=_expr,
)
def test_lowering_matches_interpreter(a, b_extra, expr):
    """Random columns A and B of unequal widths (B narrower, empty strings
    included) and random comparisons of columns and literals, Boolean
    combined: a lowered mask equals the interpreter row by row; an ExprError
    of the lowering is one the interpreter raises too."""
    b = (b_extra + a)[: len(a)]
    b = [v[:2] for v in b]
    np_cols = {"A": _padded(a), "B": _padded(b)}
    node = parse(expr)
    port = _outcome(lambda: lower_device(port_parse(expr), columns_to_device(np_cols, "cpu")))
    jax_cols = {n: (jax_lowering.jnp.asarray(m), jax_lowering.jnp.asarray(ln)) for n, (m, ln) in np_cols.items()}
    _same(port, _outcome(lambda: jax_lowering.lower_device(node, jax_cols)))
    rows = [{"A": x, "B": y} for x, y in zip(a, b)]
    if port[0] == "mask":
        assert port[1].tolist() == [eval_boolean(node, r) for r in rows]
    elif port[0] == "error":
        with pytest.raises(ExprError):
            for r in rows:
                eval_boolean(node, r)


@pytest.mark.parametrize("expr", ['!(true && true) || ALT == "G"', '!(true || false) || ID == "rs3"'])
def test_negated_constant_lowers_to_a_mask(table, expr):
    """`!` of a constant combination is a Boolean. pgen_tpu's lowering
    applies `~` to the Python bool there (~True == -2), so its result is an
    int array in which every row is non-zero; the port's equals the host
    compiler's mask."""
    got = compile_predicate_device(expr, table, "cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), compile_predicate(expr, table))
    assert 0 < got.sum() < table.num_rows
    assert np.asarray(jax_lowering.compile_predicate_device(expr, table)).dtype != np.bool_
