"""Byte-exact VCF assembly helpers.

Header layout replicated from the reference VCF writer
(pgen-rs/src/pfile.rs:136-146):

    ##fileformat=VCFv4.2\n
    ##source=pgen-rs\n          <- frozen to the reference tag so output is
                                   byte-identical (BASELINE.md correctness
                                   target); override via source_tag
    {pvar '#' comment lines, verbatim, except the last}
    {last pvar '#' line, trimmed}\tFORMAT\t{kept IIDs joined by \t}\n

Body rows (pfile.rs:156-191): each kept pvar row's columns joined by tabs,
then "\tGT", then "\t"+token per kept sample, then "\n". Because the
metadata loader keeps raw line bytes, the per-row prefix is exactly
``raw_pvar_line + b"\tGT"``.

Copied from ``pgen_tpu/pipeline/vcf.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

VCF_FILEFORMAT = "##fileformat=VCFv4.2\n"
DEFAULT_SOURCE_TAG = "pgen-rs"


def vcf_header_bytes(pvar_table, sample_ids, source_tag: str = DEFAULT_SOURCE_TAG) -> bytes:
    """Assemble the full VCF header block."""
    parts = [
        VCF_FILEFORMAT,
        f"##source={source_tag}\n",
        pvar_table.comments,
        pvar_table.header_line.strip(),
        "\tFORMAT\t",
        "\t".join(sample_ids),
        "\n",
    ]
    return "".join(parts).encode("utf-8")


def emit_rows_numpy(
    packed: np.ndarray,
    prefix_buf: np.ndarray,
    prefix_off: np.ndarray,
    sample_idx,
    n_samples: int,
    out: np.ndarray,
) -> int:
    """Pure-numpy row emission fallback (native/lib.py unavailable).

    Behavior-identical to pgen_native.pgen_emit_vcf_rows_buf; used in tests
    as an independent oracle and as the no-toolchain fallback.
    """
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_reference

    n_var = len(prefix_off) - 1
    if n_var == 0:
        return 0
    table = np.frombuffer(b"\t0/0\t0/1\t1/1\t./.", dtype=np.uint8).reshape(4, 4)
    codes = unpack_codes_reference(packed, int(packed.shape[1] * 4))
    if sample_idx is not None:
        codes = codes[:, sample_idx]
    else:
        codes = codes[:, :n_samples]
    text = table[codes].reshape(n_var, -1)  # (n_var, 4*kept)
    gt_len = text.shape[1]
    plens = np.diff(prefix_off)
    row_lens = plens + gt_len + 1
    out_off = np.zeros(n_var + 1, dtype=np.int64)
    np.cumsum(row_lens, out=out_off[1:])
    total = int(out_off[-1])
    if total > out.nbytes:
        raise ValueError("output buffer too small")
    # prefixes: ragged scatter
    rows = np.repeat(np.arange(n_var), plens)
    src_pos = np.arange(int(prefix_off[-1]), dtype=np.int64)
    dst_pos = out_off[rows] + (src_pos - prefix_off[rows])
    out[dst_pos] = prefix_buf
    # genotype text: fixed-length rows, chunked fancy index
    gstart = out_off[:-1] + plens
    chunk = max(1, (64 << 20) // max(gt_len * 8, 1))
    for lo in range(0, n_var, chunk):
        hi = min(lo + chunk, n_var)
        idx = gstart[lo:hi, None] + np.arange(gt_len, dtype=np.int64)[None, :]
        out[idx] = text[lo:hi]
    out[out_off[1:] - 1] = ord("\n")
    return total
