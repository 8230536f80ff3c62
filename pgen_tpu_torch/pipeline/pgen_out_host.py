"""The host half of ``pgen_tpu/pipeline/pgen_out.py``, copied: the result
type and the kept-row ``.pvar``/``.psam`` writer. Only the imports
differ. Left out: ``_subset_block`` (its device branch runs jax) and
``filter_to_pgen``; the port's is ``pipeline/pgen_out.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from pgen_tpu_torch.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16


@dataclass
class PgenFilterResult:
    out_prefix: str
    num_variants_kept: int
    num_samples_kept: int
    timer: StageTimer


def _write_meta_subset(src_table, idx, out_path, include_comments=True):
    """Write kept metadata rows byte-exactly (comments + header + rows)."""
    starts, ends = src_table.row_line_spans()
    with open(out_path, "wb") as f:
        if include_comments:
            f.write(src_table.comments.encode("utf-8"))
        f.write(src_table.header_line.encode("utf-8"))
        f.write(b"\n")
        buf = src_table.data_buffer
        for i in idx:
            f.write(buf[starts[i] : ends[i]].tobytes())
            f.write(b"\n")
