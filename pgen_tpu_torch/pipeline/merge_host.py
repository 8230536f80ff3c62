"""The host half of ``pgen_tpu/pipeline/merge.py``, copied: the error and
result types and the ``.psam`` line reader. Only the imports differ. Left
out: ``_codecs`` (pgen_tpu's host 2-bit codecs) and ``merge_pgen``; the
port's is ``pipeline/merge.py``, which splices on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

from pgen_tpu_torch.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16


class MergeError(ValueError):
    """Inputs cannot be merged."""


@dataclass
class MergeResult:
    out_prefix: str
    num_variants: int
    num_samples: int
    num_inputs: int
    timer: StageTimer


def _psam_lines(path: str) -> tuple:
    """(column line, data lines) of a .psam (comments before the last #
    line are preserved only from the first input)."""
    column = None
    rows = []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\n")
            if line.startswith(b"#"):
                column = line
            elif line:
                rows.append(line)
    if column is None:
        raise MergeError(f"{path}: no # column header line")
    return column, rows
