"""`pgen-tpu concat`: variant-axis concatenation of pgen filesets.

The bcftools-concat analog for .pgen triples (the reference has no
multi-file operations at all). With identical sample columns, mode-0x02
records are position-independent fixed-width rows, so concatenation is
pure byte-streaming:

  .pgen  12-byte header with the summed variant count, then every input's
         record bytes in argument order (no re-coding)
  .pvar  first input's comments + column line verbatim, then all inputs'
         data rows in order (later inputs' comments dropped — they
         describe the same fileset family)
  .psam  first input's, verbatim

Inputs must agree on the sample axis: same IID sequence (the identity the
engine keys on) and same .pvar column line. Fail-fast otherwise.

Inverse of region/shard splitting: `filter --out-format pgen -r ...` per
range, then concat, reproduces the original .pgen bytes (tested).

Copied from ``pgen_tpu/pipeline/concat.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import shutil
import struct
from dataclasses import dataclass

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    read_pgen_header,
)
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.utils.timer import StageTimer


class ConcatError(ValueError):
    """Inputs cannot be concatenated."""


@dataclass
class ConcatResult:
    out_prefix: str
    num_variants: int
    num_samples: int
    num_inputs: int
    timer: StageTimer


def _pvar_header_parts(path: str) -> tuple:
    """(comment block bytes, column line bytes) of a .pvar."""
    comments = []
    column = None
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"##"):
                comments.append(line)
            elif line.startswith(b"#"):
                column = line
            else:
                break
    if column is None:
        raise ConcatError(f"{path}: no # column header line")
    return b"".join(comments), column


def concat_pgen(prefixes: list, out_prefix: str) -> ConcatResult:
    """Concatenate the filesets at `prefixes` into OUT_PREFIX.{pgen,pvar,psam}."""
    if len(prefixes) < 1:
        raise ConcatError("need at least one input prefix")
    timer = StageTimer()

    with timer.stage("validate"):
        headers = [read_pgen_header(f"{p}.pgen") for p in prefixes]
        n_samples = headers[0].num_samples
        for h in headers[1:]:
            if h.num_samples != n_samples:
                raise ConcatError(
                    f"{h.path}: {h.num_samples} samples != {n_samples} "
                    f"({headers[0].path}); concat needs one sample set"
                )
        iids0 = read_metadata(f"{prefixes[0]}.psam").get_column_strs("IID")
        for p in prefixes[1:]:
            if read_metadata(f"{p}.psam").get_column_strs("IID") != iids0:
                raise ConcatError(
                    f"{p}.psam: IID sequence differs from {prefixes[0]}.psam"
                )
        comments0, column0 = _pvar_header_parts(f"{prefixes[0]}.pvar")
        for p in prefixes[1:]:
            if _pvar_header_parts(f"{p}.pvar")[1] != column0:
                raise ConcatError(
                    f"{p}.pvar: column line differs from {prefixes[0]}.pvar"
                )
        for p, h in zip(prefixes, headers):
            n_rows = len(read_metadata(f"{p}.pvar").row_line_spans()[0])
            if n_rows != h.num_variants:
                raise ConcatError(
                    f"{p}.pvar: {n_rows} data rows != {h.num_variants} "
                    f"variants in the .pgen header"
                )

    total_variants = sum(h.num_variants for h in headers)
    rec = headers[0].record_size

    with timer.stage("pgen", total_variants * rec):
        with open(f"{out_prefix}.pgen", "wb") as out:
            out.write(PGEN_MAGIC + bytes([FIXED_WIDTH_STORAGE_MODE]))
            out.write(struct.pack("<II", total_variants, n_samples))
            out.write(bytes([MODE2_FORMAT_BYTE]))
            for p, h in zip(prefixes, headers):
                with open(f"{p}.pgen", "rb") as src:
                    src.seek(12)
                    left = h.num_variants * rec  # exactly the record span
                    while left:
                        chunk = src.read(min(left, 8 << 20))
                        if not chunk:
                            raise ConcatError(f"{p}.pgen: truncated records")
                        out.write(chunk)
                        left -= len(chunk)

    with timer.stage("pvar"):
        with open(f"{out_prefix}.pvar", "wb") as out:
            out.write(comments0)
            out.write(column0)
            for p in prefixes:
                table = read_metadata(f"{p}.pvar")
                buf = table.data_buffer
                lo, hi = table.row_line_spans()
                if len(lo):
                    # ends exclude each row's newline; interior newlines are
                    # inside the span, the last is re-added explicitly
                    out.write(buf[int(lo[0]) : int(hi[-1])].tobytes())
                    out.write(b"\n")

    with timer.stage("psam"):
        shutil.copyfile(f"{prefixes[0]}.psam", f"{out_prefix}.psam")

    return ConcatResult(
        out_prefix=out_prefix,
        num_variants=total_variants,
        num_samples=n_samples,
        num_inputs=len(prefixes),
        timer=timer,
    )
