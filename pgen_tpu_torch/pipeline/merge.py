"""Sample-axis merge of pgen filesets on one GPU: the port of
``pgen_tpu/pipeline/merge.py`` (``merge``).

Inputs hold different samples over the same variants; the output carries
every input's samples in argument order. Mode-0x02 packs four samples a
byte, so an input whose sample count is not a multiple of 4 shifts every
later input's codes inside the packed byte: the splice decodes, joins and
re-packs. Per block of variants:

  gather   host copy of each input's rows [lo, hi) into its staging tensor
           (pinned host memory when the device is CUDA)
  decode   copy to the device and K1 ``unpack_codes`` of each input
  splice   ``torch.cat`` of the inputs' codes on the sample axis, then K4
           ``pack_codes``, and the copy of the merged records to the host
  write    append to OUT.pgen

pgen_tpu runs the same splice on the host (its native C++ or numpy
codecs, ``_codecs``). The validation (identical ``.pvar`` data rows and
column lines, no duplicate IID across inputs), the ``.pvar`` copy and the
``.psam`` join are its code, copied; ``MergeError``, ``MergeResult`` and
``_psam_lines`` are in ``pipeline/merge_host.py``. Output bytes equal
pgen_tpu's.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    read_pgen_header,
    variant_record_size,
)
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.pack import pack_codes
from pgen_tpu_torch.ops.unpack import decode_rows
from pgen_tpu_torch.pipeline.merge_host import DEFAULT_BLOCK, MergeError, MergeResult, _psam_lines
from pgen_tpu_torch.utils.timer import StageTimer


def merge_pgen(
    prefixes: list, out_prefix: str, block_variants: int | None = None, device="cuda",
) -> MergeResult:
    """Merge the filesets at `prefixes` (same variants, disjoint samples)
    into OUT_PREFIX.{pgen,pvar,psam}, splicing on ``device``.

    block_variants defaults to pgen_tpu's ~256 MB code-matrix budget: the
    splice holds one unpacked byte per (variant, sample) for the inputs plus
    the joined copy."""
    dev = resolve_device(device)
    if len(prefixes) < 1:
        raise MergeError("need at least one input prefix")
    timer = StageTimer()

    with timer.stage("validate"):
        headers = [read_pgen_header(f"{p}.pgen") for p in prefixes]
        n_var = headers[0].num_variants
        for h in headers[1:]:
            if h.num_variants != n_var:
                raise MergeError(
                    f"{h.path}: {h.num_variants} variants != {n_var} "
                    f"({headers[0].path}); merge needs one variant set"
                )
        def _rows_span(prefix):
            """(row_count, joined row bytes) in O(1) allocations: the span
            from the first row's start to the last row's end covers every
            row including interior newlines."""
            t = read_metadata(f"{prefix}.pvar")
            lo, hi = t.row_line_spans()
            if len(lo) == 0:
                return 0, b""
            return len(lo), t.data_buffer[int(lo[0]) : int(hi[-1])].tobytes()

        rows0_n, rows0 = _rows_span(prefixes[0])
        if rows0_n != n_var:
            raise MergeError(
                f"{prefixes[0]}.pvar: {rows0_n} data rows != {n_var} "
                f"variants in the .pgen header"
            )
        for p in prefixes[1:]:
            n, span = _rows_span(p)
            if n != n_var or span != rows0:
                raise MergeError(
                    f"{p}.pvar: variant rows differ from {prefixes[0]}.pvar "
                    f"(merge is keyed on identical variants in identical order)"
                )
        psams = [_psam_lines(f"{p}.psam") for p in prefixes]
        iids = []
        for p, (_, rows) in zip(prefixes, psams):
            t = read_metadata(f"{p}.psam")
            iids.append(t.get_column_strs("IID"))
        flat = [i for ids in iids for i in ids]
        if len(set(flat)) != len(flat):
            dup = next(i for i in flat if flat.count(i) > 1)
            raise MergeError(f"duplicate sample IID across inputs: {dup!r}")

    n_out = sum(h.num_samples for h in headers)
    rec_out = variant_record_size(n_out)
    if block_variants is None:
        block_variants = int(min(DEFAULT_BLOCK, max(1024, (128 << 20) // max(n_out, 1))))

    mms = [np.memmap(f"{p}.pgen", dtype=np.uint8, mode="r") for p in prefixes]
    recs = [
        mm[12 : 12 + n_var * h.record_size].reshape(n_var, h.record_size)
        for mm, h in zip(mms, headers)
    ]
    every = np.arange(n_var)

    with open(f"{out_prefix}.pgen", "wb") as out:
        out.write(PGEN_MAGIC + bytes([FIXED_WIDTH_STORAGE_MODE]))
        out.write(struct.pack("<II", n_var, n_out))
        out.write(bytes([MODE2_FORMAT_BYTE]))
        streams = [decode_rows(r, every, h.num_samples, dev, block_variants, None, timer)
                   for r, h in zip(recs, headers)]
        for blocks in zip(*streams):
            lo, hi = blocks[0][:2]
            with timer.stage("splice", (hi - lo) * rec_out):
                joined = torch.cat([codes for _, _, codes in blocks], dim=1)
                merged = pack_codes(joined.contiguous()).cpu().numpy()
            with timer.stage("write_pgen", merged.nbytes):
                out.write(merged.tobytes())

    with timer.stage("pvar"):
        import shutil

        shutil.copyfile(f"{prefixes[0]}.pvar", f"{out_prefix}.pvar")

    with timer.stage("psam"):
        col0 = psams[0][0]
        same_columns = all(c == col0 for c, _ in psams)
        with open(f"{out_prefix}.psam", "wb") as f:
            if same_columns:
                f.write(col0 + b"\n")
                for _, rows in psams:
                    f.write(b"\n".join(rows) + (b"\n" if rows else b""))
            else:
                # heterogeneous psam schemas: keep the one shared column
                f.write(b"#IID\n")
                for ids in iids:
                    f.write(("\n".join(ids) + "\n").encode())

    return MergeResult(
        out_prefix=out_prefix,
        num_variants=n_var,
        num_samples=n_out,
        num_inputs=len(prefixes),
        timer=timer,
    )
