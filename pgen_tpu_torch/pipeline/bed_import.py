"""PLINK1 ``.bed``/``.bim``/``.fam`` output on one GPU: the port of
``pgen_tpu/pipeline/bed_import.py:filter_to_bed`` (``filter --out-format
bed``). ``import X.bed`` is host code in pgen_tpu as in the port (a byte
LUT and a pad-bit mask): ``import_bed`` is re-exported from the copy,
``pipeline/bed_import_host.py``.

``filter_to_bed`` follows pgen_tpu's line for line but at the sample
re-pack. The masks come from the port's copy of ``compute_masks``
(``pipeline/filter_host.py``, the ``native`` provider, or ``numpy``
without a C++ toolchain), or with ``provider="device"`` from the port's
``compute_masks`` (``pipeline/filter.py``), whose genotype counts run on
the device (K8, K9), as ``pipeline/pgen_out.py:filter_to_pgen`` takes them.
When every sample is kept the records are copied with no device work, as
pgen_tpu does. Otherwise each block of kept rows goes through the loop of
``--out-format pgen`` (``pipeline/pgen_out.py:subset_blocks``):

  gather   host gather of the kept rows into the staging tensor (pinned
           host memory when the device is CUDA)
  h2d      copy to the device
  kernel   subset_repack (K5) with the kept sample ids resident on the
           device: unpack, column take and pack in one kernel
  d2h      copy of the re-packed records to a pinned host buffer
  bed      the inverse code LUT and the tail pad mask on the host, as
           pgen_tpu does, and the append to OUT.bed

then ``bim`` and ``fam``, the copy's text. Output bytes equal pgen_tpu's
for every provider.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.bed_import_host import (
    _BYTE_LUT_INV,
    BED_MAGIC,
    DEFAULT_CHUNK_ROWS,
    BedImportError,
    BedImportResult,
    _sex_code,
    import_bed,
)
from pgen_tpu_torch.pipeline.filter import compute_masks as device_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows, _resolve_provider, compute_masks
from pgen_tpu_torch.pipeline.pgen_out import subset_blocks
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

__all__ = ["BedImportError", "BedImportResult", "filter_to_bed", "import_bed"]

log = get_logger("torch.bed")


def filter_to_bed(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_prefix: str | None = None,
    device: str | torch.device = "cuda",
    provider: str = "auto",
    block_variants: int = DEFAULT_CHUNK_ROWS,
) -> BedImportResult:
    """Filter a pgen fileset into PLINK1 OUT_PREFIX.bed/.bim/.fam with the
    sample re-pack on ``device`` (``"cuda"``, which must be available, or
    ``"cpu"``).

    Same arguments and output bytes as pgen_tpu's ``filter_to_bed``:
    ``out_prefix`` defaults to ``{prefix}.pgen-rs``; pgen code -> plink1
    code is the inverse byte LUT and the ``.bed`` pad bits are zero; .bim:
    CHROM ID CM=0 POS A1=ALT A2=REF; .fam: FID=0 IID PAT=0 MAT=0 SEX
    (mapped from the psam SEX column when present) PHENO1 (or -9).
    ``provider`` is ``"auto"`` (predicates on the host) or ``"device"``
    (their genotype counts on ``device``).
    """
    if provider not in ("auto", "device"):
        raise ValueError(f"provider must be auto or device, got {provider!r}")
    dev = resolve_device(device)
    if block_variants < 1:
        raise ValueError(f"block_variants must be positive, got {block_variants}")
    timer = StageTimer()
    if out_prefix is None:
        out_prefix = f"{pfile_prefix}.pgen-rs"
    out_prefix = str(out_prefix)

    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )

    with timer.stage("predicates"):
        if provider == "device":
            var_mask, sam_mask = device_masks(
                var_query, sam_query, pvar, psam, header, records, dev
            )
        else:
            var_mask, sam_mask = compute_masks(
                var_query, sam_query, pvar, psam, header, records, _resolve_provider("auto")
            )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    n_kept = len(sam_idx)
    keep_all = n_kept == psam.num_rows == header.num_samples

    tail_used = n_kept % 4
    tail_mask = np.uint8((1 << (2 * tail_used)) - 1) if tail_used else np.uint8(0xFF)

    def write_bed(f, blk: np.ndarray) -> None:
        with timer.stage("bed", nbytes=blk.nbytes):
            out = _BYTE_LUT_INV[blk]
            if out.shape[1]:
                out[:, -1] &= tail_mask
            f.write(out.tobytes())

    with open(f"{out_prefix}.bed", "wb") as f:
        with timer.stage("bed"):
            f.write(BED_MAGIC)
        if keep_all:
            for lo in range(0, len(var_idx), block_variants):
                hi = min(lo + block_variants, len(var_idx))
                with timer.stage("gather", nbytes=(hi - lo) * rec):
                    blk = np.asarray(_gather_rows(records, var_idx[lo:hi]))
                write_bed(f, blk)
        elif len(var_idx) and n_kept:
            for blk in subset_blocks(records, var_idx, sam_idx, dev, block_variants, timer):
                write_bed(f, blk)

    with timer.stage("bim"):
        chrom = pvar.get_column_strs("CHROM")
        pos = pvar.get_column_strs("POS")
        vid = pvar.get_column_strs("ID")
        ref = pvar.get_column_strs("REF")
        alt = pvar.get_column_strs("ALT")
        with open(f"{out_prefix}.bim", "w") as f:
            for i in var_idx:
                i = int(i)
                f.write(
                    f"{chrom[i]}\t{vid[i]}\t0\t{pos[i]}\t{alt[i]}\t{ref[i]}\n"
                )

    with timer.stage("fam"):
        iids = psam.get_column_strs("IID")
        sex = (
            psam.get_column_strs("SEX")
            if "SEX" in psam.columns
            else ["0"] * len(iids)
        )
        pheno = (
            psam.get_column_strs("PHENO1")
            if "PHENO1" in psam.columns
            else ["-9"] * len(iids)
        )
        with open(f"{out_prefix}.fam", "w") as f:
            for s in sam_idx:
                s = int(s)
                f.write(f"0\t{iids[s]}\t0\t0\t{_sex_code(sex[s])}\t{pheno[s]}\n")

    log.info("filter --out-format bed (%s): %s", dev, timer.report())
    return BedImportResult(
        out_prefix=out_prefix,
        num_variants=len(var_idx),
        num_samples=n_kept,
        timer=timer,
    )
