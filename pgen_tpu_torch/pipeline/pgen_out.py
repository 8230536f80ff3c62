"""Filter to a .pgen fileset on one GPU: the port of
``pgen_tpu/pipeline/pgen_out.py`` (``filter --out-format pgen``).

Everything but the sample re-pack is the port's copy of pgen_tpu's host
code: the header and metadata readers (``formats/``), ``compute_masks``
(``pipeline/filter_host.py``, on the ``native`` provider, or ``numpy``
without a C++ toolchain), ``_gather_rows`` and ``_write_meta_subset``
(``pipeline/pgen_out_host.py``). With ``provider="device"`` the masks come
from the port's ``compute_masks`` (``pipeline/filter.py``) instead, whose
genotype counts run on the device (K8, K9).

When every sample is kept the records are copied verbatim, with no device
work, as pgen_tpu does. Otherwise, per block of kept variants:

  gather      host gather of the kept rows into the staging tensor (pinned
              host memory when the device is CUDA)
  h2d         copy to the device
  kernel      subset_repack (K5) with the kept sample ids resident on the
              device: unpack, column take and pack in one kernel
  d2h         copy of the re-packed records to a pinned host buffer
  write_pgen  append to OUT.pgen

The loop is synchronous, as in ``pipeline/filter.py``. Output bytes equal
pgen_tpu's for every provider.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    read_pgen_header,
    variant_record_size,
)
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter_host import _gather_rows, compute_masks
from pgen_tpu_torch.pipeline.pgen_out_host import DEFAULT_BLOCK, PgenFilterResult, _write_meta_subset
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.device import resolve_device, synchronize
from pgen_tpu_torch.ops.pack import subset_repack
from pgen_tpu_torch.pipeline.filter import compute_masks as device_masks

log = get_logger("torch.pgen_out")


def subset_blocks(records, var_idx, sam_idx, dev, block_variants, timer):
    """Re-pack the kept rows to the kept samples (K5), block by block: yields
    each block's records, a (rows, ceil(K/4)) u8 host array that holds until
    the next block is asked for. ``filter --out-format pgen`` writes them
    as they are, ``--out-format bed`` (``pipeline/bed_import.py``) after
    its code LUT."""
    cuda = dev.type == "cuda"
    rows = min(block_variants, len(var_idx))
    rec = records.shape[1]
    out_rec = variant_record_size(len(sam_idx))
    staging = torch.empty((rows, rec), dtype=torch.uint8, pin_memory=cuda)
    staging_np = staging.numpy()
    sel = torch.from_numpy(sam_idx.astype(np.int32)).to(dev)
    out_host = torch.empty((rows, out_rec), dtype=torch.uint8, pin_memory=True) if cuda else None

    for lo in range(0, len(var_idx), block_variants):
        hi = min(lo + block_variants, len(var_idx))
        n = hi - lo
        with timer.stage("gather", nbytes=n * rec):
            np.copyto(staging_np[:n], _gather_rows(records, var_idx[lo:hi]))
        with timer.stage("h2d", nbytes=n * rec):
            packed = staging[:n].to(dev, non_blocking=True)
            synchronize(dev)
        with timer.stage("kernel", nbytes=n * out_rec):
            out = subset_repack(packed, sel)
            synchronize(dev)
        if cuda:
            with timer.stage("d2h", nbytes=n * out_rec):
                out_host[:n].copy_(out, non_blocking=True)
                synchronize(dev)
            out = out_host[:n]
        yield out.numpy()


def filter_to_pgen(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_prefix: str | None = None,
    device: str | torch.device = "cuda",
    block_variants: int = DEFAULT_BLOCK,
    provider: str = "auto",
) -> PgenFilterResult:
    """Filter a pgen fileset to OUT_PREFIX.pgen/.pvar/.psam with the sample
    re-pack on ``device`` (``"cuda"``, which must be available, or ``"cpu"``).

    Same arguments and output bytes as pgen_tpu's ``filter_to_pgen``;
    ``out_prefix`` defaults to ``{prefix}.pgen-rs``. ``provider="auto"``
    evaluates the predicates on the host (pgen_tpu's ``native`` provider, or
    ``numpy`` without a C++ toolchain); ``"device"`` makes their genotype
    counts on ``device`` (the port's ``compute_masks``), as pgen_tpu's
    device provider makes them on its device.
    """
    if provider not in ("auto", "device"):
        raise ValueError(f"provider must be auto or device, got {provider!r}")
    from pgen_tpu_torch.native import HAVE_NATIVE

    dev = resolve_device(device)
    if block_variants < 1:
        raise ValueError(f"block_variants must be positive, got {block_variants}")
    timer = StageTimer()
    if out_prefix is None:
        out_prefix = f"{pfile_prefix}.pgen-rs"
    out_prefix = str(out_prefix)

    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")

    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = pgen_mm[12 : 12 + header.num_variants * rec].reshape(header.num_variants, rec)

    with timer.stage("predicates"):
        if provider == "device":
            var_mask, sam_mask = device_masks(
                var_query, sam_query, pvar, psam, header, records, dev
            )
        else:
            var_mask, sam_mask = compute_masks(
                var_query, sam_query, pvar, psam, header, records,
                "native" if HAVE_NATIVE else "numpy",
            )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    n_kept = len(sam_idx)
    keep_all_samples = n_kept == psam.num_rows == header.num_samples

    with open(f"{out_prefix}.pgen", "wb") as f:
        with timer.stage("write_pgen"):
            f.write(PGEN_MAGIC)
            f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
            f.write(struct.pack("<II", len(var_idx), n_kept))
            f.write(bytes([MODE2_FORMAT_BYTE]))
        if keep_all_samples:
            for lo in range(0, len(var_idx), block_variants):
                hi = min(lo + block_variants, len(var_idx))
                with timer.stage("gather", nbytes=(hi - lo) * rec):
                    blk = np.ascontiguousarray(_gather_rows(records, var_idx[lo:hi]))
                with timer.stage("write_pgen", nbytes=blk.nbytes):
                    f.write(blk)
        elif len(var_idx) and n_kept:
            for blk in subset_blocks(records, var_idx, sam_idx, dev, block_variants, timer):
                with timer.stage("write_pgen", nbytes=blk.nbytes):
                    f.write(blk)

    with timer.stage("write_meta"):
        _write_meta_subset(pvar, var_idx, f"{out_prefix}.pvar")
        _write_meta_subset(psam, sam_idx, f"{out_prefix}.psam")

    log.info("filter --out-format pgen (%s): %s", dev, timer.report())
    return PgenFilterResult(
        out_prefix=out_prefix,
        num_variants_kept=len(var_idx),
        num_samples_kept=n_kept,
        timer=timer,
    )
