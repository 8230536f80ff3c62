"""``ld`` on one GPU: the port of ``pgen_tpu/pipeline/ld_report.py`` with
pgen_tpu's device provider.

The plink ``--r2`` analog: r² for the variant pairs within the index/kb
windows, from mean-imputed centered dosages, as a .ld-flavored TSV

    CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2

one row per reported pair, A before B in fileset order. Windowing pins
plink's three knobs (documented conventions):

  * --ld-window N      index distance: j - i < N         (default 10)
  * --ld-window-kb X   |POS_j - POS_i| <= X * 1000       (default 1000)
  * --ld-window-r2 T   r² >= T                           (default 0.2)

Pairs never span a chromosome-run boundary; variants must be grouped by
chromosome. Each run's band is ``ops/ld.py``'s ``banded_r2`` on ``device``
(K15 ``ld_r2_band``, streamed by blocks); the masks are the port's
``compute_masks`` (genotype counts on the device). ``LdResult``,
``_chrom_runs`` and ``ld_report`` are copied from pgen_tpu, with a device
where pgen_tpu takes a provider.

Stages (``LdResult.timer``): predicates, gather, then per chromosome run
r2_band and ld_emit, inside total_emit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.ld import banded_r2
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class LdResult:
    num_variants: int
    num_samples: int
    num_pairs: int
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def _chrom_runs(chroms: list):
    runs = []
    lo = 0
    for i in range(1, len(chroms) + 1):
        if i == len(chroms) or chroms[i] != chroms[lo]:
            runs.append((lo, i))
            lo = i
    return runs


def ld_report(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    ld_window: int = 10,
    ld_window_kb: float = 1000.0,
    ld_window_r2: float = 0.2,
    out=None,
) -> LdResult:
    if ld_window < 2:
        raise ValueError("--ld-window must be >= 2 (at least one pair)")
    device = resolve_device(device)
    timer = StageTimer()

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
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, device
        )
        var_idx = np.flatnonzero(var_mask)
        sam_idx = np.flatnonzero(sam_mask)
    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)

    all_chroms = pvar.get_column_strs("CHROM")
    all_pos = pvar.get_column_strs("POS")
    all_ids = pvar.get_column_strs("ID")
    chroms = [all_chroms[int(v)] for v in var_idx]
    try:
        pos = np.array([int(all_pos[int(v)]) for v in var_idx], dtype=np.int64)
    except ValueError as e:
        raise ValueError(f"ld: non-integer POS in {pvar.path}: {e}") from None
    ids = [all_ids[int(v)] for v in var_idx]

    band = ld_window - 1
    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )
    n_pairs = 0

    def emit(fh):
        nonlocal n_pairs
        fh.write("#CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\n")
        max_bp = ld_window_kb * 1000.0
        for lo, hi in _chrom_runs(chroms):
            w = hi - lo
            if w < 2:
                continue
            with timer.stage("r2_band", w * rec):
                r2 = banded_r2(
                    kept[lo:hi], header.num_samples, min(band, w - 1),
                    device, sample_idx=subset,
                )
            cpos = pos[lo:hi]
            chrom = chroms[lo]
            with timer.stage("ld_emit"):
                # pos distance per (i, d): pos[i+1+d] - pos[i], edge-padded
                bw = r2.shape[1]
                dist = np.full((w, bw), np.inf)
                for d in range(bw):
                    n = w - 1 - d
                    if n > 0:
                        # |POS_j - POS_i|: POS is not validated as sorted,
                        # so a signed difference would let any out-of-order
                        # pair (negative distance) bypass the kb window
                        dist[:n, d] = np.abs(cpos[1 + d :] - cpos[:n])
                keep = (r2 >= ld_window_r2) & (dist <= max_bp)
                for i, d in zip(*np.nonzero(keep)):
                    j = i + 1 + d
                    fh.write(
                        f"{chrom}\t{cpos[i]}\t{ids[lo + i]}\t{chrom}\t"
                        f"{cpos[j]}\t{ids[lo + j]}\t{r2[i, d]:.6g}\n"
                    )
                n_pairs += int(keep.sum())

    with timer.stage("total_emit"):
        if out is not None:
            emit(out)
            out_path = None
        else:
            out_path = out_file or f"{pfile_prefix}.ld"
            with open(out_path, "w") as fh:
                emit(fh)
    return LdResult(
        num_variants=len(var_idx),
        num_samples=len(sam_idx),
        num_pairs=n_pairs,
        out_path=out_path,
        timer=timer,
    )
