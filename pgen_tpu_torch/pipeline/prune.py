"""``prune`` on one GPU: the port of ``pgen_tpu/pipeline/prune.py`` with
pgen_tpu's device provider.

The plink ``--indep-pairwise`` analog. Selects an approximately-independent
variant subset: within sliding windows (count- or kb-sized, never crossing
a chromosome run), any pair of surviving variants with mean-imputed dosage
correlation r² above the threshold loses its lower-MAF member
(``ops/ld.py`` documents the greedy spec). Outputs the plink conventions:

    OUT.prune.in    IDs of kept variants, input order
    OUT.prune.out   IDs of removed variants, input order

Accepts the same include/exclude predicates, regions, and sample lists as
``filter`` (the cohort restricts both the correlations and the MAFs). kb
windows require CHROM/POS-sorted input.

On ``device``: the masks (the port's ``compute_masks``), the MAF counts
(K8 ``gt_counts`` over every sample, K14 ``gt_counts_subset`` over a
cohort, where pgen_tpu counts on the host) and the band (``banded_r2``:
K15 ``ld_r2_band``, K5 first for a cohort); the greedy walk is the host
copy.
``PruneResult``, ``MAX_BAND``, ``parse_window_spec``, ``_chrom_run_ends``,
``window_extents`` and ``prune`` are copied from pgen_tpu, with a device
where pgen_tpu takes a provider.

Stages (``PruneResult.timer``): predicates, gather, maf, banded_r2, greedy,
emit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset
from pgen_tpu_torch.ops.ld import banded_r2, greedy_prune
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer

MAX_BAND = 8192


@dataclass
class PruneResult:
    num_considered: int
    num_kept: int
    num_removed: int
    out_prefix: str
    alive: np.ndarray  # over the considered (post-filter) variants
    timer: StageTimer = field(default_factory=StageTimer)


def parse_window_spec(spec) -> tuple:
    """['50', '5', '0.2'] or ['500kb', '1', '0.2'] -> (size, is_kb, step, r2)."""
    if len(spec) != 3:
        raise ValueError("--indep-pairwise takes WINDOW[kb] STEP R2")
    w, step_s, r2_s = (str(x) for x in spec)
    m = re.fullmatch(r"(\d+)(kb)?", w, flags=re.IGNORECASE)
    if not m:
        raise ValueError(f"--indep-pairwise: bad window {w!r} (N or Nkb)")
    size, is_kb = int(m.group(1)), m.group(2) is not None
    step = int(step_s)
    r2 = float(r2_s)
    if size < 2 and not is_kb:
        raise ValueError("--indep-pairwise: count window must be >= 2")
    if size < 1 or step < 1:
        raise ValueError("--indep-pairwise: window/step must be >= 1")
    if not (0.0 <= r2 <= 1.0):
        raise ValueError(f"--indep-pairwise: r2 {r2} outside [0, 1]")
    return size, is_kb, step, r2


def _chrom_run_ends(chrom: np.ndarray) -> np.ndarray:
    """run_end[i] = first index past i's contiguous same-CHROM run."""
    n = len(chrom)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    boundaries = np.flatnonzero(chrom[1:] != chrom[:-1]) + 1
    ends = np.concatenate([boundaries, [n]])
    return np.repeat(ends, np.diff(np.concatenate([[0], ends])))


def window_extents(chrom, pos, size: int, is_kb: bool) -> np.ndarray:
    """extent[i] = window length (variants) for a window starting at i."""
    n = len(chrom)
    run_end = _chrom_run_ends(chrom)
    if not is_kb:
        return np.minimum(size, run_end - np.arange(n))
    # kb window: same-chrom variants with POS <= POS[i] + size*1000;
    # needs sorted POS within each run
    pos = np.asarray(pos, dtype=np.int64)
    same_run = run_end[:-1] == run_end[1:]
    bad = np.flatnonzero(same_run & (pos[1:] < pos[:-1]))
    if len(bad):
        i = int(bad[0])
        raise ValueError(
            "kb windows need CHROM/POS-sorted input (run `pgen-tpu sort` "
            f"first); violation at row {i + 1} (POS {pos[i + 1]} < {pos[i]})"
        )
    limits = pos + size * 1000
    # searchsorted per chrom run (POS may repeat across runs)
    ends = np.empty(n, dtype=np.int64)
    starts = np.concatenate([[0], np.flatnonzero(run_end[:-1] != run_end[1:]) + 1])
    for s in starts:
        e = int(run_end[s])
        ends[s:e] = s + np.searchsorted(pos[s:e], limits[s:e], side="right")
    return ends - np.arange(n)


def prune(
    pfile_prefix: str,
    indep_pairwise,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_prefix: str | None = None,
    device="cuda",
    write: bool = True,
) -> PruneResult:
    size, is_kb, step, r2_thresh = parse_window_spec(indep_pairwise)
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
    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )

    chrom = pvar.get_column_bytes("CHROM")[var_idx]
    if is_kb:
        pos = np.asarray(
            [int(x) for x in np.asarray(pvar.get_column_strs("POS"))[var_idx]],
            dtype=np.int64,
        )
    else:
        pos = None
    extents = window_extents(chrom, pos, size, is_kb)
    band = int(extents.max() - 1) if len(extents) else 0
    band = max(band, 0)
    if band > MAX_BAND:
        raise ValueError(
            f"prune: window spans up to {band + 1} variants (> {MAX_BAND}); "
            "use a count window or a smaller kb size"
        )

    with timer.stage("maf"):
        if subset is None:
            counts = gt_counts(kept, header.num_samples, device)
        else:
            counts = gt_counts_subset(kept, subset, device)
        ac = counts[:, 1] + 2 * counts[:, 2]
        an = 2 * (counts[:, 0] + counts[:, 1] + counts[:, 2])
        with np.errstate(divide="ignore", invalid="ignore"):
            af = np.where(an > 0, ac / np.maximum(an, 1), 0.0)
        maf = np.minimum(af, 1.0 - af)

    with timer.stage("banded_r2", kept.shape[0] * rec):
        r2_band = banded_r2(
            kept, header.num_samples, band, device, sample_idx=subset
        )
    with timer.stage("greedy"):
        alive = greedy_prune(r2_band, maf, extents, step, r2_thresh)

    out = out_prefix or pfile_prefix
    if write:
        ids = np.asarray(pvar.get_column_strs("ID"))[var_idx]
        with timer.stage("emit"):
            with open(f"{out}.prune.in", "w") as fh:
                fh.writelines(f"{i}\n" for i in ids[alive])
            with open(f"{out}.prune.out", "w") as fh:
                fh.writelines(f"{i}\n" for i in ids[~alive])
    return PruneResult(
        num_considered=len(var_idx),
        num_kept=int(alive.sum()),
        num_removed=int((~alive).sum()),
        out_prefix=out,
        alive=alive,
        timer=timer,
    )
