"""``genome`` on one GPU: the port of ``pgen_tpu/pipeline/genome.py`` with
pgen_tpu's device provider.

The PLINK ``--genome`` analog: the same include/exclude predicates,
regions and sample lists as ``filter``, the five IBS pair-count Grams on
``device`` (``ops/ibd.py``: K12's bits and Gram kernels), Z0/Z1/Z2/PI_HAT by
the method of moments from the kept cohort's ALT frequencies, then a
``.genome``-flavored TSV

    #IID1 IID2 NSNP IBS0 IBS1 IBS2 DST Z0 Z1 Z2 PI_HAT

one row per unordered sample pair (i < j, psam order); ``--min-pi-hat X``
keeps rows with PI_HAT >= X. The frequencies are counted on ``device``
too (K8 over every sample, K14 over a cohort), where pgen_tpu counts them
on the host for every provider. ``ibd_counts_chunked``, ``genome_table``
and ``_emit_rows`` are copied from pgen_tpu, with a device where pgen_tpu
takes a provider.

Under a process group of several ranks (``parallel/mesh.py``) rank r
gathers and counts only its contiguous shard of the kept variants: each
chunk's Grams are summed over the ranks (``ibd_counts_mesh``), and the
per-variant cohort counts of the freqs stage are all-gathered in rank
order, so the method of moments averages the same frequencies in the same
order as one rank does and the text is the same bytes. Rank 0 alone
writes.

Stages (``GenomeResult.timer``): process_group, predicates, gather,
ibd_grams (its all_reduce inside), freqs (its all_gather inside),
genome_emit; under several ranks, one line a rank.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset
from pgen_tpu_torch.ops.ibd import IbdCounts, ibd_counts_mesh, ibd_estimates
from pgen_tpu_torch.parallel.mesh import all_gather_rows, shard_range, variant_mesh
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer

# beyond this many variants, device calls are chunked so each call's
# Gram accumulation stays exact (ops/ibd.py); chunks sum in f64 on host
_DEVICE_EXACT_VARIANTS = 1 << 23


@dataclass
class GenomeResult:
    num_variants: int
    num_samples: int
    num_pairs: int
    out_path: str | None
    estimates: dict
    timer: StageTimer = field(default_factory=StageTimer)


def ibd_counts_chunked(records, num_samples, device, sample_idx, timer,
                       block_variants=None, rows=None):
    """Device calls with host-side f64 accumulation across chunks, each
    chunk's Grams summed over the ranks (mirrors pipeline/king.py
    king_counts_chunked, ``rows`` too)."""
    kw = {}
    if block_variants:
        kw["block_variants"] = int(block_variants)
    nvar = records.shape[0] if rows is None else rows
    step = _DEVICE_EXACT_VARIANTS
    total = None
    nbytes = records.shape[0] * records.shape[1]
    with timer.stage("ibd_grams", nbytes):
        for lo in range(0, max(nvar, 1), max(step, 1)):
            part = ibd_counts_mesh(
                records[lo : lo + step],
                num_samples,
                device,
                sample_idx=sample_idx,
                timer=timer,
                **kw,
            )
            total = part if total is None else IbdCounts(
                *(a + b for a, b in zip(total, part))
            )
        if total is None:
            ns = num_samples if sample_idx is None else len(sample_idx)
            z = np.zeros((ns, ns), dtype=np.float64)
            total = IbdCounts(*(z.copy() for _ in range(5)))
    return total


def genome_table(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
    min_pi_hat: float | None = None,
    block_variants: int | None = None,
    out=None,
) -> GenomeResult:
    """pgen_tpu's ``genome_table`` with ``provider="device"``, its device
    work on ``device`` (``"cuda"``, which must be available, or ``"cpu"``,
    the kernels' plain versions), over this rank's variant shard under a
    process group. Same arguments otherwise, same output bytes, written by
    rank 0."""
    timer = StageTimer()
    with variant_mesh(device, timer) as mesh:
        return _genome_table(pfile_prefix, var_query, sam_query, out_file, min_pi_hat,
                             block_variants, out, mesh)


def _genome_table(pfile_prefix, var_query, sam_query, out_file, min_pi_hat, block_variants,
                  out, mesh) -> GenomeResult:
    dev, timer = mesh.device, mesh.timer

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
            var_query, sam_query, pvar, psam, header, records, dev
        )
        var_idx = np.flatnonzero(var_mask)
        sam_idx = np.flatnonzero(sam_mask)
    if len(sam_idx) < 2:
        raise ValueError(
            f"genome needs >= 2 samples after filtering (got {len(sam_idx)})"
        )
    lo, hi = mesh.shard(len(var_idx), "ibd_grams")
    with timer.stage("gather", (hi - lo) * rec):
        kept = _gather_rows(records, var_idx[lo:hi])

    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )
    counts = ibd_counts_chunked(
        kept, header.num_samples, dev, subset, timer, block_variants,
        rows=shard_range(len(var_idx), 0, mesh.world)[1],
    )

    # cohort ALT frequencies of the kept variants feed the MoM expectations
    with timer.stage("freqs", kept.nbytes):
        if subset is None:
            c = gt_counts(kept, header.num_samples, dev)
        else:
            c = gt_counts_subset(kept, subset, dev)
        (c,) = all_gather_rows([c], dev, timer)
        an = 2.0 * (c[:, 0] + c[:, 1] + c[:, 2])
        with np.errstate(divide="ignore", invalid="ignore"):
            af = np.where(an > 0, (c[:, 1] + 2.0 * c[:, 2]) / np.maximum(an, 1),
                          np.nan)
    mesh.report_ranks()
    est = ibd_estimates(counts, af)

    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]

    n_pairs = 0
    out_path = None if out is not None else out_file or f"{pfile_prefix}.genome"
    if mesh.rank == 0:
        with contextlib.nullcontext(out) if out is not None else open(out_path, "w") as fh:
            n_pairs = _emit_rows(fh, iids, est, min_pi_hat, timer)
    return GenomeResult(
        num_variants=len(var_idx),
        num_samples=len(sam_idx),
        num_pairs=n_pairs,
        out_path=out_path,
        estimates=est,
        timer=timer,
    )


def _emit_rows(out, iids, est, min_pi_hat, timer) -> int:
    """#IID1 IID2 NSNP IBS0 IBS1 IBS2 DST Z0 Z1 Z2 PI_HAT (i < j)."""
    ns = len(iids)
    iu = np.triu_indices(ns, k=1)
    nsnp = (est["ibs0"] + est["ibs1"] + est["ibs2"])[iu]
    cols = {k: est[k][iu] for k in
            ("ibs0", "ibs1", "ibs2", "dst", "z0", "z1", "z2", "pi_hat")}
    keep = np.ones(len(iu[0]), dtype=bool)
    if min_pi_hat is not None:
        keep = np.nan_to_num(cols["pi_hat"], nan=-np.inf) >= min_pi_hat
    n = 0
    with timer.stage("genome_emit"):
        out.write("#IID1\tIID2\tNSNP\tIBS0\tIBS1\tIBS2\tDST\t"
                  "Z0\tZ1\tZ2\tPI_HAT\n")
        for k in range(len(iu[0])):
            if not keep[k]:
                continue
            i, j = int(iu[0][k]), int(iu[1][k])
            out.write(
                f"{iids[i]}\t{iids[j]}\t{int(nsnp[k])}\t"
                f"{int(cols['ibs0'][k])}\t{int(cols['ibs1'][k])}\t"
                f"{int(cols['ibs2'][k])}\t{cols['dst'][k]:.6f}\t"
                f"{cols['z0'][k]:.4f}\t{cols['z1'][k]:.4f}\t"
                f"{cols['z2'][k]:.4f}\t{cols['pi_hat'][k]:.4f}\n"
            )
            n += 1
    return n
