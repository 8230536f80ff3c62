"""``king`` on one GPU: the port of ``pgen_tpu/pipeline/king.py`` with
pgen_tpu's device provider.

The plink2 ``--make-king-table`` analog: the same include/exclude
predicates, regions and sample lists as ``filter``, the four pair-count
Grams on ``device`` (``ops/king.py``: K12's bits and Gram kernels), then a
``.kin0``-flavored TSV

    #IID1  IID2  NSNP  HETHET  IBS0  KINSHIP

one row per unordered sample pair (i < j, psam order); ``--min-kinship X``
keeps rows with KINSHIP >= X, and ``--cutoff X`` (the ``--king-cutoff``
analog) writes ``{out}.king.cutoff.in.id`` / ``.out.id`` instead. The masks
are the port's ``compute_masks`` (genotype counts on the device, as glm's);
``king_counts_chunked``, ``king_cutoff_mask``, ``king_table`` and
``_emit_rows`` are copied from pgen_tpu, with a device where pgen_tpu takes
a provider: device calls stay below 2^23 variants and their Grams add up
in f64.

Under a process group of several ranks (torchrun, one process per card;
``parallel/mesh.py``) rank r gathers and counts only its contiguous shard
of the kept variants, each chunk's Grams are summed over the ranks by
``king_counts_mesh``, and rank 0 alone writes. A lone process is the one
rank and makes no group.

Stages (``KingResult.timer``): process_group, metadata_load, predicates,
gather, king_grams (inside it each block's stage_read and h2d, the Grams'
d2h and the all_reduce), kinship, king_select, king_emit; under several
ranks, one line a rank (its card, rows and king_grams).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.king import KingCounts, king_counts_mesh, king_kinship
from pgen_tpu_torch.parallel.mesh import shard_range, variant_mesh
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer

# beyond this many variants, device calls are chunked so each call's
# Gram accumulation stays exact (ops/king.py); chunks sum in f64 on host
_DEVICE_EXACT_VARIANTS = 1 << 23


@dataclass
class KingResult:
    num_variants: int
    num_samples: int
    num_pairs: int
    out_path: str | None
    kinship: np.ndarray
    ibs0: np.ndarray
    nsnp: np.ndarray
    timer: StageTimer = field(default_factory=StageTimer)


def king_counts_chunked(records, num_samples, device, sample_idx, timer,
                        block_variants=None, rows=None):
    """Device calls with host-side f64 accumulation across chunks, each
    chunk's Grams summed over the ranks (``king_counts_mesh``).

    Each chunk is small enough that the device Grams are exact; the f64
    sums keep exactness for any total variant count. ``rows`` (the largest
    shard's, this rank's without it) sets the number of chunks, so every
    rank makes as many collectives.
    """
    kw = {}
    if block_variants:
        kw["block_variants"] = int(block_variants)
    nvar = records.shape[0] if rows is None else rows
    step = _DEVICE_EXACT_VARIANTS
    total = None
    nbytes = records.shape[0] * records.shape[1]
    with timer.stage("king_grams", nbytes):
        for lo in range(0, max(nvar, 1), max(step, 1)):
            part = king_counts_mesh(
                records[lo : lo + step],
                num_samples,
                device,
                sample_idx=sample_idx,
                timer=timer,
                **kw,
            )
            total = part if total is None else KingCounts(
                *(a + b for a, b in zip(total, part))
            )
        if total is None:
            ns = num_samples if sample_idx is None else len(sample_idx)
            z = np.zeros((ns, ns), dtype=np.float64)
            total = KingCounts(z, z.copy(), z.copy(), z.copy())
    return total


def king_cutoff_mask(kin: np.ndarray, cutoff: float) -> np.ndarray:
    """Greedy relatedness pruning: bool keep-mask over the cohort.

    While any surviving pair exceeds the cutoff, remove the sample with
    the most above-cutoff surviving pairs (tie: the later index). NaN
    kinships (undefined estimates) never count as above-cutoff.
    """
    over = np.nan_to_num(kin, nan=-np.inf) > cutoff
    np.fill_diagonal(over, False)
    keep = np.ones(kin.shape[0], dtype=bool)
    while True:
        deg = (over & keep[None, :] & keep[:, None]).sum(axis=1)
        deg[~keep] = 0
        worst = int(deg.max()) if len(deg) else 0
        if worst == 0:
            return keep
        # ties resolve to the LATER index: argmax on the reversed array
        victim = len(deg) - 1 - int(np.argmax(deg[::-1]))
        keep[victim] = False


def king_table(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
    min_kinship: float | None = None,
    block_variants: int | None = None,
    out=None,
    cutoff: float | None = None,
) -> KingResult:
    """pgen_tpu's ``king_table`` with ``provider="device"``, its device work
    on ``device`` (``"cuda"``, which must be available, or ``"cpu"``, the
    kernels' plain versions), over this rank's variant shard under a
    process group. Same arguments otherwise, same output bytes, written by
    rank 0."""
    timer = StageTimer()
    with variant_mesh(device, timer) as mesh:
        return _king_table(pfile_prefix, var_query, sam_query, out_file, min_kinship,
                           block_variants, out, cutoff, mesh)


def _king_table(pfile_prefix, var_query, sam_query, out_file, min_kinship, block_variants,
                out, cutoff, mesh) -> KingResult:
    dev, timer = mesh.device, mesh.timer
    with timer.stage("metadata_load"):
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
            f"king needs >= 2 samples after filtering (got {len(sam_idx)})"
        )
    lo, hi = mesh.shard(len(var_idx), "king_grams")
    with timer.stage("gather", (hi - lo) * rec):
        kept = _gather_rows(records, var_idx[lo:hi])

    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )
    counts = king_counts_chunked(
        kept, header.num_samples, dev, subset, timer, block_variants,
        rows=shard_range(len(var_idx), 0, mesh.world)[1],
    )
    mesh.report_ranks()

    with timer.stage("kinship"):
        kin, ibs0 = king_kinship(counts)
    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]

    if cutoff is not None:
        keep = king_cutoff_mask(kin, cutoff)
        out_path = out_file or pfile_prefix
        if mesh.rank == 0:
            with timer.stage("king_emit"):
                with open(f"{out_path}.king.cutoff.in.id", "w") as fh:
                    fh.writelines(
                        f"{iid}\n" for iid, k in zip(iids, keep) if k
                    )
                with open(f"{out_path}.king.cutoff.out.id", "w") as fh:
                    fh.writelines(
                        f"{iid}\n" for iid, k in zip(iids, keep) if not k
                    )
        return KingResult(
            num_variants=len(var_idx),
            num_samples=len(sam_idx),
            num_pairs=int(keep.sum()),  # kept samples in cutoff mode
            out_path=out_path,
            kinship=kin,
            ibs0=ibs0,
            nsnp=counts.nsnp,
            timer=timer,
        )

    n_pairs = 0
    out_path = None if out is not None else out_file or f"{pfile_prefix}.kin0"
    if mesh.rank == 0:
        with contextlib.nullcontext(out) if out is not None else open(out_path, "w") as fh:
            n_pairs = _emit_rows(fh, iids, kin, ibs0, counts, min_kinship, timer)
    return KingResult(
        num_variants=len(var_idx),
        num_samples=len(sam_idx),
        num_pairs=n_pairs,
        out_path=out_path,
        kinship=kin,
        ibs0=ibs0,
        nsnp=counts.nsnp,
        timer=timer,
    )


def _emit_rows(out, iids, kin, ibs0, counts, min_kinship, timer) -> int:
    """#IID1 IID2 NSNP HETHET IBS0 KINSHIP rows (i < j, psam order)."""
    ns = len(iids)
    with timer.stage("king_select"):
        ii, jj = np.triu_indices(ns, k=1)
        k = kin[ii, jj]
        if min_kinship is not None:
            keep = k >= min_kinship  # NaN compares false -> dropped
            ii, jj, k = ii[keep], jj[keep], k[keep]
        n = counts.nsnp[ii, jj]
        safe_n = np.maximum(n, 1)
        hethet = np.where(n > 0, counts.hethet[ii, jj] / safe_n, 0.0)
        ib = np.where(n > 0, ibs0[ii, jj] / safe_n, 0.0)
    with timer.stage("king_emit"):
        out.write("#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP\n")
        write = out.write
        for a, b, nn, hh, i0, kk in zip(ii, jj, n, hethet, ib, k):
            write(
                f"{iids[a]}\t{iids[b]}\t{int(nn)}\t"
                f"{hh:.6g}\t{i0:.6g}\t{kk:.6g}\n"
            )
    return len(ii)
