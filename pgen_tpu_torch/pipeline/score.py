"""``score`` on one GPU: the port of ``pgen_tpu/pipeline/score.py``'s
``score_pfile`` with pgen_tpu's device provider.

Step for step as pgen_tpu: parse the scoring table, the masks of the two
include-predicates (the port's ``compute_masks``), match score lines to
kept variants by pvar ID (REF matches run flipped), the host gather of the
matched rows, the score products on ``device`` (``ops/score.py``: K11 and
``torch.matmul`` in full fp32), then the ``.sscore`` table, or one per
``--q-score-range`` range. ``--center``/``--variance-standardize`` reduce
to a weight rescale and a per-score offset, from the matched variants'
genotype counts on ``device``: K8 over every sample, K14 over a sample
subset (``gt_counts_masked``). The table
parsers are the port's copies of pgen_tpu's (``pipeline/score_host.py``).

Under a process group of several ranks (``parallel/mesh.py``) rank r
gathers and scores only its contiguous shard of the matched variants (of a
--q-score-range range, the range's rows inside that shard), with its slice
of the weights and flips; the four results are summed over the ranks
(``score_mesh``), the counts of --center/--variance-standardize
all-gathered in rank order, and rank 0 alone writes, after every range is
scored.

Stages (``ScoreRunResult.timer``): process_group, score_file, predicates,
match, gather, moments (the counts of --center/--variance-standardize, its
all_gather inside), score (its all_reduce inside), emit; under several
ranks, one line a rank.
"""

from __future__ import annotations

import contextlib

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.pipeline.score_host import (
    ScoreRunResult,
    read_q_data,
    read_q_ranges,
    read_score_file,
)
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.ops.score import score_mesh
from pgen_tpu_torch.parallel.mesh import all_gather_rows, variant_mesh
from pgen_tpu_torch.pipeline.filter import compute_masks

log = get_logger("torch.score")


def _match(table, pvar, var_mask) -> tuple:
    """Score lines -> (kept variant rows ascending, their weights, flips,
    unmatched, mismatched): pgen_tpu's matching, first pvar ID wins."""
    pvar_ids = pvar.get_column_strs("ID")
    refs = pvar.get_column_strs("REF")
    alts = pvar.get_column_strs("ALT")
    id_to_row: dict = {}
    for row, vid in enumerate(pvar_ids):
        id_to_row.setdefault(vid, row)
    var_rows, w_rows, flips = [], [], []
    unmatched = mismatched = 0
    for i, (vid, a1) in enumerate(zip(table.ids, table.alleles)):
        row = id_to_row.get(vid)
        if row is None or not var_mask[row]:
            unmatched += 1
            continue
        if a1 == alts[row]:
            flips.append(False)
        elif a1 == refs[row]:
            flips.append(True)
        else:
            mismatched += 1
            continue
        var_rows.append(row)
        w_rows.append(i)
    order = np.argsort(np.asarray(var_rows, dtype=np.int64), kind="stable")
    var_idx = np.asarray(var_rows, dtype=np.int64)[order]
    weights = table.weights[np.asarray(w_rows, dtype=np.int64)[order]]
    flip = np.asarray(flips, dtype=bool)[order]
    return var_idx, weights, flip, unmatched, mismatched


def _effect_means(kept, num_samples, subset, flip, weights, variance_standardize, dev,
                  timer=None):
    """plink2 ``center``/``variance-standardize`` under mean imputation:
    the (possibly rescaled) weights and each variant's effect-allele mean,
    from the kept rows' genotype counts (``kept``: this rank's shard; the
    counts of every rank's are all-gathered in rank order)."""
    from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset

    if subset is None:
        cts = gt_counts(kept, num_samples, dev)
    else:
        cts = gt_counts_subset(kept, subset, dev)
    (cts,) = all_gather_rows([cts], dev, timer)
    n_called = cts[:, :3].sum(axis=1).astype(np.float64)
    used = n_called > 0
    safe_n = np.maximum(n_called, 1.0)
    mu_alt = (cts[:, 1] + 2.0 * cts[:, 2]) / safe_n
    if variance_standardize:
        var = (cts[:, 1] + 4.0 * cts[:, 2]) / safe_n - mu_alt * mu_alt
        bad = used & (var <= 0)
        if bad.any():
            raise ValueError(
                f"score: --variance-standardize: {int(bad.sum())} matched variant(s) have "
                "zero dosage variance over the cohort (drop them, e.g. GT_MAF > 0)"
            )
        weights = weights / np.sqrt(np.where(used, var, 1.0))[:, None]
    return weights, np.where(flip, 2.0 - mu_alt, mu_alt) * used


def _rows(fh, iids, res, ct, avgs, write_sums: bool, lead=()) -> None:
    for r, iid in enumerate(iids):
        cells = [*lead, iid, str(int(ct[r])), f"{res.dosage_sum[r]:.10g}"]
        cells += [f"{avgs[r, c]:.10g}" for c in range(avgs.shape[1])]
        if write_sums:
            cells += [f"{res.sums[r, c]:.10g}" for c in range(res.sums.shape[1])]
        fh.write("\t".join(cells) + "\n")


def score_pfile(
    pfile_prefix: str,
    score_file: str,
    var_id_col: int = 1,
    allele_col: int = 2,
    weight_cols=(3,),
    header_row: str = "auto",
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
    mean_impute: bool = True,
    write_sums: bool = False,
    block_variants: int | None = None,
    write: bool = True,
    out=None,
    q_score_range=None,
    q_data_col: int = 2,
    center: bool = False,
    variance_standardize: bool = False,
) -> ScoreRunResult:
    """pgen_tpu's ``score_pfile`` with ``provider="device"``, its device
    work on ``device`` (``"cuda"``, which must be available, or ``"cpu"``).
    Same arguments otherwise: ``q_score_range`` is a (range file, data file)
    pair; with a stream ``out`` its tables are one table with a leading
    RANGE column. Under a process group each rank scores its variant
    shard, and rank 0 writes."""
    timer = StageTimer()
    with variant_mesh(device, timer) as mesh:
        return _score_pfile(pfile_prefix, score_file, var_id_col, allele_col, weight_cols,
                            header_row, var_query, sam_query, out_file, mean_impute,
                            write_sums, block_variants, write, out, q_score_range,
                            q_data_col, center, variance_standardize, mesh)


def _score_pfile(pfile_prefix, score_file, var_id_col, allele_col, weight_cols, header_row,
                 var_query, sam_query, out_file, mean_impute, write_sums, block_variants,
                 write, out, q_score_range, q_data_col, center, variance_standardize,
                 mesh) -> ScoreRunResult:
    dev, timer = mesh.device, mesh.timer
    with timer.stage("score_file"):
        table = read_score_file(score_file, var_id_col, allele_col, weight_cols, header_row)
    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(header.num_variants, rec)
    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(var_query, sam_query, pvar, psam, header, records,
                                           dev)
        sam_idx = np.flatnonzero(sam_mask)
    n_sam = len(sam_idx)
    if n_sam == 0:
        raise ValueError("score: no samples left after filtering")
    with timer.stage("match"):
        var_idx, weights, flip, unmatched, mismatched = _match(table, pvar, var_mask)
    if unmatched:
        log.warning("score: %d score line(s) had no matching kept variant", unmatched)
    if mismatched:
        log.warning("score: %d score line(s) skipped (effect allele matches neither REF nor "
                    "ALT)", mismatched)
    if len(var_idx) == 0:
        raise ValueError("score: no score variants matched the fileset")
    lo, hi = mesh.shard(len(var_idx), "score")
    with timer.stage("gather", (hi - lo) * rec):
        kept = _gather_rows(records, var_idx[lo:hi])
    subset = None if n_sam == header.num_samples else sam_idx.astype(np.int32)
    kw = {"block_variants": int(block_variants)} if block_variants else {}

    mu_eff = None
    if center or variance_standardize:
        if not mean_impute:
            raise ValueError(
                "score: center/variance-standardize require mean imputation "
                "(drop --no-mean-imputation)"
            )
        with timer.stage("moments", kept.shape[0] * rec):
            weights, mu_eff = _effect_means(kept, header.num_samples, subset, flip, weights,
                                            variance_standardize, dev, timer)

    def run(rows):
        """Scores of the matched variants ``rows`` (every one, slice(None), or
        an index array), this rank's shard of them scored here, centered
        when asked; returns (result, ALLELE_CT, averages)."""
        if isinstance(rows, slice):
            mine, rows_kept = np.arange(lo, hi), kept
        else:
            mine = rows[(rows >= lo) & (rows < hi)]
            rows_kept = kept[mine - lo]
        with timer.stage("score", rows_kept.shape[0] * rec):
            res = score_mesh(rows_kept, header.num_samples, weights[mine], flip[mine], dev,
                             mean_impute=mean_impute, sample_idx=subset, timer=timer, **kw)
        if mu_eff is not None:
            res = res._replace(sums=res.sums - (mu_eff[rows] @ weights[rows])[None, :])
        return res, res.allele_ct, res.sums / np.maximum(res.allele_ct, 1)[:, None]

    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]
    hdr = ["#IID", "ALLELE_CT", "DOSAGE_SUM"] + [f"{n}_AVG" for n in table.names]
    if write_sums:
        hdr += [f"{n}_SUM" for n in table.names]
    if q_score_range is not None:
        ranges = read_q_ranges(q_score_range[0])
        vals = read_q_data(q_score_range[1], q_data_col)
        pvar_ids = pvar.get_column_strs("ID")
        v = np.array([vals.get(pvar_ids[int(r)], np.nan) for r in var_idx])
        base = out_file or pfile_prefix
        if base.endswith(".sscore"):
            base = base[: -len(".sscore")]
        scored = []
        for name, rlo, rhi in ranges:
            with np.errstate(invalid="ignore"):
                sel = np.flatnonzero(~np.isnan(v) & (v >= rlo) & (v <= rhi))
            if sel.size == 0:
                log.warning("score: --q-score-range %s matched no variants", name)
                continue
            scored.append((name, *run(sel), int(sel.size)))
        mesh.report_ranks()
        if out is not None and mesh.rank == 0:
            out.write("\t".join(["#RANGE"] + [h.lstrip("#") for h in hdr]) + "\n")
        out_paths, last = [], None
        for name, res, ct, avgs, n_sel in scored:
            if out is not None:
                path = f"<stream>.{name}"
                if mesh.rank == 0:
                    with timer.stage("emit"):
                        _rows(out, iids, res, ct, avgs, write_sums, lead=(name,))
            else:
                path = f"{base}.{name}.sscore"
                if write and mesh.rank == 0:
                    with timer.stage("emit"), open(path, "w") as fh:
                        fh.write("\t".join(hdr) + "\n")
                        _rows(fh, iids, res, ct, avgs, write_sums)
            out_paths.append(path)
            last = (res, ct, avgs, n_sel)
        if last is None:
            raise ValueError("score: no --q-score-range range matched any variant")
        res, ct, avgs, n_scored = last
        out_path = "; ".join(out_paths)
    else:
        res, ct, avgs = run(slice(None))
        mesh.report_ranks()
        n_scored = len(var_idx)
        out_path = out_file or f"{pfile_prefix}.sscore"
        if write and mesh.rank == 0:
            with timer.stage("emit"):
                cm = contextlib.nullcontext(out) if out is not None else open(out_path, "w")
                with cm as fh:
                    fh.write("\t".join(hdr) + "\n")
                    _rows(fh, iids, res, ct, avgs, write_sums)
        if out is not None:
            out_path = None
    log.info("score (%s): %s", dev, timer.report())
    return ScoreRunResult(
        num_scored=n_scored,
        num_unmatched=unmatched,
        num_mismatched=mismatched,
        num_samples=n_sam,
        names=list(table.names),
        sums=res.sums,
        avgs=avgs,
        allele_ct=ct,
        dosage_sum=res.dosage_sum,
        out_path=out_path,
        timer=timer,
    )
