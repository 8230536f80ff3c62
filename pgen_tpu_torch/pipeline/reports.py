"""plink2 report-file family on one GPU: the port of
``pgen_tpu/pipeline/reports.py``, a device in place of pgen_tpu's
provider: `freq`, `gcount`, `missing`, `hardy`, `het`.

Extensions over the reference (a query/filter tool,
pgen-rs/README.md:3-5) mirroring plink2's standard report flags,
with plink2's file layouts so downstream tooling drops in:

    freq     --freq     -> {out}.afreq   #CHROM ID REF ALT ALT_FREQS OBS_CT
    gcount   --geno-counts -> {out}.gcount
    missing  --missing  -> {out}.vmiss   #CHROM ID MISSING_CT OBS_CT F_MISS
                           {out}.smiss   #IID   MISSING_CT OBS_CT F_MISS
    hardy    --hardy    -> {out}.hardy   #CHROM ID A1 AX HOM_A1_CT
                           HET_A1_CT TWO_AX_CT O(HET_A1) E(HET_A1) P
    het      --het      -> {out}.het     #IID O(HOM) E(HOM) OBS_CT F

All reports are one pass over the packed matrix on ``device``: per-variant
rows come from the (V, 4) genotype-count reduction (K8
``gt_counts_device`` over every sample, K14 ``gt_counts_masked`` over a
kept subset), per-sample rows from the column-axis reduction (K9
``sample_counts_device``), and `het`'s per-sample expected-hom sums from
the decoded codes (K1 ``unpack_codes``, the cohort's columns kept with
``index_select``): O(HOM) and OBS_CT integer sums, E(HOM) an f64 product on
the device (pgen_tpu's is a host f64 dgemv, printed at .6g). The HWE P
column uses the exact mid-p-less SNPHWE test (the port's copy of
``ops/hwe.py``, on the host).

Conventions pinned here (documented, testable):
  * A1 = ALT, AX = REF in `hardy` (plink2 counts A1 = alt by default);
    E(HET_A1) is the small-sample-corrected expectation 2AB/(T(T-1))·T/2
    over called alleles, like plink2's output.
  * `het`'s F = (O(HOM) - E(HOM)) / (OBS_CT - E(HOM)) with the plink
    method-of-moments E(HOM)_s = sum over the sample's CALLED variants of
    1 - 2·A·B / (T·(T-1)) (A/B = cohort alt/ref allele counts at the
    variant, T = A + B) — variants with T < 2 or no polymorphism
    contribute their degenerate expectation of 1.

Every function is copied from pgen_tpu with a device where pgen_tpu takes a
provider; ``_counts`` and ``het_expected_hom`` count on it. Stages
(``ReportResult.timer``): predicates, gather, counts, then per report
sample_counts, hwe, expected_hom and the emit stages.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class ReportResult:
    kind: str
    num_variants: int
    num_samples: int
    out_paths: list
    timer: StageTimer = field(default_factory=StageTimer)


def _load(pfile_prefix, var_query, sam_query, device, timer):
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
    return header, pvar, psam, kept, var_idx, sam_idx


def _counts(kept, header, sam_idx, device):
    from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset

    if len(sam_idx) == header.num_samples:
        return gt_counts(kept, header.num_samples, device)
    return gt_counts_subset(kept, sam_idx.astype(np.int32), device)


def _open_out(path):
    return sys.stdout if path == "-" else open(path, "w")


def report_freq(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    counts: bool = False,
) -> ReportResult:
    """plink2 --freq: per-variant ALT frequency table ({out}.afreq).

    counts=True switches to plink2's `--freq counts` layout: integer
    ALT_CTS instead of ALT_FREQS, written to {out}.acount."""
    device = resolve_device(device)
    timer = StageTimer()
    header, pvar, psam, kept, var_idx, sam_idx = _load(
        pfile_prefix, var_query, sam_query, device, timer
    )
    with timer.stage("counts", kept.nbytes):
        c = _counts(kept, header, sam_idx, device)
    ac = c[:, 1] + 2 * c[:, 2]
    an = 2 * (c[:, 0] + c[:, 1] + c[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(an > 0, ac / np.maximum(an, 1), np.nan)
    ext = ".acount" if counts else ".afreq"
    out = out_file or f"{pfile_prefix}{ext}"
    chroms = pvar.get_column_strs("CHROM")
    ids = pvar.get_column_strs("ID")
    refs = pvar.get_column_strs("REF")
    alts = pvar.get_column_strs("ALT")
    with timer.stage("emit"):
        fh = _open_out(out)
        try:
            val_col = "ALT_CTS" if counts else "ALT_FREQS"
            fh.write(f"#CHROM\tID\tREF\tALT\t{val_col}\tOBS_CT\n")
            for r, v in enumerate(var_idx):
                v = int(v)
                if counts:
                    val = str(int(ac[r]))
                else:
                    val = "NA" if np.isnan(af[r]) else f"{af[r]:.6g}"
                fh.write(
                    f"{chroms[v]}\t{ids[v]}\t{refs[v]}\t{alts[v]}\t"
                    f"{val}\t{int(an[r])}\n"
                )
        finally:
            if fh is not sys.stdout:
                fh.close()
    return ReportResult(
        "freq", len(var_idx), len(sam_idx),
        [] if out_file == "-" else [out], timer,
    )


def report_gcount(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
) -> ReportResult:
    """plink2 --geno-counts: per-variant genotype-class counts
    ({out}.gcount). Diploid columns only — mode-0x02 has no haploid
    calls, so plink2's HAP_REF_CT/HAP_ALT_CT columns are omitted
    (documented deviation)."""
    device = resolve_device(device)
    timer = StageTimer()
    header, pvar, psam, kept, var_idx, sam_idx = _load(
        pfile_prefix, var_query, sam_query, device, timer
    )
    with timer.stage("counts", kept.nbytes):
        c = _counts(kept, header, sam_idx, device)
    out = out_file or f"{pfile_prefix}.gcount"
    chroms = pvar.get_column_strs("CHROM")
    ids = pvar.get_column_strs("ID")
    refs = pvar.get_column_strs("REF")
    alts = pvar.get_column_strs("ALT")
    with timer.stage("emit"):
        fh = _open_out(out)
        try:
            fh.write("#CHROM\tID\tREF\tALT\tHOM_REF_CT\t"
                     "HET_REF_ALT_CTS\tTWO_ALT_GENO_CTS\tMISSING_CT\n")
            for r, v in enumerate(var_idx):
                v = int(v)
                fh.write(
                    f"{chroms[v]}\t{ids[v]}\t{refs[v]}\t{alts[v]}\t"
                    f"{int(c[r, 0])}\t{int(c[r, 1])}\t{int(c[r, 2])}\t"
                    f"{int(c[r, 3])}\n"
                )
        finally:
            if fh is not sys.stdout:
                fh.close()
    return ReportResult(
        "gcount", len(var_idx), len(sam_idx),
        [] if out_file == "-" else [out], timer,
    )


def report_missing(
    pfile_prefix: str,
    out_prefix: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
) -> ReportResult:
    """plink2 --missing: {out}.vmiss (per variant) + {out}.smiss (per
    sample). The per-sample pass reports the kept cohort only."""
    device = resolve_device(device)
    timer = StageTimer()
    header, pvar, psam, kept, var_idx, sam_idx = _load(
        pfile_prefix, var_query, sam_query, device, timer
    )
    n_var, n_sam = len(var_idx), len(sam_idx)
    with timer.stage("counts", kept.nbytes):
        c = _counts(kept, header, sam_idx, device)
    out = out_prefix or pfile_prefix
    chroms = pvar.get_column_strs("CHROM")
    ids = pvar.get_column_strs("ID")
    with timer.stage("emit_vmiss"):
        with open(f"{out}.vmiss", "w") as fh:
            fh.write("#CHROM\tID\tMISSING_CT\tOBS_CT\tF_MISS\n")
            for r, v in enumerate(var_idx):
                v = int(v)
                miss = int(c[r, 3])
                fh.write(
                    f"{chroms[v]}\t{ids[v]}\t{miss}\t{n_sam}\t"
                    f"{(miss / n_sam) if n_sam else 0:.6g}\n"
                )
    from pgen_tpu_torch.ops.gt_stats import sample_counts

    with timer.stage("sample_counts", kept.nbytes):
        sc = sample_counts(kept, header.num_samples, device)[sam_idx]
    iids = psam.get_column_strs("IID")
    with timer.stage("emit_smiss"):
        with open(f"{out}.smiss", "w") as fh:
            fh.write("#IID\tMISSING_CT\tOBS_CT\tF_MISS\n")
            for row, s in enumerate(sam_idx):
                miss = int(sc[row, 3])
                fh.write(
                    f"{iids[int(s)]}\t{miss}\t{n_var}\t"
                    f"{(miss / n_var) if n_var else 0:.6g}\n"
                )
    return ReportResult(
        "missing", n_var, n_sam, [f"{out}.vmiss", f"{out}.smiss"], timer
    )


def report_hardy(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    midp: bool = False,
) -> ReportResult:
    """plink2 --hardy: per-variant HWE table with the exact SNPHWE P.
    midp=True applies the mid-p adjustment (plink2 `--hardy midp`)."""
    from pgen_tpu_torch.ops.hwe import hwe_exact_p

    device = resolve_device(device)
    timer = StageTimer()
    header, pvar, psam, kept, var_idx, sam_idx = _load(
        pfile_prefix, var_query, sam_query, device, timer
    )
    with timer.stage("counts", kept.nbytes):
        c = _counts(kept, header, sam_idx, device)
    homref = c[:, 0].astype(np.int64)
    het = c[:, 1].astype(np.int64)
    homalt = c[:, 2].astype(np.int64)
    nobs = homref + het + homalt
    a1 = 2 * homalt + het  # alt allele count
    ax = 2 * homref + het
    t = a1 + ax
    with np.errstate(divide="ignore", invalid="ignore"):
        o_het = np.where(nobs > 0, het / np.maximum(nobs, 1), np.nan)
        # small-sample-corrected expected het FREQUENCY: 2*A*B/(T*(T-1))
        e_het = np.where(t > 1, 2.0 * a1 * ax / np.maximum(t * (t - 1), 1), np.nan)
    with timer.stage("hwe"):
        p = np.where(nobs > 0, hwe_exact_p(c, midp=midp), np.nan)  # no data -> NA
    out = out_file or f"{pfile_prefix}.hardy"
    chroms = pvar.get_column_strs("CHROM")
    ids = pvar.get_column_strs("ID")
    refs = pvar.get_column_strs("REF")
    alts = pvar.get_column_strs("ALT")

    def fmt(x):
        return "NA" if np.isnan(x) else f"{x:.6g}"

    with timer.stage("emit"):
        fh = _open_out(out)
        try:
            fh.write(
                "#CHROM\tID\tA1\tAX\tHOM_A1_CT\tHET_A1_CT\tTWO_AX_CT\t"
                "O(HET_A1)\tE(HET_A1)\tP\n"
            )
            for r, v in enumerate(var_idx):
                v = int(v)
                fh.write(
                    f"{chroms[v]}\t{ids[v]}\t{alts[v]}\t{refs[v]}\t"
                    f"{int(homalt[r])}\t{int(het[r])}\t{int(homref[r])}\t"
                    f"{fmt(o_het[r])}\t{fmt(e_het[r])}\t{fmt(p[r])}\n"
                )
        finally:
            if fh is not sys.stdout:
                fh.close()
    return ReportResult(
        "hardy", len(var_idx), len(sam_idx),
        [] if out_file == "-" else [out], timer,
    )


def het_expected_hom(
    kept: np.ndarray,
    num_samples: int,
    sam_idx: np.ndarray,
    counts: np.ndarray,
    device,
    block_variants: int = 1 << 13,
):
    """Per-sample (O(HOM), E(HOM), OBS_CT) for the `het` report.

    E(HOM)_s = sum over variants where s is CALLED of e_v,
    e_v = 1 - 2·A·B/(T·(T-1)) — the plink method-of-moments expectation
    from cohort allele counts. Per block of rows on ``device``: K1 decodes
    the records, ``index_select`` keeps the cohort's columns, O(HOM) and
    OBS_CT are integer sums and E(HOM) one (V,) x (V, S_kept) f64 product
    (pgen_tpu's host dgemv; its .6g text leaves f32 no room).
    """
    from pgen_tpu_torch.ops.gt_stats import stage_blocks
    from pgen_tpu_torch.ops.unpack import unpack_codes

    dev = resolve_device(device)
    nvar = kept.shape[0]
    n_sam = len(sam_idx)
    a1 = (counts[:, 1] + 2 * counts[:, 2]).astype(np.float64)
    ax = (counts[:, 1] + 2 * counts[:, 0]).astype(np.float64)
    t = a1 + ax
    with np.errstate(divide="ignore", invalid="ignore"):
        e_v = np.where(t > 1, 1.0 - 2.0 * a1 * ax / np.maximum(t * (t - 1), 1), 1.0)
    o_hom = torch.zeros(n_sam, dtype=torch.int64, device=dev)
    e_hom = torch.zeros(n_sam, dtype=torch.float64, device=dev)
    obs = torch.zeros(n_sam, dtype=torch.int64, device=dev)
    cols = torch.from_numpy(np.asarray(sam_idx, dtype=np.int64)).to(dev)
    e_dev = torch.from_numpy(e_v).to(dev)
    bv = min(block_variants, max(nvar, 1))
    for lo, hi, block in stage_blocks(kept, dev, bv):
        codes = unpack_codes(block, num_samples).index_select(1, cols)
        called = codes != 3
        o_hom += ((codes == 0) | (codes == 2)).sum(0)
        obs += called.sum(0)
        e_hom += e_dev[lo:hi] @ called.to(torch.float64)
    return o_hom.cpu().numpy(), e_hom.cpu().numpy(), obs.cpu().numpy()


def report_het(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
) -> ReportResult:
    """plink2 --het: per-sample observed/expected hom counts and the
    method-of-moments inbreeding coefficient F."""
    device = resolve_device(device)
    timer = StageTimer()
    header, pvar, psam, kept, var_idx, sam_idx = _load(
        pfile_prefix, var_query, sam_query, device, timer
    )
    with timer.stage("counts", kept.nbytes):
        c = _counts(kept, header, sam_idx, device)
    with timer.stage("expected_hom", kept.nbytes):
        o_hom, e_hom, obs = het_expected_hom(
            kept, header.num_samples, sam_idx, c, device
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = obs - e_hom
        f = np.where(np.abs(denom) > 1e-12, (o_hom - e_hom) / denom, np.nan)
    out = out_file or f"{pfile_prefix}.het"
    iids = psam.get_column_strs("IID")
    with timer.stage("emit"):
        fh = _open_out(out)
        try:
            fh.write("#IID\tO(HOM)\tE(HOM)\tOBS_CT\tF\n")
            for row, s in enumerate(sam_idx):
                fv = "NA" if np.isnan(f[row]) else f"{f[row]:.6g}"
                fh.write(
                    f"{iids[int(s)]}\t{int(o_hom[row])}\t{e_hom[row]:.6g}\t"
                    f"{int(obs[row])}\t{fv}\n"
                )
        finally:
            if fh is not sys.stdout:
                fh.close()
    return ReportResult(
        "het", len(var_idx), len(sam_idx),
        [] if out_file == "-" else [out], timer,
    )
