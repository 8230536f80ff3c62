"""`fst` on one GPU: the port of ``pgen_tpu/pipeline/fst.py``.

Fixation-index estimation between cohorts (plink2 --fst analog).

Extension over the reference (a query/filter tool,
pgen-rs/src/pfile.rs — no analytics); mirrors plink2's
`--fst CATPHENO [method=hudson|wc] [report-variants]` surface:

    pgen-tpu fst PREFIX --pheno-name POP            # psam category column
    pgen-tpu fst PREFIX --within clusters.txt       # plink --within file
    ... --method wc --report-variants

Estimators (both ratio-of-sums across variants, the standard
block-consistent form plink2 uses):

  * Hudson (Bhatia, Patterson, Sankararaman, Price 2013, eq. 10) —
    plink2's default: per variant, with sample alt frequencies p1, p2
    and ALLELE counts a1, a2 (2x called diploids),
        N = (p1-p2)^2 - p1(1-p1)/(a1-1) - p2(1-p2)/(a2-1)
        D = p1(1-p2) + p2(1-p1)
    Fst = sum N / sum D over variants with a_i >= 2 and D > 0.

  * Weir-Cockerham 1984 (theta-hat, r = 2 populations, diploid, using
    the observed heterozygote share): with n_i called individuals,
    nbar = (n1+n2)/2, nc = n1+n2 - (n1^2+n2^2)/(n1+n2),
    pbar = (n1 p1 + n2 p2)/(n1+n2),
    s2 = (n1 (p1-pbar)^2 + n2 (p2-pbar)^2)/nbar,
    hbar = (het1+het2)/(n1+n2):
        a = nbar/nc * (s2 - (pbar(1-pbar) - s2/2 - hbar/4)/(nbar-1))
        b = nbar/(nbar-1) * (pbar(1-pbar) - s2/2 - (2nbar-1)/(4nbar) hbar)
        c = hbar/2
    Fst = sum a / sum (a+b+c) over variants with n_i >= 1 each side,
    nbar > 1 and nc > 0.

Every per-pair input reduces to the (V, 4) per-cohort genotype
histograms, counted on the device for every cohort at once (K14
``gt_counts_masked``: one read of each block of kept records, one keep
mask a cohort, up to ``MAX_MASKS`` cohorts a launch), whatever the number
of pairs.

Outputs (plink2 file layout; VARIANT_CT is an extension column):
    {out}.fst.summary                 #POP1 POP2 {M}_FST VARIANT_CT
    {out}.{pop1}.{pop2}.fst.var       #CHROM POS ID OBS_CT {M}_FST

Copied from pgen_tpu with a device where pgen_tpu takes a provider; its
device provider counted the cohorts with numpy on the host. Stages
(``FstResult.timer``): predicates, cohorts, gather, counts, estimate.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer

_MISSING_CATS = {"", ".", "NA", "na", "NONE", "-9", "0"}


@dataclass
class FstResult:
    pairs: list          # [(pop1, pop2, fst, n_variants_used), ...]
    num_variants: int
    num_samples: int
    method: str
    out_paths: list
    timer: StageTimer = field(default_factory=StageTimer)


def _read_within(path: str) -> dict:
    """plink --within cluster file: 'IID CLUSTER' or 'FID IID CLUSTER'
    whitespace-delimited; returns {iid: category}."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            parts = ln.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) == 2:
                iid, cat = parts
            elif len(parts) >= 3:
                iid, cat = parts[1], parts[2]
            else:
                raise ValueError(
                    f"fst: --within line needs 2+ columns: {ln.rstrip()!r}"
                )
            out[iid] = cat
    return out


def _hudson(p1, p2, a1, a2):
    """Per-variant Hudson numerator/denominator + validity mask."""
    with np.errstate(invalid="ignore", divide="ignore"):
        num = (
            (p1 - p2) ** 2
            - p1 * (1.0 - p1) / np.maximum(a1 - 1.0, 1e-12)
            - p2 * (1.0 - p2) / np.maximum(a2 - 1.0, 1e-12)
        )
        den = p1 * (1.0 - p2) + p2 * (1.0 - p1)
    ok = (a1 >= 2) & (a2 >= 2) & np.isfinite(num) & np.isfinite(den)
    return num, den, ok


def _weir_cockerham(n1, n2, p1, p2, h1, h2):
    """Per-variant WC a / (a+b+c) components + validity mask."""
    with np.errstate(invalid="ignore", divide="ignore"):
        tot = n1 + n2
        nbar = tot / 2.0
        nc = tot - (n1 * n1 + n2 * n2) / np.maximum(tot, 1e-12)
        pbar = (n1 * p1 + n2 * p2) / np.maximum(tot, 1e-12)
        s2 = (
            n1 * (p1 - pbar) ** 2 + n2 * (p2 - pbar) ** 2
        ) / np.maximum(nbar, 1e-12)
        hbar = (h1 + h2) / np.maximum(tot, 1e-12)
        inner = pbar * (1.0 - pbar) - s2 / 2.0
        a = (nbar / np.maximum(nc, 1e-12)) * (
            s2 - (inner - hbar / 4.0) / np.maximum(nbar - 1.0, 1e-12)
        )
        b = (nbar / np.maximum(nbar - 1.0, 1e-12)) * (
            inner - (2.0 * nbar - 1.0) / (4.0 * nbar) * hbar
        )
        c = hbar / 2.0
    ok = (
        (n1 >= 1) & (n2 >= 1) & (nbar > 1) & (nc > 0)
        & np.isfinite(a) & np.isfinite(b) & np.isfinite(c)
    )
    return a, a + b + c, ok


def fst_pfile(
    pfile_prefix: str,
    pheno_name: str | None = None,
    pheno_file: str | None = None,
    within_file: str | None = None,
    method: str = "hudson",
    report_variants: bool = False,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
) -> FstResult:
    """See the module docstring. Exactly one of pheno_name/within_file
    selects the cohort assignment; samples with a missing category
    ('NA', '.', '', '-9', '0') are excluded, like plink2 CATPHENO."""
    if method not in ("hudson", "wc"):
        raise ValueError(f"fst: unknown method {method!r}")
    if (pheno_name is None) == (within_file is None):
        raise ValueError(
            "fst: exactly one of --pheno-name or --within is required"
        )
    if report_variants and out_file == "-":
        # validate BEFORE the summary streams: a late error would leave
        # a half-written table on stdout (same rule as glm --adjust)
        raise ValueError(
            "fst: --report-variants writes files; use a file -o, not '-'"
        )
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
    iids = psam.get_column_strs("IID")
    with timer.stage("cohorts"):
        if within_file is not None:
            cat_of = _read_within(within_file)
            cats = [cat_of.get(iid, "") for iid in iids]
        elif pheno_file is not None:
            from pgen_tpu_torch.pipeline.glm_host import _external_strs

            cats = _external_strs(pheno_file, pheno_name, iids)
        else:
            cats = psam.get_column_strs(pheno_name)
        cohort_idx = {}
        for s in np.flatnonzero(sam_mask):
            cat = cats[s]
            if cat in _MISSING_CATS:
                continue
            cohort_idx.setdefault(cat, []).append(s)
    pops = sorted(cohort_idx)
    if len(pops) < 2:
        raise ValueError(
            f"fst: need >= 2 cohorts among kept samples, got {len(pops)} "
            f"({', '.join(pops) or 'none'})"
        )
    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)
    with timer.stage("counts", kept.nbytes):
        from pgen_tpu_torch.ops.gt_stats import gt_counts_subsets

        per_pop = gt_counts_subsets(
            kept, [np.asarray(cohort_idx[pop], np.int32) for pop in pops], device
        )
        pop_counts = {pop: per_pop[:, p] for p, pop in enumerate(pops)}
    mname = "HUDSON_FST" if method == "hudson" else "WC_FST"
    base = out_file or pfile_prefix
    chroms = pvar.get_column_strs("CHROM")
    poss = pvar.get_column_strs("POS")
    ids = pvar.get_column_strs("ID")
    pairs = []
    out_paths = []
    with timer.stage("estimate"):
        summary_path = f"{base}.fst.summary"
        sfh = sys.stdout if out_file == "-" else open(summary_path, "w")
        try:
            sfh.write(f"#POP1\tPOP2\t{mname}\tVARIANT_CT\n")
            for i in range(len(pops)):
                for j in range(i + 1, len(pops)):
                    c1, c2 = pop_counts[pops[i]], pop_counts[pops[j]]
                    n1 = (c1[:, 0] + c1[:, 1] + c1[:, 2]).astype(np.float64)
                    n2 = (c2[:, 0] + c2[:, 1] + c2[:, 2]).astype(np.float64)
                    a1, a2 = 2.0 * n1, 2.0 * n2
                    with np.errstate(invalid="ignore", divide="ignore"):
                        p1 = (c1[:, 1] + 2.0 * c1[:, 2]) / np.maximum(a1, 1e-12)
                        p2 = (c2[:, 1] + 2.0 * c2[:, 2]) / np.maximum(a2, 1e-12)
                    if method == "hudson":
                        num, den, ok = _hudson(p1, p2, a1, a2)
                    else:
                        num, den, ok = _weir_cockerham(
                            n1, n2, p1, p2,
                            c1[:, 1].astype(np.float64),
                            c2[:, 1].astype(np.float64),
                        )
                    # a monomorphic-in-both site has D == 0: no information
                    ok &= den != 0.0
                    used = int(ok.sum())
                    tot_d = float(den[ok].sum())
                    fst = float(num[ok].sum() / tot_d) if tot_d else float("nan")
                    pairs.append((pops[i], pops[j], fst, used))
                    fcell = "NA" if np.isnan(fst) else f"{fst:.6g}"
                    sfh.write(f"{pops[i]}\t{pops[j]}\t{fcell}\t{used}\n")
                    if report_variants:
                        # cohort labels are user data: a path separator
                        # in one must not change the output directory
                        s1 = pops[i].replace(os.sep, "_")
                        s2 = pops[j].replace(os.sep, "_")
                        vpath = f"{base}.{s1}.{s2}.fst.var"
                        out_paths.append(vpath)
                        with np.errstate(invalid="ignore", divide="ignore"):
                            pv = np.where(ok, num / np.where(den == 0, 1, den),
                                          np.nan)
                        with open(vpath, "w") as vf:
                            vf.write(f"#CHROM\tPOS\tID\tOBS_CT\t{mname}\n")
                            for r, v in enumerate(var_idx):
                                v = int(v)
                                cell = (
                                    "NA" if not ok[r] else f"{pv[r]:.6g}"
                                )
                                vf.write(
                                    f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t"
                                    f"{int(n1[r] + n2[r])}\t{cell}\n"
                                )
        finally:
            if sfh is not sys.stdout:
                sfh.close()
                out_paths.insert(0, summary_path)
    n_kept_sam = sum(len(v) for v in cohort_idx.values())
    return FstResult(
        pairs, len(var_idx), n_kept_sam, method, out_paths, timer
    )
