"""`stats` on one GPU: the port of ``pgen_tpu/pipeline/stats.py``, a
dataset-level genotype summary.

A bcftools-stats-flavored report computed from one pass over the packed
matrix (genotype-count reductions on ``device`` -- K8 over every sample,
K14 over a kept subset, K9 for ``--per-sample`` -- no decode to text).
Supports the same --include-var/--include-sam predicates as filter, so the
summary covers an arbitrary cohort/variant subset. Output goes to stdout as
TSV-ish lines (stable, greppable); diagnostics to stderr.

Copied from pgen_tpu with a device where pgen_tpu takes a provider.
"""

from __future__ import annotations

import sys

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows


def _variant_class_stats(pvar, var_idx: np.ndarray) -> dict:
    """Classify kept variants from the REF/ALT columns (vectorized over
    the padded byte matrices — no per-row string work).

    Classes (bcftools-stats flavor): SNP (1bp A/C/G/T on both sides,
    case-folded), indel (single ALT allele, length change), MNP (equal
    multi-bp lengths), multiallelic (ALT contains ','), other (symbolic
    alleles etc.). SNPs split into transitions (A<->G, C<->T) and
    transversions; ts/tv is their ratio.
    """
    ref_mat, ref_len = pvar.get_column_padded("REF")
    alt_mat, alt_len = pvar.get_column_padded("ALT")
    ref_mat, ref_len = ref_mat[var_idx], ref_len[var_idx]
    alt_mat, alt_len = alt_mat[var_idx], alt_len[var_idx]

    multi = (alt_mat == ord(",")).any(axis=1)
    r0 = ref_mat[:, 0] & 0xDF  # ASCII upper fold
    a0 = alt_mat[:, 0] & 0xDF

    def is_base(b):
        return (b == ord("A")) | (b == ord("C")) | (b == ord("G")) | (b == ord("T"))

    snp = (ref_len == 1) & (alt_len == 1) & is_base(r0) & is_base(a0) & ~multi
    # purines A/G fold to the same bit pattern trick: transition iff both
    # purine or both pyrimidine and bases differ
    purine = lambda b: (b == ord("A")) | (b == ord("G"))  # noqa: E731
    ts = snp & (r0 != a0) & (purine(r0) == purine(a0))
    tv = snp & (r0 != a0) & (purine(r0) != purine(a0))
    # symbolic/breakend alleles are not sequence variants
    symbolic = (
        (alt_mat[:, 0] == ord("<"))
        | (alt_mat == ord("[")).any(axis=1)
        | (alt_mat == ord("]")).any(axis=1)
        | (alt_mat[:, 0] == ord("*"))
    )
    indel = ~snp & ~multi & ~symbolic & (ref_len != alt_len)
    mnp = ~snp & ~multi & ~symbolic & (ref_len == alt_len) & (ref_len > 1)
    n = len(var_idx)
    n_ts, n_tv = int(ts.sum()), int(tv.sum())
    counted = int(snp.sum() + indel.sum() + mnp.sum() + multi.sum())
    return {
        "snps": int(snp.sum()),
        "indels": int(indel.sum()),
        "mnps": int(mnp.sum()),
        "multiallelic": int(multi.sum()),
        "other": n - counted,
        "transitions": n_ts,
        "transversions": n_tv,
        "ts_tv": (n_ts / n_tv) if n_tv else float("inf") if n_ts else 0.0,
    }


def _per_chrom_counts(pvar, var_idx: np.ndarray) -> list:
    """Kept-variant count per contig, in first-appearance order."""
    chrom_mat, chrom_len = pvar.get_column_padded("CHROM")
    sub = chrom_mat[var_idx]
    # unique over fixed-width rows: view as void for one-shot grouping
    v = np.ascontiguousarray(sub).view(
        np.dtype((np.void, sub.shape[1] if sub.shape[1] else 1))
    )[:, 0]
    uniq, first, cnts = np.unique(v, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    out = []
    for k in order:
        name = bytes(uniq[k].tobytes()).rstrip(b"\x00").decode()
        out.append((name, int(cnts[k])))
    return out


def genotype_stats(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    per_sample: bool = False,
    out=None,
) -> dict:
    device = resolve_device(device)
    out = sys.stdout if out is None else out

    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")

    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    var_mask, sam_mask = compute_masks(
        var_query, sam_query, pvar, psam, header, records, device
    )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    kept = _gather_rows(records, var_idx)

    from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset

    if len(sam_idx) == header.num_samples:
        counts = gt_counts(kept, header.num_samples, device)
    else:
        counts = gt_counts_subset(kept, sam_idx.astype(np.int32), device)

    n_var = len(var_idx)
    n_sam = len(sam_idx)
    tot = counts.sum(axis=0)  # (4,)
    calls = int(tot.sum())
    missing = int(tot[3])
    called = calls - missing
    ac = counts[:, 1] + 2 * counts[:, 2]
    an = 2 * (counts[:, 0] + counts[:, 1] + counts[:, 2])
    nonref = int((ac > 0).sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(an > 0, ac / np.maximum(an, 1), 0.0)
    singletons = int((ac == 1).sum())
    stats = {
        "variants": n_var,
        "samples": n_sam,
        "genotypes": calls,
        "hom_ref": int(tot[0]),
        "het": int(tot[1]),
        "hom_alt": int(tot[2]),
        "missing": missing,
        "missing_rate": missing / calls if calls else 0.0,
        "nonref_variants": nonref,
        "singletons": singletons,
        "mean_af": float(af.mean()) if n_var else 0.0,
        "het_hom_ratio": (int(tot[1]) / int(tot[2])) if tot[2] else float("inf"),
    }
    stats.update(_variant_class_stats(pvar, var_idx))
    for k, v in stats.items():
        if isinstance(v, float):
            out.write(f"{k}\t{v:.6g}\n")
        else:
            out.write(f"{k}\t{v}\n")

    for name, cnt in _per_chrom_counts(pvar, var_idx):
        out.write(f"chrom\t{name}\t{cnt}\n")

    if per_sample:
        # column-axis reduction over the kept variants' records; computed
        # for all samples (one pass), reported for the kept cohort
        from pgen_tpu_torch.ops.gt_stats import sample_counts

        sc = sample_counts(kept, header.num_samples, device)[sam_idx]
        iids = psam.get_column_strs("IID")
        out.write("#IID\tHOM_REF\tHET\tHOM_ALT\tMISSING\tNOBS\tMISSING_RATE\n")
        for row, s in enumerate(sam_idx):
            hr, het_n, ha, mi = (int(x) for x in sc[row])
            nobs = hr + het_n + ha
            rate = mi / n_var if n_var else 0.0
            out.write(
                f"{iids[int(s)]}\t{hr}\t{het_n}\t{ha}\t{mi}\t{nobs}\t{rate:.6g}\n"
            )
        stats["per_sample"] = sc
    return stats
