"""pgen_tpu's argument parser, copied from ``pgen_tpu/cli.py``
(``build_arg_parser`` whole, and ``_version``), so that every subcommand
parses as pgen_tpu's does and the port's CLI (``cli.py``) can refuse what
it does not serve yet by name. Only the imports differ.
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pgen-tpu",
        description="Query and filter PLINK2 .pgen filesets (TPU-native pgen engine).",
    )
    p.add_argument("--version", action="version", version=_version())
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser(
        "query",
        help="Queries the pgen, outputting to stdout.",
        description=(
            "Queries the pgen, outputting to stdout. All expressions have as "
            "variables the metadata being queried; e.g. when querying "
            "variants, CHROM and ID hold their respective values. "
            "Genotype extensions (each opts into one pass over the packed "
            "records): GT_* stat variables (GT_AC, GT_MAF, GT_HWE_P, ...); "
            "per-sample indexing GT(\"IID\")/GT(i) (Int alt dosage, "
            "missing = -9) and GT_TEXT(\"IID\") (\"0/0\"... String); and "
            "GT_ROW, the whole row's genotype texts tab-joined (bcftools "
            "[%GT] analog). Under -s the GT()/GT_TEXT() argument names a "
            "variant ID/index instead."
        ),
    )
    q.add_argument(
        "pfile_prefix",
        help=(
            "The prefix of the pgen file triples. There should be three files "
            "PFILE_PREFIX.pgen, PFILE_PREFIX.psam, and PFILE_PREFIX.pvar."
        ),
    )
    q.add_argument(
        "-f",
        "--fstring",
        dest="query_fstring",
        required=True,
        help="An expression specifying what to output to stdout.",
    )
    q.add_argument(
        "-i",
        "--include",
        dest="query",
        default=None,
        help=(
            "An expression specifying which variants (default) or samples "
            "(if -s is passed) to keep."
        ),
    )
    q.add_argument(
        "-e",
        "--exclude",
        dest="query_exclude",
        default=None,
        help=(
            "An expression specifying which rows to drop (the complement "
            "of -i; AND-ed with it when both are passed)."
        ),
    )
    q.add_argument(
        "-r",
        "--regions",
        dest="regions",
        default=None,
        help=(
            "Restrict to bcftools-style regions, e.g. '19:200000-300000,20' "
            "(AND-ed with -i; variants queries only)."
        ),
    )
    q.add_argument(
        "-R",
        "--regions-file",
        dest="regions_file",
        default=None,
        help=(
            "Restrict to the regions listed in FILE: BED (.bed[.gz]), or "
            "tab-delimited CHROM POS / CHROM BEG END (1-based inclusive)."
        ),
    )
    q.add_argument(
        "-s",
        "--samples",
        dest="query_samples",
        action="store_true",
        help=(
            "When passed, the query is over the samples. Otherwise it is "
            "over the variants. Defaults false."
        ),
    )

    f = sub.add_parser(
        "filter",
        help="Filters the pgen, outputting to a VCF.",
        description=(
            "Filters the pgen, outputting to a VCF. All expressions have as "
            "variables the variant metadata, plus genotype extensions: GT_* "
            "stat variables, per-sample indexing GT(\"IID\")/GT_TEXT(\"IID\") "
            "(in --include-sam the argument names a variant instead), and "
            "DUP_*/GT_ROW whole-column variables."
        ),
    )
    f.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    f.add_argument(
        "--include-var",
        dest="var_query",
        default=None,
        help="An expression specifying which variants to keep. If not passed, keeps all variants.",
    )
    f.add_argument(
        "--include-sam",
        dest="sam_query",
        default=None,
        help="An expression specifying which samples to keep. If not passed, keeps all samples.",
    )
    f.add_argument(
        "--exclude-var",
        dest="var_exclude",
        default=None,
        help=(
            "Drop the variants matching this expression (complement of "
            "--include-var; AND-ed when both are passed; GT_* allowed)."
        ),
    )
    f.add_argument(
        "--exclude-sam",
        dest="sam_exclude",
        default=None,
        help="Drop the samples matching this expression.",
    )
    f.add_argument(
        "-r",
        "--regions",
        dest="regions",
        default=None,
        help=(
            "Restrict to bcftools-style regions: CHROM, CHROM:POS, "
            "CHROM:BEG-END, or CHROM:BEG- (comma-separated; AND-ed with "
            "--include-var)."
        ),
    )
    f.add_argument(
        "-R",
        "--regions-file",
        dest="regions_file",
        default=None,
        help=(
            "Restrict to the regions listed in FILE: BED (.bed[.gz]), or "
            "tab-delimited CHROM POS / CHROM BEG END (1-based inclusive); "
            "position lists compile to one vectorized membership sweep."
        ),
    )
    f.add_argument(
        "--samples",
        dest="samples",
        default=None,
        help=(
            "Keep only these samples (comma-separated IIDs; leading ^ "
            "excludes). AND-ed with --include-sam; output keeps .psam order."
        ),
    )
    f.add_argument(
        "--samples-file",
        dest="samples_file",
        default=None,
        help="Like --samples, one IID per line (blank/# lines skipped).",
    )
    f.add_argument(
        "--extract", dest="extract", default=None, metavar="FILE",
        help="Keep only variants whose IDs are listed in FILE, one per "
             "line (plink2 --extract; compiles to one vectorized "
             "membership sweep).",
    )
    f.add_argument(
        "--exclude-ids", dest="exclude_ids", default=None, metavar="FILE",
        help="Drop variants whose IDs are listed in FILE (plink2 "
             "--exclude; named --exclude-ids here because --exclude-var "
             "takes an expression).",
    )
    # plink2 QC sugar: desugars onto the GT_* expression machinery
    f.add_argument(
        "--maf", dest="maf", type=float, default=None, metavar="X",
        help="Keep variants with minor-allele frequency >= X over the "
             "kept cohort (plink2 --maf; sugar for GT_MAF >= X).",
    )
    f.add_argument(
        "--max-maf", dest="max_maf", type=float, default=None, metavar="X",
        help="Keep variants with MAF <= X (plink2 --max-maf).",
    )
    f.add_argument(
        "--geno", dest="geno", type=float, default=None, metavar="X",
        help="Drop variants with missing-call rate > X over the kept "
             "cohort (plink2 --geno; sugar for GT_MISSING_RATE <= X).",
    )
    f.add_argument(
        "--hwe", dest="hwe", type=float, default=None, metavar="X",
        help="Drop variants with Hardy-Weinberg exact p < X (plink2 "
             "--hwe; sugar for GT_HWE_P >= X).",
    )
    f.add_argument(
        "--hwe-midp", dest="hwe_midp", action="store_true",
        help="Use the mid-p adjusted HWE test for --hwe (plink2 "
             "'--hwe X midp'; sugar for GT_HWE_MIDP >= X).",
    )
    f.add_argument(
        "--mind", dest="mind", type=float, default=None, metavar="X",
        help="Drop samples with missing-genotype rate > X over ALL "
             "variants (plink2 --mind; sugar for the sample-axis "
             "GT_MISSING_RATE <= X).",
    )
    f.add_argument(
        "--rm-dup", dest="rm_dup", default=None,
        choices=("error", "force-first", "exclude-all", "list"),
        help="Duplicate-ID variant handling (plink2 --rm-dup): error = "
             "fail if any ID repeats; force-first = keep the first "
             "instance of each ID (sugar for DUP_FIRST); exclude-all = "
             "drop every repeated ID (sugar for DUP_UNIQUE); list = "
             "write {out}.rmdup.list and filter nothing. The "
             "retain-/exclude-mismatch modes need genotype comparison — "
             "use `diff` on the duplicates instead.",
    )
    f.add_argument(
        "-o",
        "--out",
        dest="out_file",
        default=None,
        help="The output file name (defaults to PFILE_PREFIX.pgen-rs.vcf)",
    )
    f.add_argument(
        "--out-format",
        choices=["vcf", "pgen", "bed"],
        default="vcf",
        help=(
            "Output format: vcf (default, reference-compatible), pgen "
            "(write a filtered OUT.pgen/.pvar/.psam fileset), or bed "
            "(PLINK1 OUT.bed/.bim/.fam); -o is the output prefix for "
            "fileset formats."
        ),
    )
    f.add_argument(
        "--provider",
        choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Execution provider for genotype decode + text emission.",
    )
    f.add_argument(
        "--block-variants",
        type=int,
        default=None,
        help="Variants per streamed block (default 65536).",
    )
    f.add_argument(
        "--threads",
        type=int,
        default=None,
        help="Host threads for native block emission (default: min(2, cpus)).",
    )
    f.add_argument(
        "--shards",
        type=int,
        default=None,
        help="Split the variant dimension into N shards (multi-host filtering).",
    )
    f.add_argument(
        "--workers",
        type=int,
        default=None,
        help="Run N parallel worker processes, one variant shard each.",
    )
    f.add_argument(
        "--shard-index",
        type=int,
        default=None,
        help="Emit only shard I of --shards (writes into the shared output at its offset).",
    )
    f.add_argument(
        "--index",
        action="store_true",
        help=(
            "With a .vcf.gz output: also emit a tabix index ({out}.tbi). "
            "Row offsets are known at emission time, so this never "
            "re-reads the output."
        ),
    )
    f.add_argument(
        "--index-format",
        choices=("auto", "tbi", "csi"),
        default="auto",
        help=(
            "Index flavor for --index: .tbi (tabix), .csi (no 2^29 "
            "position limit), or auto (.csi only when a position "
            "needs it)."
        ),
    )
    f.add_argument(
        "--resume",
        action="store_true",
        help=(
            "With --workers: finish a previous partially-failed run by "
            "re-running only the shards the manifest marks as not done."
        ),
    )
    f.add_argument(
        "--stats",
        action="store_true",
        help="Print per-stage timing/bandwidth to stderr.",
    )
    f.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help=(
            "Write a jax.profiler trace of the run to DIR (device-provider "
            "kernels appear on the TPU timeline; host stages as TraceMe "
            "annotations)."
        ),
    )

    st = sub.add_parser(
        "stats",
        help="Genotype summary statistics (one pass over the packed matrix).",
        description=(
            "Dataset-level genotype summary: per-code totals, missing rate, "
            "non-ref/singleton variant counts, mean allele frequency. "
            "Accepts the same include-expressions as filter."
        ),
    )
    st.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    st.add_argument("--include-var", dest="var_query", default=None)
    st.add_argument("--include-sam", dest="sam_query", default=None)
    st.add_argument("--exclude-var", dest="var_exclude", default=None)
    st.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    st.add_argument("-r", "--regions", dest="regions", default=None)
    st.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    st.add_argument("--samples", dest="samples", default=None)
    st.add_argument("--samples-file", dest="samples_file", default=None)
    st.add_argument(
        "--per-sample",
        action="store_true",
        help=(
            "Also print one TSV row per kept sample: IID, per-code counts, "
            "NOBS, missing rate (over the kept variants)."
        ),
    )
    st.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"], default="auto"
    )

    # plink2 report-file family: freq/missing/hardy/het share one flag set
    _REPORTS = {
        "freq": (
            "Per-variant ALT allele frequencies (plink2 --freq).",
            "plink2 --freq analog: one {out}.afreq row per kept variant "
            "(#CHROM ID REF ALT ALT_FREQS OBS_CT) from a single "
            "genotype-count pass over the packed matrix.",
        ),
        "missing": (
            "Missingness reports per variant and per sample (plink2 --missing).",
            "plink2 --missing analog: writes {out}.vmiss (per-variant "
            "MISSING_CT/OBS_CT/F_MISS) and {out}.smiss (per-sample) in one "
            "pass over the packed matrix.",
        ),
        "hardy": (
            "Hardy-Weinberg equilibrium table (plink2 --hardy).",
            "plink2 --hardy analog: one {out}.hardy row per kept variant "
            "with genotype counts, observed/expected het frequency, and the "
            "exact SNPHWE P (A1 = ALT).",
        ),
        "het": (
            "Per-sample heterozygosity / inbreeding F (plink2 --het).",
            "plink2 --het analog: {out}.het with per-sample O(HOM), the "
            "method-of-moments E(HOM) over each sample's called variants "
            "(a masked matvec), OBS_CT, and F.",
        ),
        "gcount": (
            "Per-variant genotype-class counts (plink2 --geno-counts).",
            "plink2 --geno-counts analog: one {out}.gcount row per kept "
            "variant with HOM_REF/HET/HOM_ALT/MISSING counts (no haploid "
            "columns — mode-0x02 stores diploid hard calls only).",
        ),
    }
    for name, (hlp, desc) in _REPORTS.items():
        rp = sub.add_parser(name, help=hlp, description=desc)
        if name == "freq":
            rp.add_argument(
                "--counts", action="store_true",
                help="Write allele COUNTS instead of frequencies "
                     "(plink2 --freq counts): {out}.acount with "
                     "ALT_CTS/OBS_CT.",
            )
        if name == "hardy":
            rp.add_argument(
                "--midp", action="store_true",
                help="Mid-p adjusted exact test (plink2 --hardy midp): "
                     "P minus half the observed configuration's "
                     "probability.",
            )
        rp.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
        rp.add_argument("-o", "--out", dest="out_file", default=None,
                        help="Output path (default {prefix}.<ext>; '-' "
                             "stdout for freq/hardy/het; missing takes a "
                             "PREFIX for .vmiss/.smiss).")
        rp.add_argument("--include-var", dest="var_query", default=None)
        rp.add_argument("--include-sam", dest="sam_query", default=None)
        rp.add_argument("--exclude-var", dest="var_exclude", default=None)
        rp.add_argument("--exclude-sam", dest="sam_exclude", default=None)
        rp.add_argument("-r", "--regions", dest="regions", default=None)
        rp.add_argument("-R", "--regions-file", dest="regions_file", default=None)
        rp.add_argument("--samples", dest="samples", default=None)
        rp.add_argument("--samples-file", dest="samples_file", default=None)
        rp.add_argument(
            "--provider", choices=["auto", "native", "device", "numpy"],
            default="auto",
        )
        rp.add_argument("--stats", action="store_true",
                        help="Print per-stage timing to stderr.")

    fs = sub.add_parser(
        "fst",
        help="Fixation index between cohorts (plink2 --fst analog).",
        description=(
            "plink2 --fst analog: Hudson (default, Bhatia 2013 "
            "ratio-of-sums) or Weir-Cockerham 1984 Fst between every "
            "pair of cohorts. Cohorts come from a categorical psam/"
            "--pheno-file column (--pheno-name) or a plink --within "
            "cluster file; 'NA'/'.'/''/'0'/'-9' mark a sample "
            "unassigned. Writes {out}.fst.summary (one row per pair) "
            "and, with --report-variants, per-pair "
            "{out}.{pop1}.{pop2}.fst.var tables."
        ),
    )
    fs.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    fs.add_argument("--pheno-name", dest="pheno_name", default=None,
                    help="Categorical cohort column (psam, or --pheno-file "
                         "TSV joined on IID).")
    fs.add_argument("--pheno", dest="pheno_file", default=None,
                    metavar="FILE",
                    help="External phenotype TSV holding --pheno-name "
                         "(plink2 --pheno).")
    fs.add_argument("--within", dest="within_file", default=None,
                    metavar="FILE",
                    help="plink --within cluster file: 'IID CLUSTER' or "
                         "'FID IID CLUSTER', whitespace-delimited.")
    fs.add_argument("--method", choices=["hudson", "wc"], default="hudson",
                    help="Estimator (plink2 --fst method=; default hudson).")
    fs.add_argument("--report-variants", action="store_true",
                    help="Also write per-variant Fst tables per pair "
                         "(plink2 --fst report-variants).")
    fs.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output base (default {prefix}; '-' streams the "
                         "summary to stdout).")
    fs.add_argument("--include-var", dest="var_query", default=None)
    fs.add_argument("--include-sam", dest="sam_query", default=None)
    fs.add_argument("--exclude-var", dest="var_exclude", default=None)
    fs.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    fs.add_argument("-r", "--regions", dest="regions", default=None)
    fs.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    fs.add_argument("--samples", dest="samples", default=None)
    fs.add_argument("--samples-file", dest="samples_file", default=None)
    fs.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
    )
    fs.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    kg = sub.add_parser(
        "king",
        help="Pairwise KING-robust kinship table (MXU matmul workload).",
        description=(
            "plink2 --make-king-table analog: estimates kinship for every "
            "sample pair from the 2-bit hard calls via the robust "
            "between-family KING estimator (Manichaikul 2010). Counts are "
            "pairwise-complete (variants where both samples are called). "
            "Output is a .kin0-flavored TSV: IID1 IID2 NSNP HETHET IBS0 "
            "KINSHIP (HETHET/IBS0 as proportions of NSNP). Accepts the "
            "same predicates/regions/sample lists as filter."
        ),
    )
    kg.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    kg.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output table path (default {prefix}.kin0, '-' stdout).")
    kg.add_argument("--include-var", dest="var_query", default=None)
    kg.add_argument("--include-sam", dest="sam_query", default=None)
    kg.add_argument("--exclude-var", dest="var_exclude", default=None)
    kg.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    kg.add_argument("-r", "--regions", dest="regions", default=None)
    kg.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    kg.add_argument("--samples", dest="samples", default=None)
    kg.add_argument("--samples-file", dest="samples_file", default=None)
    kg.add_argument(
        "--min-kinship", dest="min_kinship", type=float, default=None,
        help="Only write pairs with KINSHIP >= this (plink2 "
             "--king-table-filter analog).",
    )
    kg.add_argument(
        "--cutoff", dest="cutoff", type=float, default=None,
        help="plink2 --king-cutoff analog: greedily drop samples until no "
             "pair exceeds this kinship; writes {out}.king.cutoff.in.id / "
             ".out.id instead of a table.",
    )
    kg.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Gram-matmul engine: device = TPU MXU, native/numpy = BLAS.",
    )
    kg.add_argument("--block-variants", type=int, default=None,
                    help="Variant block height per Gram accumulation step.")
    kg.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    gn = sub.add_parser(
        "genome",
        help="Pairwise IBD-sharing table (plink --genome analog; MXU "
             "matmul workload).",
        description=(
            "plink 1.9 --genome analog: estimates pairwise IBD sharing "
            "from the 2-bit hard calls — observed IBS0/IBS1/IBS2 pair "
            "counts via indicator Gram matmuls, then Z0/Z1/Z2/PI_HAT by "
            "the method of moments from the kept cohort's allele "
            "frequencies (Purcell 2007). Output is a .genome-flavored "
            "TSV: IID1 IID2 NSNP IBS0 IBS1 IBS2 DST Z0 Z1 Z2 PI_HAT. "
            "Accepts the same predicates/regions/sample lists as filter."
        ),
    )
    gn.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    gn.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output table path (default {prefix}.genome, "
                         "'-' stdout).")
    gn.add_argument("--include-var", dest="var_query", default=None)
    gn.add_argument("--include-sam", dest="sam_query", default=None)
    gn.add_argument("--exclude-var", dest="var_exclude", default=None)
    gn.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    gn.add_argument("-r", "--regions", dest="regions", default=None)
    gn.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    gn.add_argument("--samples", dest="samples", default=None)
    gn.add_argument("--samples-file", dest="samples_file", default=None)
    gn.add_argument(
        "--min-pi-hat", dest="min_pi_hat", type=float, default=None,
        help="Only write pairs with PI_HAT >= this (plink --min analog).",
    )
    gn.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Gram-matmul engine: device = TPU MXU, native/numpy = BLAS.",
    )
    gn.add_argument("--block-variants", type=int, default=None,
                    help="Variant block height per Gram accumulation step.")
    gn.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    pc = sub.add_parser(
        "pca",
        help="Top-K principal components via the GRM (MXU matmul workload).",
        description=(
            "plink2 --pca analog: standardizes the hard-call dosage matrix "
            "(mean-imputed missing, monomorphic variants dropped), builds "
            "the S x S genetic relationship matrix on the chosen provider, "
            "and eigendecomposes on host. Writes OUT.eigenvec (#IID + "
            "unit-norm PC columns) and OUT.eigenval (descending)."
        ),
    )
    pc.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    pc.add_argument("-k", "--components", dest="k", type=int, default=10,
                    help="Number of principal components (default 10; 0 "
                         "skips the eigendecomposition for --make-rel-only "
                         "runs).")
    pc.add_argument("-o", "--out", dest="out_prefix", default=None,
                    help="Output prefix (default {prefix}.pca).")
    pc.add_argument(
        "--make-rel", dest="make_rel", nargs="?", const="bin",
        choices=("bin", "text"), default=None,
        help="Also write the relationship matrix (plink2 --make-rel "
             "analog): OUT.rel.bin (square row-major LE f64) or OUT.rel "
             "(text), plus OUT.rel.id.",
    )
    pc.add_argument("--include-var", dest="var_query", default=None)
    pc.add_argument("--include-sam", dest="sam_query", default=None)
    pc.add_argument("--exclude-var", dest="var_exclude", default=None)
    pc.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    pc.add_argument("-r", "--regions", dest="regions", default=None)
    pc.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    pc.add_argument("--samples", dest="samples", default=None)
    pc.add_argument("--samples-file", dest="samples_file", default=None)
    pc.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="GRM engine: device = TPU MXU, native/numpy = BLAS.",
    )
    pc.add_argument("--block-variants", type=int, default=None,
                    help="Variant block height per GRM accumulation step.")
    pc.add_argument("--approx", action="store_true",
                    help="Randomized subspace iteration (plink2 --pca "
                         "approx analog): streams tall-skinny matmuls "
                         "instead of materializing the S x S GRM — use "
                         "for biobank-scale cohorts (S >> 10^4).")
    pc.add_argument("--approx-iters", dest="approx_iters", type=int,
                    default=10,
                    help="Power-iteration count for --approx (default 10).")
    pc.add_argument("--seed", type=int, default=1,
                    help="RNG seed for --approx's start subspace.")
    pc.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    sc = sub.add_parser(
        "score",
        help="Polygenic scores from a weight table (MXU matmul workload).",
        description=(
            "plink2 --score analog: matches a scoring file's variant IDs "
            "against the pvar, orients dosages to the effect allele (REF "
            "matches run flipped), mean-imputes missing calls by default, "
            "and accumulates per-sample score sums as genotype x weight "
            "matmuls. Writes OUT.sscore (#IID ALLELE_CT DOSAGE_SUM "
            "<NAME>_AVG ...). Accepts the same predicates/regions/sample "
            "lists as filter."
        ),
    )
    sc.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    sc.add_argument("--score", dest="score_file", required=True,
                    help="Scoring table: variant ID, effect allele, and "
                         "numeric weight column(s); header auto-detected.")
    sc.add_argument("--variant-id-col", type=int, default=1,
                    help="1-based variant ID column (default 1).")
    sc.add_argument("--allele-col", type=int, default=2,
                    help="1-based effect allele column (default 2).")
    sc.add_argument("--score-col-nums", dest="score_col_nums", default="3",
                    help="1-based weight columns, comma/range list "
                         "(e.g. '3-5,7'; default 3). One score per column.")
    sc.add_argument("--header-row", dest="header_row", default="auto",
                    choices=("auto", "yes", "no"),
                    help="Whether line 1 of --score is a header (default "
                         "auto: header iff every weight cell and the ID "
                         "cell are non-numeric and no weight cell is a "
                         "missing token like NA).")
    sc.add_argument("--no-mean-imputation", dest="mean_impute",
                    action="store_false",
                    help="Missing calls contribute 0 and shrink that "
                         "sample's ALLELE_CT (plink2 no-mean-imputation).")
    sc.add_argument("--center", dest="center", action="store_true",
                    help="Center each variant's effect-allele dosage to "
                         "cohort mean 0 before weighting (plink2 --score "
                         "'center'; requires mean imputation).")
    sc.add_argument("--variance-standardize", dest="variance_standardize",
                    action="store_true",
                    help="Linearly transform each dosage to cohort mean 0 "
                         "variance 1 (plink2 'variance-standardize'; "
                         "errors on zero-variance variants).")
    sc.add_argument("--score-sums", dest="score_sums", action="store_true",
                    help="Also write <NAME>_SUM columns.")
    sc.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output path (default {prefix}.sscore, '-' stdout).")
    sc.add_argument("--include-var", dest="var_query", default=None)
    sc.add_argument("--include-sam", dest="sam_query", default=None)
    sc.add_argument("--exclude-var", dest="var_exclude", default=None)
    sc.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    sc.add_argument("-r", "--regions", dest="regions", default=None)
    sc.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    sc.add_argument("--samples", dest="samples", default=None)
    sc.add_argument("--samples-file", dest="samples_file", default=None)
    sc.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Dosage-matmul engine: device = TPU MXU, native/numpy = BLAS.",
    )
    sc.add_argument(
        "--q-score-range", dest="q_score_range", nargs=2, default=None,
        metavar=("RANGE_FILE", "DATA_FILE"),
        help="plink --q-score-range analog: RANGE_FILE has NAME MIN MAX "
             "rows, DATA_FILE maps variant ID -> value (e.g. GWAS P); "
             "one {out}.NAME.sscore is written per range covering the "
             "variants whose value falls in [MIN, MAX].",
    )
    sc.add_argument(
        "--q-data-col", dest="q_data_col", type=int, default=2,
        help="1-based value column of DATA_FILE (default 2).",
    )
    sc.add_argument("--block-variants", type=int, default=None,
                    help="Variant block height per matmul step.")
    sc.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    gl = sub.add_parser(
        "glm",
        help="Per-variant association GWAS (MXU matmul workload).",
        description=(
            "plink2 --glm analog: for every kept variant, regression of a "
            "psam phenotype on [intercept, covariates, alt dosage] over "
            "that variant's complete cases (no imputation). Case/control "
            "phenotypes run logistic (batched IRLS, Wald Z, OR output), "
            "quantitative ones linear OLS (Student-t) — plink2's model "
            "choice. Moments are masked matmuls on the chosen provider; "
            "solves and p-values run batched on host f64. Writes the "
            "plink2 .glm.linear/.glm.logistic column layout (TEST=ADD, "
            "A1=ALT)."
        ),
    )
    gl.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    gl.add_argument("--pheno-name", dest="pheno_name", default="PHENO1",
                    help="Phenotype column(s), comma-separated (default "
                         "PHENO1); NA/./-9 mark missing samples. Multiple "
                         "names run one GWAS each, writing one "
                         "{base}.{pheno}.glm.{model} per phenotype "
                         "(plink2 multi-phenotype behavior).")
    gl.add_argument("--pheno", dest="pheno_file", default=None,
                    metavar="FILE",
                    help="External phenotype TSV joined on IID (plink2 "
                         "--pheno); --pheno-name selects its column; "
                         "unlisted samples are missing.")
    gl.add_argument("--covar-name", dest="covar_name", default=None,
                    help="Comma-separated psam covariate columns "
                         "(numeric; M/F accepted as 1/2).")
    gl.add_argument("--covar", dest="covar_file", default=None,
                    metavar="FILE",
                    help="External covariate TSV joined on IID (plink2 "
                         "--covar); --covar-name selects its columns.")
    gl.add_argument("--condition", dest="condition", default=None,
                    metavar="IDS",
                    help="Comma-separated variant IDs whose alt dosage "
                         "joins the covariates (plink2 --condition; "
                         "missing calls mean-impute over the cohort).")
    gl.add_argument("--condition-list", dest="condition_list", default=None,
                    metavar="FILE",
                    help="Like --condition, one variant ID per line "
                         "(plink2 --condition-list).")
    gm = gl.add_mutually_exclusive_group()
    gm.add_argument("--linear", dest="model", action="store_const",
                    const="linear", default="auto",
                    help="Force OLS even for a case/control phenotype.")
    gm.add_argument("--logistic", dest="model", action="store_const",
                    const="logistic",
                    help="Force logistic (needs a 1/2- or 0/1-coded "
                         "phenotype). Default: auto like plink2 — "
                         "case/control runs logistic, quantitative OLS.")
    gl.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output path (default "
                         "{prefix}.{pheno}.glm.linear, '-' stdout).")
    gl.add_argument("--include-var", dest="var_query", default=None)
    gl.add_argument("--include-sam", dest="sam_query", default=None)
    gl.add_argument("--exclude-var", dest="var_exclude", default=None)
    gl.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    gl.add_argument("-r", "--regions", dest="regions", default=None)
    gl.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    gl.add_argument("--samples", dest="samples", default=None)
    gl.add_argument("--samples-file", dest="samples_file", default=None)
    gl.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Moment-matmul engine: device = TPU MXU, native/numpy = BLAS.",
    )
    gl.add_argument("--block-variants", type=int, default=None,
                    help="Variant block height per moment-matmul step.")
    gf = gl.add_mutually_exclusive_group()
    gf.add_argument("--firth-fallback", dest="firth", action="store_const",
                    const="fallback", default="fallback",
                    help="Re-fit non-converged logistic sites with Firth "
                         "penalized regression (plink2 --glm "
                         "firth-fallback; the default).")
    gf.add_argument("--firth", dest="firth", action="store_const",
                    const="always",
                    help="Fit every logistic site with Firth regression "
                         "(plink2 --glm firth).")
    gf.add_argument("--no-firth", dest="firth", action="store_const",
                    const="none",
                    help="Report non-converged logistic sites as NA "
                         "(plink2 --glm no-firth).")
    gl.add_argument(
        "--modifier", dest="modifier", default=None,
        choices=("genotypic", "hethom", "dominant", "recessive"),
        help="plink2 --glm model modifier: genotypic = ADD + DOMDEV + "
             "joint GENO_2DF rows; hethom = HOM + HET + GENO_2DF; "
             "dominant/recessive = a single DOM/REC recoded-dosage test. "
             "Works with both models (the joint stat is F for linear, "
             "Wald chi-square for logistic); mutually exclusive with "
             "--interaction.",
    )
    gl.add_argument(
        "--interaction", action="store_true",
        help="plink2 '--glm interaction': add dosage x covariate terms "
             "to the design and report each (ADD plus ADDxCOVAR rows in "
             "the TEST column). Linear solves closed-form; logistic runs "
             "the interaction IRLS (firth-fallback, like the base "
             "model).",
    )
    gl.add_argument(
        "--covar-variance-standardize", dest="covar_vs",
        action="store_true",
        help="Standardize each covariate to mean 0 variance 1 over the "
             "analysis cohort before fitting (plink2 "
             "--covar-variance-standardize; the ADD test is invariant).",
    )
    gl.add_argument(
        "--adjust", action="store_true",
        help="Also write {out}.adjusted (plink2 --adjust): rows sorted "
             "by UNADJ with GC / BONF / HOLM / SIDAK_SS / SIDAK_SD / "
             "FDR_BH / FDR_BY corrected columns (ADD test).",
    )
    gl.add_argument(
        "--adjust-lambda", dest="adjust_lambda", type=float, default=None,
        metavar="L",
        help="Override the estimated genomic-control lambda "
             "(plink2 --lambda; values < 1 clamp to 1).",
    )
    gl.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    cl = sub.add_parser(
        "clump",
        help="LD-aware clumping of association results (plink --clump).",
        description=(
            "plink --clump analog: reads an association report (e.g. a "
            "glm output; any TSV with ID and P columns), picks index "
            "variants (P <= p1) best-first, and assigns unassigned "
            "variants within --clump-kb kilobases at r^2 >= --clump-r2 "
            "to that clump. Writes {out} (default {prefix}.clumps): "
            "#CHROM POS ID P TOTAL NONSIG S0.05 S0.01 S0.001 S0.0001 SP2."
        ),
    )
    cl.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    cl.add_argument("--clump", dest="clump_file", required=True,
                    metavar="FILE", help="Association report TSV.")
    cl.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output path (default {prefix}.clumps, '-' stdout).")
    cl.add_argument("--clump-p1", dest="p1", type=float, default=1e-4,
                    help="Index-variant significance ceiling (default 1e-4).")
    cl.add_argument("--clump-p2", dest="p2", type=float, default=1e-2,
                    help="SP2-listing significance ceiling (default 0.01).")
    cl.add_argument("--clump-r2", dest="r2", type=float, default=0.5,
                    help="LD r^2 membership threshold (default 0.5).")
    cl.add_argument("--clump-kb", dest="kb", type=float, default=250.0,
                    help="Clump radius in kilobases (default 250).")
    cl.add_argument("--clump-id-field", dest="id_field", default="ID",
                    help="Report ID column name (default ID).")
    cl.add_argument("--clump-p-field", dest="p_field", default="P",
                    help="Report P column name (default P).")
    cl.add_argument("--include-var", dest="var_query", default=None)
    cl.add_argument("--include-sam", dest="sam_query", default=None)
    cl.add_argument("--exclude-var", dest="var_exclude", default=None)
    cl.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    cl.add_argument("--samples", dest="samples", default=None)
    cl.add_argument("--samples-file", dest="samples_file", default=None)
    cl.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    rh = sub.add_parser(
        "roh",
        help="Runs of homozygosity (plink --homozyg analog).",
        description=(
            "plink --homozyg analog: calls runs of homozygosity per "
            "sample with the windowed scan (acceptable-window fraction "
            "per SNP, candidate runs trimmed/split/filtered), vectorized "
            "across all samples. Writes {out}.hom (one row per segment) "
            "and {out}.hom.indiv (per-sample totals). Variants must be "
            "grouped by chromosome with ascending POS (see sort). "
            "Accepts the same predicates/regions/sample lists as filter."
        ),
    )
    rh.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    rh.add_argument("-o", "--out", dest="out_prefix", default=None,
                    help="Output prefix (default {prefix} -> "
                         "{prefix}.hom / .hom.indiv).")
    rh.add_argument("--window-snp", type=int, default=50,
                    help="Scanning window size in SNPs (default 50).")
    rh.add_argument("--window-het", type=int, default=1,
                    help="Max het calls per acceptable window (default 1).")
    rh.add_argument("--window-missing", type=int, default=5,
                    help="Max missing calls per acceptable window "
                         "(default 5).")
    rh.add_argument("--window-threshold", type=float, default=0.05,
                    help="Min acceptable-window fraction for a SNP to be "
                         "in the homozygous state (default 0.05).")
    rh.add_argument("--min-snp", dest="min_snp", type=int, default=100,
                    help="Min SNPs per reported segment (default 100).")
    rh.add_argument("--min-kb", dest="min_kb", type=float, default=1000.0,
                    help="Min segment span in kb (default 1000).")
    rh.add_argument("--density", type=float, default=50.0,
                    help="Max average kb per SNP in a segment (default 50).")
    rh.add_argument("--gap", type=float, default=1000.0,
                    help="Split candidate runs at inter-SNP gaps larger "
                         "than this many kb (default 1000).")
    rh.add_argument("--include-var", dest="var_query", default=None)
    rh.add_argument("--include-sam", dest="sam_query", default=None)
    rh.add_argument("--exclude-var", dest="var_exclude", default=None)
    rh.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    rh.add_argument("-r", "--regions", dest="regions", default=None)
    rh.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    rh.add_argument("--samples", dest="samples", default=None)
    rh.add_argument("--samples-file", dest="samples_file", default=None)
    rh.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Predicate/stat engine for GT_* expressions (scan is host).",
    )
    rh.add_argument("--block-variants", type=int, default=1 << 13,
                    help="Variant block height per decode step.")
    rh.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    ex = sub.add_parser(
        "export",
        help="Export a sample-major additive dosage matrix (.raw; plink2 "
             "--export A / AD).",
        description=(
            "plink2 --export A / AD analog: writes the tab-delimited "
            ".raw layout (FID IID PAT MAT SEX PHENOTYPE then one ALT-"
            "count column per variant, named ID_ALT; AD adds an ID_HET "
            "dominant-deviation column). Missing calls are NA. Accepts "
            "the same predicates/regions/sample lists as filter."
        ),
    )
    ex.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    ex.add_argument("fmt", nargs="?", default="A", choices=("A", "AD", "ped"),
                    help="Export format: A = additive dosage (default), "
                         "AD = additive + het-indicator columns, ped = "
                         "PLINK1 text {out}.ped/.map pair (allele-pair "
                         "cells; plink2 --export ped).")
    ex.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output path (default {prefix}.raw, '-' stdout).")
    ex.add_argument("--include-var", dest="var_query", default=None)
    ex.add_argument("--include-sam", dest="sam_query", default=None)
    ex.add_argument("--exclude-var", dest="var_exclude", default=None)
    ex.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    ex.add_argument("-r", "--regions", dest="regions", default=None)
    ex.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    ex.add_argument("--samples", dest="samples", default=None)
    ex.add_argument("--samples-file", dest="samples_file", default=None)
    ex.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Predicate/stat engine for GT_* expressions (decode is host).",
    )
    ex.add_argument("--block-variants", type=int, default=1 << 13,
                    help="Variant block height per decode step.")
    ex.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    im = sub.add_parser(
        "import",
        help="Import a VCF (.vcf/.vcf.gz) or PLINK1 .bed fileset into .pgen.",
        description=(
            "The reverse of `filter`: parses a VCF's GT hard calls into a "
            "mode-0x02 OUT_PREFIX.pgen/.pvar/.psam fileset (biallelic "
            "0/0,0/1,1/1,./. — phased '|' accepted, FORMAT subfields "
            "ignored). ## header lines pass through as .pvar comments; "
            "the first 8 columns round-trip byte-exactly. A .bed input "
            "converts the PLINK1 .bed/.bim/.fam triple instead (A1->ALT, "
            "A2->REF, byte-LUT genotype remap)."
        ),
    )
    im.add_argument("vcf_file", help="Input .vcf, .vcf.gz, or PLINK1 .bed path.")
    im.add_argument(
        "-o",
        "--out",
        dest="out_prefix",
        default=None,
        help="Output fileset prefix (default: input path minus .vcf[.gz]).",
    )
    im.add_argument(
        "--provider",
        choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Execution provider for GT parse + 2-bit pack.",
    )
    im.add_argument(
        "--stats",
        action="store_true",
        help="Print per-stage timing/bandwidth to stderr.",
    )

    cc = sub.add_parser(
        "concat",
        help="Concatenate pgen filesets along the variant axis.",
        description=(
            "bcftools-concat analog: join filesets sharing one sample set "
            "(same psam IID sequence) into OUT_PREFIX.pgen/.pvar/.psam. "
            "Pure byte streaming — records are fixed-width, so no "
            "re-coding happens. Inverse of per-region/shard splitting."
        ),
    )
    cc.add_argument("prefixes", nargs="+", help="Input fileset prefixes, in order.")
    cc.add_argument("-o", "--out", dest="out_prefix", required=True,
                    help="Output fileset prefix.")
    cc.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    sp = sub.add_parser(
        "split",
        help="Split a pgen fileset into many (inverse of concat).",
        description=(
            "bcftools-+split analog: write one fileset per contig "
            "(--by-chrom, first-appearance order) or N contiguous "
            "variant-range filesets (--parts N; `concat` of the parts "
            "reproduces the input byte-exactly). Samples pass through "
            "verbatim."
        ),
    )
    sp.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    spm = sp.add_mutually_exclusive_group(required=True)
    spm.add_argument("--by-chrom", action="store_true",
                     help="One output fileset per distinct CHROM value.")
    spm.add_argument("--parts", type=int, default=None,
                     help="Split into N contiguous variant-range filesets.")
    sp.add_argument("-o", "--out", dest="out_prefix", required=True,
                    help="Output prefix ({out}.{chrom} / {out}.partNN).")
    sp.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    mg = sub.add_parser(
        "merge",
        help="Merge pgen filesets along the sample axis (same variants).",
        description=(
            "Cohort join: inputs hold different samples over identical "
            "variants (same .pvar rows, same order); output carries every "
            "input's samples in argument order. Blocks stream through the "
            "2-bit codecs (unpack -> hstack -> pack)."
        ),
    )
    mg.add_argument("prefixes", nargs="+", help="Input fileset prefixes, in order.")
    mg.add_argument("-o", "--out", dest="out_prefix", required=True,
                    help="Output fileset prefix.")
    mg.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    pr = sub.add_parser(
        "prune",
        help="LD pruning (plink --indep-pairwise analog).",
        description=(
            "Selects an approximately-independent variant subset: sliding "
            "windows (count or kb, per chromosome), pairs above the r2 "
            "threshold lose their lower-MAF member. Correlations use "
            "mean-imputed dosages computed as banded Gram matmuls "
            "(MXU on the device provider, BLAS on host). Writes "
            "OUT.prune.in / OUT.prune.out ID lists."
        ),
    )
    pr.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    pr.add_argument(
        "--indep-pairwise", dest="indep_pairwise", nargs=3, required=True,
        metavar=("WINDOW[kb]", "STEP", "R2"),
        help="plink spec: window size (variant count, or Nkb), window "
             "step in variants, r2 threshold.",
    )
    pr.add_argument("-o", "--out", dest="out_prefix", default=None,
                    help="Output prefix (default {prefix}).")
    pr.add_argument("--include-var", dest="var_query", default=None)
    pr.add_argument("--include-sam", dest="sam_query", default=None)
    pr.add_argument("--exclude-var", dest="var_exclude", default=None)
    pr.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    pr.add_argument("-r", "--regions", dest="regions", default=None)
    pr.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    pr.add_argument("--samples", dest="samples", default=None)
    pr.add_argument("--samples-file", dest="samples_file", default=None)
    pr.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Banded-Gram engine: device = TPU MXU, native/numpy = BLAS.",
    )
    pr.add_argument("--stats", action="store_true",
                    help="Print per-stage timing/bandwidth to stderr.")

    ldp = sub.add_parser(
        "ld",
        help="Pairwise LD r2 table (plink --r2 analog).",
        description=(
            "plink --r2 analog: reports r2 for variant pairs within the "
            "index/kb windows, computed from mean-imputed centered "
            "dosages via the banded Gram machinery (one gemm per band "
            "tile; MXU on the device provider). Output is a .ld-flavored "
            "TSV: CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2. Pairs never "
            "span chromosomes. Accepts the same predicates/regions/"
            "sample lists as filter."
        ),
    )
    ldp.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    ldp.add_argument("-o", "--out", dest="out_file", default=None,
                     help="Output table path (default {prefix}.ld, "
                          "'-' stdout).")
    ldp.add_argument("--ld-window", dest="ld_window", type=int, default=10,
                     help="Max index distance: report pairs with "
                          "j - i < N (default 10).")
    ldp.add_argument("--ld-window-kb", dest="ld_window_kb", type=float,
                     default=1000.0,
                     help="Max basepair distance in kb (default 1000).")
    ldp.add_argument("--ld-window-r2", dest="ld_window_r2", type=float,
                     default=0.2,
                     help="Min r2 to report (default 0.2; 0 reports "
                          "every in-window pair).")
    ldp.add_argument("--include-var", dest="var_query", default=None)
    ldp.add_argument("--include-sam", dest="sam_query", default=None)
    ldp.add_argument("--exclude-var", dest="var_exclude", default=None)
    ldp.add_argument("--exclude-sam", dest="sam_exclude", default=None)
    ldp.add_argument("-r", "--regions", dest="regions", default=None)
    ldp.add_argument("-R", "--regions-file", dest="regions_file", default=None)
    ldp.add_argument("--samples", dest="samples", default=None)
    ldp.add_argument("--samples-file", dest="samples_file", default=None)
    ldp.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto",
        help="Band-gemm engine: device = TPU MXU, native/numpy = BLAS.",
    )
    ldp.add_argument("--stats", action="store_true",
                     help="Print per-stage timing/bandwidth to stderr.")

    ic = sub.add_parser(
        "isec",
        help="Variant set operations between filesets.",
        description=(
            "bcftools-isec analog: intersects filesets by variant key "
            "(CHROM:POS:REF:ALT, or CHROM:POS with --key pos). Two-fileset "
            "default writes up to four filesets: {out}.a_only, "
            "{out}.b_only, {out}.both_a (intersection, A's genotypes), "
            "{out}.both_b. With -n/--nfiles (any N >= 2 inputs, bcftools "
            "semantics: =k exactly, +k at least, -k at most, ~1010 exact "
            "file pattern) writes one fileset per input ({out}.0000, ...) "
            "holding its rows whose key's file-count passes, plus "
            "{out}.sites.txt. Genotypes are gathered, never re-coded."
        ),
    )
    ic.add_argument("prefixes", nargs="+",
                    help="Fileset prefixes (two, or N >= 2 with -n).")
    ic.add_argument("-o", "--out", dest="out_prefix", required=True,
                    help="Output prefix ({out}.a_only etc., or "
                         "{out}.0000... with -n).")
    ic.add_argument("--key", choices=("full", "pos"), default="full",
                    help="Match key: full = CHROM:POS:REF:ALT (default), "
                         "pos = CHROM:POS.")
    ic.add_argument(
        "-n", "--nfiles", dest="nfiles", default=None, metavar="SPEC",
        help="Multi-file mode (bcftools -n): [=+-]INT or ~BITMAP over the "
             "per-key file count, e.g. -n=2 (exactly two inputs), -n +2, "
             "-n ~110.",
    )
    ic.add_argument(
        "--write", dest="write", default=None, metavar="LIST",
        help="Two-fileset mode: comma list of outputs to write (default "
             "all four): a_only,b_only,both_a,both_b.",
    )
    ic.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    df = sub.add_parser(
        "diff",
        help="Genotype concordance between two filesets (plink2 "
             "--pgen-diff).",
        description=(
            "plink2 --pgen-diff analog: matches variants on "
            "CHROM:POS:REF:ALT (--key pos for CHROM:POS) and samples on "
            "shared IIDs, compares every matched call blockwise, and "
            "writes the discordant calls as a .pdiff-flavored TSV "
            "(#CHROM POS ID IID GT1 GT2) plus a summary on stderr."
        ),
    )
    df.add_argument("prefix_a", help="First fileset prefix (columns come "
                                     "from this side's pvar).")
    df.add_argument("prefix_b", help="Second fileset prefix.")
    df.add_argument("-o", "--out", dest="out_file", default=None,
                    help="Output path (default {prefix_a}.pdiff, '-' "
                         "stdout).")
    df.add_argument("--key", choices=("full", "pos"), default="full",
                    help="Variant matching key (default full = "
                         "CHROM:POS:REF:ALT).")
    df.add_argument("--include-missing", action="store_true",
                    help="Count missing-vs-called pairs as discordant "
                         "(off by default, matching plink2 --pgen-diff; "
                         "both-missing pairs never compare).")
    df.add_argument("--per-sample", action="store_true",
                    help="Also write {out}.sdiff: per shared sample "
                         "DIFF_CT / CMP_CT / CONCORDANCE (plink2 "
                         "--sample-diff counts analog).")
    df.add_argument("--block-variants", type=int, default=1 << 13)
    df.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    so = sub.add_parser(
        "sort",
        help="Sort a fileset's variants chromosomally (CHROM, POS).",
        description=(
            "bcftools-sort analog: contig rank follows ##contig header "
            "lines when present, then natural genome order (1..22, X, Y, "
            "XY, MT; 'chr' prefix ignored); POS ascends numerically; ties "
            "keep input order. Records are gathered, never re-coded."
        ),
    )
    so.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    so.add_argument("-o", "--out", dest="out_prefix", default=None,
                    help="Output fileset prefix (default {prefix}.sorted).")
    so.add_argument("--check", action="store_true",
                    help="Write nothing; exit 0 if already sorted, 1 if not.")
    so.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    an = sub.add_parser(
        "annotate",
        help="Rewrite fileset metadata (IDs, contig names, sample names).",
        description=(
            "bcftools annotate/reheader analogs over a fileset: --set-id "
            "recomputes the ID column from an fstring expression "
            "(e.g. 'CHROM+\":\"+POS+\":\"+REF+\":\"+ALT'); --rename-chrs "
            "remaps contig names ('old new' lines, ##contig comments "
            "follow); --rename-samples remaps psam IIDs ('old new' lines, "
            "or one new name per line for all samples). Genotypes are "
            "copied verbatim."
        ),
    )
    an.add_argument("pfile_prefix", help="The prefix of the pgen file triples.")
    an.add_argument("-o", "--out", dest="out_prefix", default=None,
                    help="Output fileset prefix (default {prefix}.annotated).")
    an.add_argument("--set-id", dest="set_id", default=None, metavar="EXPR",
                    help="fstring expression for the new ID column.")
    an.add_argument("--rename-chrs", dest="rename_chrs", default=None,
                    metavar="FILE", help="Contig mapping file ('old new' lines).")
    an.add_argument("--rename-samples", dest="rename_samples", default=None,
                    metavar="FILE",
                    help="IID mapping file ('old new' lines or one per line).")
    an.add_argument(
        "--fill-info", dest="fill_info", default=None, metavar="TAGS",
        help="Compute genotype-derived INFO tags into the .pvar (bcftools "
             "+fill-tags analog): comma list from AC,AN,AF,MAF,NS,"
             "F_MISSING,HWE or 'all'. Existing instances are replaced; "
             "##INFO declarations added when missing.",
    )
    an.add_argument(
        "-a", "--annotations", dest="annotations", default=None,
        metavar="PREFIX",
        help="Transfer annotations from another fileset (bcftools "
             "annotate -a analog): rows matched on CHROM:POS:REF:ALT; "
             "pick what to copy with --columns.",
    )
    an.add_argument(
        "-c", "--columns", dest="columns", default="ID", metavar="LIST",
        help="What --annotations copies (comma list, default ID): ID, "
             "INFO (whole column), INFO/TAG (one tag spliced into the "
             "existing INFO). ##INFO declarations follow.",
    )
    an.add_argument(
        "-x", "--remove-annotations", dest="remove_annotations",
        default=None, metavar="LIST",
        help="Remove annotations (bcftools annotate -x analog; comma "
             "list): ID, QUAL, FILTER, INFO (whole column), or INFO/TAG "
             "(strip one tag per row). Matching ##INFO declarations "
             "drop from the header. Applied after --set-id.",
    )
    an.add_argument("--include-sam", dest="sam_query", default=None,
                    help="Cohort restriction for --fill-info counts.")
    an.add_argument("--samples", dest="samples", default=None)
    an.add_argument("--samples-file", dest="samples_file", default=None)
    an.add_argument(
        "--provider", choices=["auto", "native", "device", "numpy"],
        default="auto", help="Counting engine for --fill-info.",
    )
    an.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    ix = sub.add_parser(
        "index",
        help="Tabix-index an existing .vcf.gz (BGZF) file.",
        description=(
            "bcftools-index/tabix analog: scans the BGZF members of an "
            "already-written .vcf.gz and emits FILE.vcf.gz.tbi (or .csi). "
            "filter --index is cheaper for files this tool writes (row "
            "offsets are known at emission time); this serves everything "
            "else."
        ),
    )
    ix.add_argument("vcf_gz", help="Path to a BGZF-compressed .vcf.gz.")
    ix.add_argument(
        "--index-format",
        choices=("auto", "tbi", "csi"),
        default="auto",
        help="Index flavor (auto: .csi only when a position needs it).",
    )
    ix.add_argument("--stats", action="store_true",
                    help="Print per-stage timing to stderr.")

    vw = sub.add_parser(
        "view",
        help="Print (regions of) an existing .vcf.gz via its index.",
        description=(
            "tabix/bcftools-view read side: without -r the whole file "
            "streams to stdout; with -r only the indexed blocks "
            "overlapping the regions are decompressed ({file}.tbi/.csi, "
            "see `pgen-tpu index`)."
        ),
    )
    vw.add_argument("vcf_gz", help="Path to a BGZF-compressed .vcf.gz.")
    vw.add_argument(
        "-r",
        "--regions",
        dest="regions",
        default=None,
        help=(
            "bcftools-style regions: CHROM, CHROM:POS, CHROM:BEG-END, "
            "CHROM:BEG- (comma-separated); ':'-bearing contig names "
            "resolve against the index's contig list."
        ),
    )
    vw.add_argument(
        "-H",
        "--no-header",
        dest="no_header",
        action="store_true",
        help="Suppress the '#' header lines (tabix default).",
    )

    d = sub.add_parser(
        "describe",
        help="Introspect a .pgen header (any storage mode).",
        description=(
            "Parses and validates the general variable-record pgen header "
            "layout; prints counts, record type/length widths, and the "
            "variant block index summary."
        ),
    )
    d.add_argument("pgen_file", help="Path to a .pgen file.")

    # plink2 --keep / --remove sample-ID files, registered uniformly on
    # every subcommand that takes sample lists; folded into the
    # include-sam expression once, centrally, in main()
    for sp in sub.choices.values():
        if any(a.dest == "samples_file" for a in sp._actions):
            sp.add_argument(
                "--keep", dest="keep", default=None, metavar="FILE",
                help="Keep only samples listed in FILE (plink2 --keep; "
                     "bare IID or FID IID per line).",
            )
            sp.add_argument(
                "--remove", dest="remove", default=None, metavar="FILE",
                help="Drop samples listed in FILE (plink2 --remove).",
            )
    return p


def _version() -> str:
    from pgen_tpu_torch import __version__

    return f"pgen-tpu {__version__}"
