"""Command line of the port: ``python -m pgen_tpu_torch.cli SUBCOMMAND ...``.

It takes the port's copy of pgen_tpu's argument parser
(``cli_parser.build_arg_parser``, every subcommand) and adds ``--device
cuda|cpu`` (default ``cuda``, which must be available) to each subcommand
it serves (``SERVED``) that runs on the card: ``filter``, ``import``,
``query``, ``glm``, ``score``, ``king``, ``genome``, ``pca``, the reports
``freq``, ``gcount``, ``missing``, ``hardy`` and ``het``, ``stats``,
``fst``, ``ld``, ``prune``, ``clump``, and ``merge``, ``diff``,
``annotate``, ``export`` and ``roh`` (``CARD_FILES``). ``describe``,
``index``, ``view``, ``split``, ``concat``, ``sort`` and ``isec``
(``HOST_FILES``) are host code alone and keep pgen_tpu's arguments
exactly. The query flags compose exactly as in ``pgen_tpu.cli.main``,
through the port's copies of its host composers (``query/``):
``--keep/--remove``, ``-r/-R``, ``--exclude-var/--exclude-sam``,
``--samples``, ``--extract/--exclude-ids``, the
``--maf/--max-maf/--geno/--hwe/--mind`` sugar and ``--rm-dup`` (the
``error|list`` report first, as pgen_tpu's).

``filter`` dispatches in pgen_tpu's order. ``--out-format bed`` writes
the PLINK1 fileset ``-o PREFIX`` (``pipeline/bed_import.py``, K5 for a
sample subset) and ``--out-format pgen`` the pgen fileset (default
``{prefix}.pgen-rs``). A VCF goes to ``--workers N`` (worker processes on
the card, one variant shard each; ``--resume`` finishes a run whose
manifest marks failed shards), else ``--shards N`` (the shards in this
process, or with ``--shard-index I`` shard I alone into the shared file;
``parallel/shard.py``), else ``--provider device``, which routes it to
``pipeline/mesh_filter.py`` (one process per GPU; run alone it needs no
launcher and makes no process group; N cards: ``torchrun --nproc-per-node
N -m pgen_tpu_torch.cli filter ... --provider device``), else the
one-process filter, whose ``--threads T`` emits a plain file's blocks from
T host threads, each on its own CUDA stream. ``--provider device`` also
makes the ``GT_*`` counts of the predicates on the device on every other
path: the pgen and bed outputs, ``--shards``, each ``--workers`` worker
(on the device string it is handed) and the merged ``.vcf.gz``'s index,
and the ``--rm-dup error|list`` report; ``--stats`` of ``--shards`` and
of each worker prints its launches of K2, K3, K8, K9 and K14. ``--profile DIR`` writes a torch.profiler trace per rank.
``import`` reads a ``.vcf`` or ``.vcf.gz`` (K4 on ``--device``), or a
PLINK1 ``.bed``, host code as in pgen_tpu, which ``--device`` does not
touch. ``glm`` and ``score`` run on one GPU (``--provider auto`` or
``device``), as ``pgen_tpu.cli.main`` serves them: the multi-phenotype
loop, ``-o -``, the same query composers and the closing stderr line; so
do ``king`` (with ``--min-kinship`` and ``--cutoff``), ``genome`` (with
``--min-pi-hat``) and ``pca`` (``-k``, ``--make-rel``, ``--approx``), the
reports (``freq --counts``, ``hardy --midp``, ``missing``'s out prefix),
``stats`` (``--per-sample``), ``fst``, ``ld`` (``-o -`` streams the table),
``prune --indep-pairwise`` and ``clump``; and the fileset tools: ``merge``
(K1 and K4 splice the samples), ``diff`` (K1 and the compare on the card),
``annotate`` (``--fill-info`` counts with K8, or K14 for a cohort),
``export`` A/AD/ped and ``roh`` (K1 decodes; roh's scan stays on the
host). Under ``torchrun`` (or pgen_tpu's
``PGEN_TPU_COORDINATOR`` variables) ``glm`` (linear, ``--modifier``),
``score``, ``king``, ``genome`` and ``pca`` run over variant shards, one
process per card (``MESH``, ``parallel/mesh.py``); rank 0 writes every
output file and all of stdout, the other ranks print nothing but an error.
What pgen_tpu has no mesh step for is refused under several ranks (exit 2):
logistic ``glm``, ``--interaction``, the reports, ``stats``, ``fst``,
``query``, ``ld``, ``prune``, ``clump`` and the twelve fileset tools above.
``query`` prints its rows to
stdout as pgen_tpu's does: ``-e`` excludes, and ``-r``/``-R`` with ``-s``
is an error (exit 1). It exits as ``pgen_tpu.cli.main`` does: 141 on a
broken pipe, 1 with the one stderr line ``pgen-tpu: error: ...`` on any
other exception, 2 on an argument error. The port serves every subcommand
and flag of pgen_tpu but its host providers: ``--provider native|numpy``
(and ``import --provider``) exit 2 naming ROADMAP.md, a decision rather
than work to come (``_UNSERVED``, ``_UNSERVED_IMPORT``,
``_UNSERVED_ANALYTICS``); the port's host path is ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

from pgen_tpu_torch.cli_parser import build_arg_parser

# flag dest -> (test on its parsed value, refusal naming the ROADMAP item)
_UNSERVED = {
    "provider": (
        lambda v: v not in ("auto", "device"),
        "--provider native|numpy: the port serves auto (one GPU) and device "
        "(ROADMAP §1 item 6, done); pgen_tpu's host providers stay pgen_tpu's, "
        "by decision (ROADMAP §1): the port's host path is --device cpu",
    ),
}

_UNSERVED_IMPORT = {
    "provider": (
        lambda v: v != "auto",
        "import --provider: the port's import (ROADMAP §1 item 7) has one "
        "path, chosen with --device; pgen_tpu's host providers stay pgen_tpu's",
    ),
}


_UNSERVED_ANALYTICS = {
    "provider": (
        lambda v: v not in ("auto", "device"),
        "--provider native|numpy: the port's glm and score (ROADMAP §1 item 9, done), "
        "king, genome, pca, ld and prune (item 10, done), the reports, stats and fst "
        "(item 8, done), and export, roh and annotate (item 13, done) run on one GPU "
        "(auto or device); pgen_tpu's host providers stay pgen_tpu's",
    ),
}

REPORTS = ("freq", "gcount", "missing", "hardy", "het")
# ROADMAP §1 item 13: the subcommands with a card stage (CARD_FILES) and the
# ones that are host code alone (HOST_FILES), which take no --device
CARD_FILES = ("merge", "diff", "annotate", "export", "roh")
HOST_FILES = ("describe", "index", "view", "split", "concat", "sort", "isec")
SERVED = ("filter", "import", "query", "glm", "score", "king", "genome", "pca", *REPORTS,
          "stats", "fst", "ld", "prune", "clump", *CARD_FILES, *HOST_FILES)
# the analytics that run over variant shards under several ranks: pgen_tpu's
# mesh steps (ROADMAP §1 item 17)
MESH = ("glm", "score", "king", "genome", "pca")


def build_torch_arg_parser() -> argparse.ArgumentParser:
    """pgen_tpu's parser with ``--device`` on every served subcommand that
    runs on the card (all but ``HOST_FILES``)."""
    p = build_arg_parser()
    p.prog = "pgen-tpu-torch"
    sub = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
    for command in SERVED:
        if command in HOST_FILES:
            continue
        sub.choices[command].add_argument(
            "--device",
            choices=["cuda", "cpu"],
            default="cuda",
            help="Device for the genotype kernels: cuda (default; must be "
            "available, never replaced by the CPU) or cpu (the kernels' plain "
            "PyTorch versions).",
        )
    return p


def _and_cond(query, cond):
    return cond if query is None else f"({query}) && ({cond})"


def _compose_queries(args) -> None:
    """Fold the query flags of every served subcommand (--keep/--remove,
    -r/-R, --exclude-var/--exclude-sam, --samples) into args.var_query /
    args.sam_query, as pgen_tpu.cli.main does (clump has no -r/-R)."""
    from pgen_tpu_torch.query.exclude import apply_exclude
    from pgen_tpu_torch.query.regions import apply_regions
    from pgen_tpu_torch.query.samples import apply_keep_remove, apply_samples

    if getattr(args, "keep", None) or getattr(args, "remove", None):
        args.sam_query = apply_keep_remove(args.sam_query, args.keep, args.remove)
    args.var_query = apply_exclude(
        apply_regions(args.var_query, getattr(args, "regions", None),
                      getattr(args, "regions_file", None)),
        args.var_exclude,
    )
    args.sam_query = apply_exclude(
        apply_samples(args.sam_query, args.samples, args.samples_file), args.sam_exclude
    )


def _compose_filter_queries(args) -> int:
    """The common query flags, then filter's own: --extract/--exclude-ids,
    the --maf/--max-maf/--geno/--hwe/--mind sugar and --rm-dup. Returns 0,
    or 2 after pgen_tpu's stderr line for --hwe-midp without --hwe."""
    from pgen_tpu_torch.query.idlist import apply_id_lists

    _compose_queries(args)
    args.var_query = apply_id_lists(args.var_query, args.extract, args.exclude_ids)
    if args.maf is not None:
        args.var_query = _and_cond(args.var_query, f"GT_MAF >= {args.maf!r}")
    if args.max_maf is not None:
        args.var_query = _and_cond(args.var_query, f"GT_MAF <= {args.max_maf!r}")
    if args.geno is not None:
        args.var_query = _and_cond(args.var_query, f"GT_MISSING_RATE <= {args.geno!r}")
    if args.hwe_midp and args.hwe is None:
        print("filter: error: --hwe-midp requires --hwe X", file=sys.stderr)
        return 2
    if args.hwe is not None:
        hwe_var = "GT_HWE_MIDP" if args.hwe_midp else "GT_HWE_P"
        args.var_query = _and_cond(args.var_query, f"{hwe_var} >= {args.hwe!r}")
    if args.mind is not None:
        args.sam_query = _and_cond(args.sam_query, f"GT_MISSING_RATE <= {args.mind!r}")
    # --rm-dup acts on the post-filter variant set (plink2's filter order)
    if args.rm_dup in ("force-first", "exclude-all"):
        fn = "dup_first_within" if args.rm_dup == "force-first" else "dup_unique_within"
        inner = args.var_query if args.var_query is not None else "true"
        args.var_query = f"{fn}(({inner}))"
    elif args.rm_dup in ("error", "list"):
        return _rm_dup_report(args)
    return 0


def _rm_dup_report(args) -> int:
    """--rm-dup error|list, as pgen_tpu.cli.main runs it: the IDs that occur
    more than once among the variants the composed queries keep. ``error``
    returns 2 after one stderr line when there are any; ``list`` writes them
    to ``{out}.rmdup.list`` and the filter goes on. With ``--provider
    device`` the ``GT_*`` counts of the queries run on ``--device``.
    Returns 0 or 2."""
    from pgen_tpu_torch.pipeline.filter import duplicated_ids

    dup_ids = duplicated_ids(
        args.pfile_prefix, args.var_query, args.sam_query,
        args.provider, device=args.device,
    )
    if args.rm_dup == "error":
        if dup_ids:
            print(
                f"filter: error: --rm-dup error: "
                f"{len(dup_ids)} duplicated variant ID(s) "
                f"among kept variants (first: {dup_ids[0]})",
                file=sys.stderr,
            )
            return 2
    else:
        base = (
            args.out_file
            if args.out_file and args.out_file != "-"
            else f"{args.pfile_prefix}.pgen-rs.vcf"
        )
        lst = f"{base}.rmdup.list"
        with open(lst, "w") as fh:
            fh.write("".join(i + "\n" for i in dup_ids))
        print(
            f"filter: --rm-dup list: {len(dup_ids)} duplicated "
            f"ID(s) -> {lst}",
            file=sys.stderr,
        )
    return 0


def _refuse_unserved(parser, args, unserved: dict) -> None:
    """parser.error for the first flag of ``unserved`` the subcommand has and
    sets to a refused value (clump has no --provider)."""
    for dest, (test, why) in unserved.items():
        if hasattr(args, dest) and test(getattr(args, dest)):
            parser.error(why)


@contextlib.contextmanager
def _profile(out_dir, device: str):
    """With ``--profile DIR``, a torch.profiler trace of the run (CPU
    activity, and CUDA activity on a card) written as the Chrome trace
    ``DIR/rank{R}.trace.json``, R this process's rank, with a range
    ``stage:<name>`` for each span of the program's timer
    (``utils/timer.py``); pgen_tpu maps the flag to jax.profiler."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from pgen_tpu_torch.parallel.distributed import env_rank

    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"rank{env_rank()}.trace.json"))


def _score(args) -> int:
    from pgen_tpu_torch.pipeline.score_host import parse_col_nums
    from pgen_tpu_torch.pipeline.score import score_pfile

    result = score_pfile(
        args.pfile_prefix,
        args.score_file,
        var_id_col=args.variant_id_col,
        allele_col=args.allele_col,
        weight_cols=parse_col_nums(args.score_col_nums),
        header_row=args.header_row,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout if args.out_file == "-" else None,
        device=args.device,
        mean_impute=args.mean_impute,
        write_sums=args.score_sums,
        block_variants=args.block_variants,
        q_score_range=args.q_score_range,
        q_data_col=args.q_data_col,
        center=args.center,
        variance_standardize=args.variance_standardize,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"score: {len(result.names)} score(s) x {result.num_scored} variants over "
        f"{result.num_samples} samples -> {dest}"
        + (f" ({result.num_unmatched} unmatched, {result.num_mismatched} allele-mismatched)"
           if result.num_unmatched or result.num_mismatched else ""),
        file=sys.stderr,
    )
    return 0


def _split_names(text) -> list:
    return [c.strip() for c in (text or "").split(",") if c.strip()]


def _glm(args) -> int:
    covars = _split_names(args.covar_name)
    condition = _split_names(args.condition)
    if args.condition_list:
        with open(args.condition_list) as fh:
            condition += [
                ln.strip() for ln in fh if ln.strip() and not ln.strip().startswith("#")
            ]
    # plink2 runs every named phenotype and writes one
    # {base}.{pheno}.glm.{model} per phenotype
    phenos = _split_names(args.pheno_name)
    if len(phenos) > 1 and args.out_file == "-":
        print("glm: error: multiple phenotypes write one file each; use a file -o, not '-'",
              file=sys.stderr)
        return 2
    # several phenotypes under ranks share one process group
    group = contextlib.nullcontext()
    if len(phenos) > 1:
        from pgen_tpu_torch.parallel.distributed import process_group

        group = process_group(args.device)
    with group:
        return _glm_phenotypes(args, covars, condition, phenos)


def _glm_phenotypes(args, covars, condition, phenos) -> int:
    from pgen_tpu_torch.ops.glm import MODIFIER_TESTS
    from pgen_tpu_torch.pipeline.glm import glm_pfile

    for pheno in phenos:
        out_base = out_file = None
        if len(phenos) > 1 and args.out_file:
            out_base = f"{args.out_file}.{pheno}"  # glm_pfile appends .glm.{model}
        elif args.out_file != "-":
            out_file = args.out_file
        result = glm_pfile(
            args.pfile_prefix,
            pheno_name=pheno,
            covar_names=covars,
            model=args.model,
            var_query=args.var_query,
            sam_query=args.sam_query,
            out_file=out_file,
            out=sys.stdout if args.out_file == "-" else None,
            device=args.device,
            block_variants=args.block_variants,
            firth=args.firth,
            pheno_file=args.pheno_file,
            covar_file=args.covar_file,
            condition=condition,
            interaction=args.interaction,
            adjust=args.adjust,
            adjust_lambda=args.adjust_lambda,
            covar_variance_standardize=args.covar_vs,
            out_base=out_base,
            modifier=args.modifier,
        )
        if args.stats:
            print(result.timer.report(), file=sys.stderr)
        dest = "stdout" if args.out_file == "-" else result.out_path
        if args.modifier:
            design = "+".join(MODIFIER_TESTS[args.modifier])
        elif args.interaction:
            design = "ADD+ADDxC"
        else:
            design = "ADD"
        print(
            f"glm: {result.model} {result.pheno_name} ~ {design}"
            + (f" + {len(covars)} covar(s)" if covars else "")
            + f" over {result.num_variants} variants x {result.num_samples} samples -> {dest}",
            file=sys.stderr,
        )
    return 0


def _king(args) -> int:
    from pgen_tpu_torch.pipeline.king import king_table

    result = king_table(
        args.pfile_prefix,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout if args.out_file == "-" else None,
        device=args.device,
        min_kinship=args.min_kinship,
        block_variants=args.block_variants,
        cutoff=args.cutoff,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    if args.cutoff is not None:
        print(
            f"king: kept {result.num_pairs} of "
            f"{result.num_samples} samples at cutoff "
            f"{args.cutoff} -> {result.out_path}.king.cutoff.*.id",
            file=sys.stderr,
        )
        return 0
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"king: {result.num_pairs} pairs over {result.num_samples} "
        f"samples x {result.num_variants} variants -> {dest}",
        file=sys.stderr,
    )
    return 0


def _genome(args) -> int:
    from pgen_tpu_torch.pipeline.genome import genome_table

    result = genome_table(
        args.pfile_prefix,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout if args.out_file == "-" else None,
        device=args.device,
        min_pi_hat=args.min_pi_hat,
        block_variants=args.block_variants,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"genome: {result.num_pairs} pairs over "
        f"{result.num_samples} samples x {result.num_variants} "
        f"variants -> {dest}",
        file=sys.stderr,
    )
    return 0


def _pca(args) -> int:
    from pgen_tpu_torch.ops.pca import grm_z, pca_approx_pass, pca_from_grm
    from pgen_tpu_torch.pipeline.pca import pca

    before = (grm_z.launches, pca_approx_pass.launches, pca_from_grm.tensor_calls)
    result = pca(
        args.pfile_prefix,
        k=args.k,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_prefix=args.out_prefix,
        device=args.device,
        block_variants=args.block_variants,
        make_rel=args.make_rel,
        approx=args.approx,
        approx_iters=args.approx_iters,
        seed=args.seed,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
        # pca_from_grm's tensor calls: exact GRMs decomposed on their device
        print(f"launches: grm_z {grm_z.launches - before[0]}, pca_approx_pass "
              f"{pca_approx_pass.launches - before[1]}; pca_from_grm.tensor_calls "
              f"{pca_from_grm.tensor_calls - before[2]}", file=sys.stderr)
    wrote = (
        f"{result.out_prefix}.eigenvec" if args.k
        else f"{result.out_prefix}.rel.*"
    )
    print(
        f"pca: {len(result.eigenvalues)} components over "
        f"{result.num_samples} samples x {result.num_used} "
        f"polymorphic variants -> {wrote}",
        file=sys.stderr,
    )
    return 0


def _report(args) -> int:
    from pgen_tpu_torch.pipeline import reports

    fn = {
        "freq": reports.report_freq,
        "missing": reports.report_missing,
        "hardy": reports.report_hardy,
        "het": reports.report_het,
        "gcount": reports.report_gcount,
    }[args.command]
    kwargs = (
        {"out_prefix": args.out_file}
        if args.command == "missing"
        else {"out_file": args.out_file}
    )
    if args.command == "freq":
        kwargs["counts"] = args.counts
    if args.command == "hardy":
        kwargs["midp"] = args.midp
    result = fn(
        args.pfile_prefix,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
        **kwargs,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = ", ".join(result.out_paths) or "stdout"
    print(
        f"{result.kind}: {result.num_variants} variants x "
        f"{result.num_samples} samples -> {dest}",
        file=sys.stderr,
    )
    return 0


def _stats(args) -> int:
    from pgen_tpu_torch.pipeline.stats import genotype_stats

    genotype_stats(
        args.pfile_prefix,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
        per_sample=args.per_sample,
    )
    return 0


def _fst(args) -> int:
    from pgen_tpu_torch.pipeline.fst import fst_pfile

    result = fst_pfile(
        args.pfile_prefix,
        pheno_name=args.pheno_name,
        pheno_file=args.pheno_file,
        within_file=args.within_file,
        method=args.method,
        report_variants=args.report_variants,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_file=args.out_file,
        device=args.device,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"fst: {result.method} over {len(result.pairs)} cohort "
        f"pair(s), {result.num_variants} variants x "
        f"{result.num_samples} assigned samples"
        + (
            f" -> {result.out_paths[0]}"
            if result.out_paths else ""
        ),
        file=sys.stderr,
    )
    return 0


def _ld(args) -> int:
    from pgen_tpu_torch.pipeline.ld_report import ld_report

    result = ld_report(
        args.pfile_prefix,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout if args.out_file == "-" else None,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
        ld_window=args.ld_window,
        ld_window_kb=args.ld_window_kb,
        ld_window_r2=args.ld_window_r2,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"ld: {result.num_pairs} pairs over {result.num_variants} "
        f"variants x {result.num_samples} samples -> {dest}",
        file=sys.stderr,
    )
    return 0


def _prune(args) -> int:
    from pgen_tpu_torch.pipeline.prune import prune

    result = prune(
        args.pfile_prefix,
        args.indep_pairwise,
        var_query=args.var_query,
        sam_query=args.sam_query,
        out_prefix=args.out_prefix,
        device=args.device,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"prune: kept {result.num_kept}, removed "
        f"{result.num_removed} of {result.num_considered} variants "
        f"-> {result.out_prefix}.prune.in/.prune.out",
        file=sys.stderr,
    )
    return 0


def _clump(args) -> int:
    from pgen_tpu_torch.pipeline.clump import clump_pfile

    result = clump_pfile(
        args.pfile_prefix,
        args.clump_file,
        out_file=args.out_file,
        p1=args.p1,
        p2=args.p2,
        r2=args.r2,
        kb=args.kb,
        id_field=args.id_field,
        p_field=args.p_field,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"clump: {result.num_clumps} clump(s) absorbing "
        f"{result.num_assigned} of {result.num_candidates} matched "
        f"variants -> {result.out_path or 'stdout'}",
        file=sys.stderr,
    )
    return 0


def _query(args) -> int:
    """query: the rows of the .pvar (or the .psam under -s) that -i keeps
    and -e does not, one -f string each, on stdout."""
    from pgen_tpu_torch.pipeline.query import query_metadata
    from pgen_tpu_torch.query.exclude import apply_exclude
    from pgen_tpu_torch.query.regions import apply_regions

    if (args.regions or args.regions_file) and args.query_samples:
        raise ValueError("--regions applies to variant queries, not -s")
    query_metadata(
        args.pfile_prefix,
        query_fstring=args.query_fstring,
        query=apply_exclude(
            apply_regions(args.query, args.regions, args.regions_file),
            args.query_exclude,
        ),
        query_samples=args.query_samples,
        device=args.device,
    )
    return 0


def _roh(args) -> int:
    from pgen_tpu_torch.ops.roh import RohParams
    from pgen_tpu_torch.pipeline.roh import roh_report

    result = roh_report(
        args.pfile_prefix,
        out_prefix=args.out_prefix,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
        params=RohParams(
            window_snp=args.window_snp,
            window_het=args.window_het,
            window_missing=args.window_missing,
            window_threshold=args.window_threshold,
            min_snp=args.min_snp,
            min_kb=args.min_kb,
            density=args.density,
            gap=args.gap,
        ),
        block_variants=args.block_variants,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"roh: {result.num_segments} segments over "
        f"{result.num_samples} samples x {result.num_variants} "
        f"variants -> {result.out_paths[0]}",
        file=sys.stderr,
    )
    return 0


def _export(args) -> int:
    from pgen_tpu_torch.pipeline.export_raw import export_ped, export_raw

    if args.fmt == "ped":
        if args.out_file == "-":
            print("export: error: ped writes a .ped/.map pair; "
                  "use -o PREFIX, not '-'", file=sys.stderr)
            return 2
        result = export_ped(
            args.pfile_prefix,
            out_prefix=args.out_file,
            var_query=args.var_query,
            sam_query=args.sam_query,
            device=args.device,
            block_variants=args.block_variants,
        )
        if args.stats:
            print(result.timer.report(), file=sys.stderr)
        print(
            f"export ped: {result.num_samples} samples x "
            f"{result.num_variants} variants -> {result.out_path} "
            f"(+ .map)",
            file=sys.stderr,
        )
        return 0
    result = export_raw(
        args.pfile_prefix,
        fmt=args.fmt,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout.buffer if args.out_file == "-" else None,
        var_query=args.var_query,
        sam_query=args.sam_query,
        device=args.device,
        block_variants=args.block_variants,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"export {result.fmt}: {result.num_samples} samples x "
        f"{result.num_variants} variants -> {dest}",
        file=sys.stderr,
    )
    return 0


def _annotate(args) -> int:
    from pgen_tpu_torch.pipeline.annotate import annotate_pgen

    result = annotate_pgen(
        args.pfile_prefix,
        args.out_prefix,
        set_id=args.set_id,
        rename_chrs=args.rename_chrs,
        rename_samples=args.rename_samples,
        fill_info=args.fill_info,
        sam_query=args.sam_query,
        device=args.device,
        annotations=args.annotations,
        columns=args.columns,
        remove=args.remove_annotations,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"annotated {result.num_variants} variants x "
        f"{result.num_samples} samples -> {result.out_prefix}",
        file=sys.stderr,
    )
    return 0


def _merge(args) -> int:
    from pgen_tpu_torch.pipeline.merge import merge_pgen

    result = merge_pgen(args.prefixes, args.out_prefix, device=args.device)
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"merged {result.num_inputs} filesets: "
        f"{result.num_variants} variants x {result.num_samples} "
        f"samples -> {result.out_prefix}.pgen",
        file=sys.stderr,
    )
    return 0


def _diff(args) -> int:
    from pgen_tpu_torch.pipeline.diff import diff_pgen

    result = diff_pgen(
        args.prefix_a,
        args.prefix_b,
        out_file=None if args.out_file == "-" else args.out_file,
        out=sys.stdout if args.out_file == "-" else None,
        key=args.key,
        include_missing=args.include_missing,
        block_variants=args.block_variants,
        per_sample=args.per_sample,
        device=args.device,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    dest = "stdout" if args.out_file == "-" else result.out_path
    print(
        f"diff: {result.num_discordant} discordant of "
        f"{result.num_cells} calls ({result.num_variants} matched "
        f"variants x {result.num_samples} shared samples) -> {dest}",
        file=sys.stderr,
    )
    return 0


def _concat(args) -> int:
    from pgen_tpu_torch.pipeline.concat import concat_pgen

    result = concat_pgen(args.prefixes, args.out_prefix)
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"concatenated {result.num_inputs} filesets: "
        f"{result.num_variants} variants x {result.num_samples} "
        f"samples -> {result.out_prefix}.pgen",
        file=sys.stderr,
    )
    return 0


def _split(args) -> int:
    from pgen_tpu_torch.pipeline.split import split_pgen

    result = split_pgen(
        args.pfile_prefix,
        args.out_prefix,
        by_chrom=args.by_chrom,
        parts=args.parts,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"split {result.num_variants} variants x "
        f"{result.num_samples} samples -> "
        f"{len(result.out_prefixes)} filesets",
        file=sys.stderr,
    )
    return 0


def _isec(args) -> int:
    from pgen_tpu_torch.pipeline.isec import isec_pgen, isec_pgen_multi

    if args.nfiles is not None:
        result = isec_pgen_multi(
            args.prefixes,
            args.out_prefix,
            key=args.key,
            nfiles=args.nfiles,
        )
    else:
        if len(args.prefixes) != 2:
            raise ValueError(
                "isec takes exactly two filesets unless -n/--nfiles "
                "selects the multi-file mode"
            )
        result = isec_pgen(
            args.prefixes[0],
            args.prefixes[1],
            args.out_prefix,
            key=args.key,
            write=args.write,
        )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    summary = "  ".join(
        f"{name}={result.counts[name]}" for name in result.counts
    )
    print(f"isec: {summary}", file=sys.stderr)
    for name, dest in result.out_prefixes.items():
        suffix = "" if name == "sites" else ".pgen"
        print(f"wrote {dest}{suffix}", file=sys.stderr)
    return 0


def _sort(args) -> int:
    from pgen_tpu_torch.pipeline.sort import sort_pgen

    result = sort_pgen(
        args.pfile_prefix,
        args.out_prefix,
        check_only=args.check,
    )
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    if args.check:
        state = "sorted" if result.already_sorted else "NOT sorted"
        print(f"{args.pfile_prefix}: {state}", file=sys.stderr)
        return 0 if result.already_sorted else 1
    print(
        f"sorted {result.num_variants} variants x "
        f"{result.num_samples} samples -> {result.out_prefix}"
        + (" (already sorted)" if result.already_sorted else ""),
        file=sys.stderr,
    )
    return 0


def _index(args) -> int:
    from pgen_tpu_torch.pipeline.index_vcf import index_vcf_gz
    from pgen_tpu_torch.utils.timer import StageTimer

    timer = StageTimer()
    out_path = index_vcf_gz(args.vcf_gz, fmt=args.index_format, timer=timer)
    if args.stats:
        print(timer.report(), file=sys.stderr)
    print(f"wrote {out_path}", file=sys.stderr)
    return 0


def _view(args) -> int:
    from pgen_tpu_torch.pipeline.view import view_vcf_gz

    view_vcf_gz(
        args.vcf_gz,
        regions=args.regions,
        header=not args.no_header,
    )
    return 0


def _describe(args) -> int:
    from pgen_tpu_torch.formats.describe import describe_pgen
    from pgen_tpu_torch.formats.header import read_pgen_header

    # Dispatch on the storage-mode byte so a corrupt general-mode
    # file surfaces its real parse error instead of a misleading
    # mode-0x02 one (mode-0x02 files have no block index to walk).
    with open(args.pgen_file, "rb") as fh:
        mode_byte = fh.read(3)[2:3]
    if mode_byte == b"\x02":
        h = read_pgen_header(args.pgen_file)
        print(
            f"pgen: {h.path}\nstorage mode: 0x02 (fixed-width hard calls)\n"
            f"variants: {h.num_variants}\nsamples: {h.num_samples}\n"
            f"record size: {h.record_size} bytes\n"
            f"records offset: {h.records_offset}"
        )
    else:
        print(describe_pgen(args.pgen_file).summary())
    return 0


_FILES = {"roh": _roh, "export": _export, "annotate": _annotate, "merge": _merge,
          "diff": _diff, "concat": _concat, "split": _split, "isec": _isec, "sort": _sort,
          "index": _index, "view": _view, "describe": _describe}


def _files(parser, args) -> int:
    """ROADMAP §1 item 13's subcommands, dispatched as pgen_tpu.cli.main
    does: one GPU for the card stages of ``CARD_FILES``, the host alone for
    ``HOST_FILES``. export, roh and annotate take the query flags of
    pgen_tpu (annotate only its sample selections, for --fill-info)."""
    _refuse_unserved(parser, args, _UNSERVED_ANALYTICS)
    _refuse_ranks(parser, args)
    if args.command in ("export", "roh"):
        _compose_queries(args)
    elif args.command == "annotate":
        from pgen_tpu_torch.query.samples import apply_keep_remove, apply_samples

        if args.keep or args.remove:
            args.sam_query = apply_keep_remove(args.sam_query, args.keep, args.remove)
        args.sam_query = apply_samples(args.sam_query, args.samples, args.samples_file)
    return _FILES[args.command](args)


_RUNS = {"glm": _glm, "score": _score, "king": _king, "genome": _genome, "pca": _pca,
         **dict.fromkeys(REPORTS, _report), "stats": _stats, "fst": _fst, "ld": _ld,
         "prune": _prune, "clump": _clump}


def _launched_ranks() -> int:
    """The number of ranks a launcher names in the environment (1 for none)."""
    return int(os.environ.get("WORLD_SIZE", os.environ.get("PGEN_TPU_NUM_PROCS", "1")))


def _refuse_ranks(parser, args) -> None:
    """Under several ranks, parser.error for what pgen_tpu has no mesh step
    for: every subcommand outside ``MESH``, glm --interaction and --logistic
    (a phenotype that makes glm logistic is refused once it is read)."""
    from pgen_tpu_torch.parallel.mesh import ranks_refusal

    world = _launched_ranks()
    if world <= 1:
        return
    if args.command not in MESH:
        parser.error(ranks_refusal(args.command, world, args.command))
    if args.command == "glm" and args.interaction:
        parser.error(ranks_refusal("glm --interaction", world, "its --interaction scan"))
    if args.command == "glm" and args.model == "logistic":
        parser.error(ranks_refusal("glm --logistic", world, "its logistic IRLS"))


@contextlib.contextmanager
def _rank0_speaks():
    """Ranks other than 0 print nothing while the run lasts: their stdout,
    stderr and log go nowhere (an error line is printed after it)."""
    from pgen_tpu_torch.parallel.distributed import env_rank
    from pgen_tpu_torch.utils.log import get_logger

    if env_rank() == 0:
        yield
        return
    get_logger("cli")  # the package's log is set up, so its level stays as set here
    log = logging.getLogger("pgen_tpu")
    level = log.level
    log.setLevel(logging.CRITICAL + 1)
    try:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
                contextlib.redirect_stderr(null):
            yield
    finally:
        log.setLevel(level)


def _analytics(parser, args) -> int:
    """glm, score, king, genome, pca, the reports, stats, fst, ld, prune and
    clump: one GPU, or under several ranks (``MESH`` only) one process per
    GPU over variant shards; the common query flags."""
    from pgen_tpu_torch.parallel.mesh import SingleRankOnly

    _refuse_unserved(parser, args, _UNSERVED_ANALYTICS)
    _refuse_ranks(parser, args)
    _compose_queries(args)
    try:
        with _rank0_speaks():
            return _RUNS[args.command](args)
    except SingleRankOnly as e:
        parser.error(str(e))


def _import(parser, args) -> int:
    """``import`` of a VCF (K4 on --device), or of a PLINK1 .bed, which is
    host code in pgen_tpu as in the port: --device does not touch it."""
    _refuse_unserved(parser, args, _UNSERVED_IMPORT)
    if args.vcf_file.endswith(".bed"):
        from pgen_tpu_torch.pipeline.bed_import_host import import_bed

        result = import_bed(args.vcf_file, out_prefix=args.out_prefix)
    else:
        from pgen_tpu_torch.pipeline.vcf_import import import_vcf

        result = import_vcf(args.vcf_file, out_prefix=args.out_prefix, device=args.device)
    if args.stats:
        print(result.timer.report(), file=sys.stderr)
    print(
        f"imported {result.num_variants} variants x "
        f"{result.num_samples} samples -> {result.out_prefix}.pgen",
        file=sys.stderr,
    )
    return 0


def _launch_text(counts: dict) -> str:
    """``name N`` of each kernel a shard can launch (``shard.REPORTED``)."""
    from pgen_tpu_torch.parallel.shard import REPORTED

    return ", ".join(f"{name} {counts[name]}" for name in REPORTED)


def _worker_lines(result, t0: float) -> list:
    """--stats of --workers: one line a worker of ``result`` (the start
    method; when it entered, after ``t0``, and how long its shard ran; its
    launches of K2, K3 and the counts K8, K9, K14; its peak pinned host and
    device bytes). ``--workers 1`` runs in this process, which has no
    worker to report."""
    from pgen_tpu_torch.parallel.shard import _mp_context

    method = _mp_context().get_start_method()
    return [
        f"worker {i} ({method}): entered {r['entered'] - t0:.3f} s after the start, "
        f"ran {r['seconds']:.3f} s; launches {_launch_text(r)}; pinned {r['pinned']} B, "
        f"device peak {r['device_peak']} B"
        for i, r in sorted(getattr(result, "worker_reports", {}).items())
    ]


def _filter(args) -> int:
    """filter, dispatched in pgen_tpu's order: --out-format bed, pgen,
    --workers, --shards, --provider device, the one-process filter."""
    rc = _compose_filter_queries(args)
    if rc:
        return rc
    # pgen_tpu raises these as ValueError: exit code 1 through main's wrapper
    if args.out_file == "-":
        if args.out_format != "vcf":
            raise ValueError("-o - (stdout) supports VCF output only")
        if args.workers is not None or args.shards is not None or args.provider == "device":
            raise ValueError(
                "-o - (stdout) requires the single-process filter "
                "(drop --workers/--shards/--provider device)"
            )
    if args.index:
        if not str(args.out_file or "").endswith(".gz"):
            raise ValueError("--index requires -o out.vcf.gz")
        if args.shards is not None and args.shard_index is not None:
            raise ValueError(
                "--index needs the complete file: drop --shard-index "
                "(the merged run can index) or index afterwards"
            )
        if args.out_format != "vcf":
            raise ValueError("--index applies to VCF output only")

    kwargs = {"block_variants": args.block_variants} if args.block_variants else {}
    common = dict(var_query=args.var_query, sam_query=args.sam_query, device=args.device,
                  provider=args.provider)
    lines = []
    with _profile(args.profile, args.device):
        if args.out_format == "bed":
            from pgen_tpu_torch.pipeline.bed_import import filter_to_bed

            # pgen_tpu's bed output takes no --block-variants
            result = filter_to_bed(args.pfile_prefix, out_prefix=args.out_file, **common)
        elif args.out_format == "pgen":
            from pgen_tpu_torch.pipeline.pgen_out import filter_to_pgen

            result = filter_to_pgen(args.pfile_prefix, out_prefix=args.out_file, **common,
                                    **kwargs)
        elif args.workers is not None:
            from pgen_tpu_torch.parallel.shard import filter_to_vcf_parallel

            t0 = time.time()
            result = filter_to_vcf_parallel(
                args.pfile_prefix,
                out_file=args.out_file,
                num_workers=args.workers,
                resume=args.resume,
                index=args.index,
                index_format=args.index_format,
                **common,
                **kwargs,
            )
            lines = _worker_lines(result, t0)
        elif args.shards is not None:
            from pgen_tpu_torch.parallel.shard import filter_to_vcf_sharded, reported_wrappers

            wrappers = reported_wrappers()
            before = {name: w.launches for name, w in wrappers.items()}
            result = filter_to_vcf_sharded(
                args.pfile_prefix,
                out_file=args.out_file,
                num_shards=args.shards,
                shard_index=args.shard_index,
                index=args.index,
                index_format=args.index_format,
                **common,
                **kwargs,
            )
            lines = ["launches: " + _launch_text(
                {name: w.launches - before[name] for name, w in wrappers.items()})]
        elif args.provider == "device":
            from pgen_tpu_torch.pipeline.mesh_filter import filter_to_vcf_mesh

            result = filter_to_vcf_mesh(
                args.pfile_prefix,
                var_query=args.var_query,
                sam_query=args.sam_query,
                out_file=args.out_file,
                device=args.device,
                index=args.index,
                index_format=args.index_format,
                **kwargs,
            )
            lines = [f"predicate route: {result.route}"]
        else:
            from pgen_tpu_torch.pipeline.filter import filter_to_vcf

            result = filter_to_vcf(
                args.pfile_prefix,
                var_query=args.var_query,
                sam_query=args.sam_query,
                out_file=args.out_file,
                device=args.device,
                index=args.index,
                index_format=args.index_format,
                emit_threads=1 if args.threads is None else args.threads,
                **kwargs,
            )
    if args.stats:
        # the device provider's route before the report; workers' and shards' lines after it
        if lines and lines[0].startswith("predicate route"):
            print(lines.pop(0), file=sys.stderr)
        print("\n".join([result.timer.report(), *lines]), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    """Run one subcommand; the exit code. Argument errors, argparse's own
    and the port's refusals of what it does not serve, exit with 2 through
    ``parser.error``. Past them the run fails fast as pgen_tpu's does: a
    broken pipe returns 141, any other exception prints one line to stderr
    and returns 1."""
    parser = build_torch_arg_parser()
    args = parser.parse_args(argv)
    if args.command == "filter":
        _refuse_unserved(parser, args, _UNSERVED)
    try:
        if args.command == "import":
            return _import(parser, args)
        if args.command == "query":
            _refuse_ranks(parser, args)
            return _query(args)
        if args.command in _RUNS:
            return _analytics(parser, args)
        if args.command in _FILES:
            return _files(parser, args)
        return _filter(args)
    except BrokenPipeError:
        return 141
    except Exception as e:  # fail-fast semantics, clean exit
        print(f"pgen-tpu: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
