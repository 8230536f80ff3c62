"""``glm`` on one GPU: the port of ``pgen_tpu/pipeline/glm.py``'s
``glm_pfile`` with pgen_tpu's device provider.

Step for step as pgen_tpu: the masks of the two include-predicates (the
port's ``compute_masks``, genotype counts on the device), the phenotype
and covariates (psam columns or ``--pheno``/``--covar`` TSVs joined on IID)
and plink2's case/control 0-as-missing rule, ``--condition`` dosage
covariates, ``--covar-variance-standardize``, the collinearity check, the
host gather of the kept rows, then each design's moments and solve,
emission (``.6g`` cells, one row per test, the GENO_2DF rows of the 2-df
modifiers) and ``--adjust``. Every moment product and IRLS product runs on
``device`` through the port's ops (``ops/glm.py``, ``ops/logistic.py``);
the jax-free helpers are the port's copies of pgen_tpu's
(``pipeline/glm_host.py``).

Under a process group of several ranks (``parallel/mesh.py``) rank r
gathers only its contiguous shard of the kept variants and makes their
moments, which every rank then all-gathers in rank order
(``glm_moments_mesh``, ``glm_geno_moments_mesh``: every --modifier design
reaches the latter), so that the f64 solve is one rank's; rank 0 alone
writes the table and the --adjust file. Every rank reads the phenotypes,
covariates and --condition dosages whole and checks them the same way
before the first collective. Logistic models and --interaction have no
mesh step in pgen_tpu and are refused there (``SingleRankOnly``).

Stages (``GlmRunResult.timer``): process_group, predicates, phenotypes,
gather, then moments (its all_gather inside) and solve (linear) or irls
(logistic), emit and adjust; under several ranks, one line a rank.
"""

from __future__ import annotations

import contextlib

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.pipeline.glm_host import (
    GlmRunResult,
    _external_column,
    detect_model,
    parse_numeric_column,
)
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.ops import glm as ops_glm
from pgen_tpu_torch.ops import logistic as ops_logistic
from pgen_tpu_torch.parallel.mesh import SingleRankOnly, ranks_refusal, variant_mesh
from pgen_tpu_torch.pipeline.filter import compute_masks

log = get_logger("torch.glm")


def _phenotypes(pheno_name, covar_names, pheno_file, covar_file, psam, sam_mask, model):
    """The phenotype and covariate columns over every psam sample (NaN =
    missing) and the analysis cohort's mask, as pgen_tpu builds them."""
    psam_iids = psam.get_column_strs("IID")
    if pheno_file is not None:
        y_all = _external_column(pheno_file, pheno_name, psam_iids)
    else:
        y_all = parse_numeric_column(psam.get_column_strs(pheno_name), pheno_name)
    if covar_file is not None:
        cov_all = [_external_column(covar_file, c, psam_iids) for c in covar_names]
    else:
        cov_all = [parse_numeric_column(psam.get_column_strs(c), c) for c in covar_names]
    complete = ~np.isnan(y_all)
    for c in cov_all:
        complete &= ~np.isnan(c)
    if model != "linear":
        # plink2 case/control coding: a {0,1,2}-valued phenotype with both 1
        # and 2 present means 0 = missing, 1 = control, 2 = case
        vals = np.unique(y_all[sam_mask & complete])
        if (vals.size and np.isin(vals, (0.0, 1.0, 2.0)).all()
                and 0.0 in vals and 1.0 in vals and 2.0 in vals):
            n_zero = int((y_all[sam_mask & complete] == 0.0).sum())
            log.warning(
                "glm: %s looks case/control (values 0/1/2); treating 0 as "
                "missing per plink coding (%d sample(s) dropped)", pheno_name, n_zero,
            )
            complete &= y_all != 0.0
    return y_all, cov_all, sam_mask & complete


def _condition_dosages(condition, pvar, records, header, sam_idx) -> np.ndarray:
    """(K, n_cond) alt dosages of the --condition variants over the cohort,
    missing calls mean-imputed (pgen_tpu's pinned spec)."""
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    row_of = {}
    for row, vid in enumerate(pvar.get_column_strs("ID")):
        row_of.setdefault(vid, row)
    rows = []
    for vid in condition:
        if vid not in row_of:
            raise ValueError(f"glm: --condition variant {vid!r} not found")
        rows.append(row_of[vid])
    codes = unpack_codes_numpy(records[np.asarray(rows)], header.num_samples)[:, sam_idx]
    cal = codes != 3
    g = codes.astype(np.float64) * cal
    nc = cal.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        means = np.where(nc > 0, g.sum(axis=1) / np.maximum(nc, 1), 0.0)
    return np.where(cal, g, means[:, None]).T


class _TestView:
    """The scalar result surface (n_obs, beta, se, t_stat, p) of a fit, or
    of one test column of a multi-test fit."""

    def __init__(self, res, column=None):
        pick = (lambda a: a) if column is None else (lambda a: a[:, column])
        self.n_obs = res.n_obs
        self.beta, self.se, self.p = pick(res.beta), pick(res.se), pick(res.p)
        self.t_stat = pick(res.z_stat if hasattr(res, "z_stat") else res.t_stat)


def _fit(kept, header, y, covars, model, modifier, interaction, firth, dev, subset, kw,
         timer, rec):
    """Moments and solve, or IRLS, of the chosen design on ``dev``. Returns
    (multi-test result or None, scalar view, joint stat, joint p)."""
    k = covars.shape[1]
    ns = header.num_samples
    nbytes = kept.shape[0] * rec
    if modifier is not None:
        if model == "logistic":
            with timer.stage("irls", nbytes):
                res = ops_logistic.glm_logistic_modifier(
                    kept, ns, y, covars, modifier, dev, sample_idx=subset, firth=firth, **kw)
            _log_firth(res.firth, firth)
        else:
            with timer.stage("moments", nbytes):
                m = ops_glm.glm_geno_moments_mesh(kept, ns, y, covars, dev, sample_idx=subset,
                                                  timer=timer, **kw)
            with timer.stage("solve"):
                res = ops_glm.glm_solve_modifier(m, k, modifier)
        multi = _TestView(res)
        return multi, _TestView(res, 0), res.joint_stat, res.joint_p
    if interaction:
        if model == "logistic":
            with timer.stage("irls", nbytes):
                res = ops_logistic.glm_logistic_interaction(
                    kept, ns, y, covars, dev, sample_idx=subset, firth=firth, **kw)
            _log_firth(res.firth, firth)
        else:
            with timer.stage("moments", nbytes):
                m = ops_glm.glm_int_moments(kept, ns, y, covars, dev, sample_idx=subset, **kw)
            with timer.stage("solve"):
                res = ops_glm.glm_solve_interaction(m, k, covar_means=covars.mean(axis=0))
        return _TestView(res), _TestView(res, 0), None, None
    if model == "logistic":
        with timer.stage("irls", nbytes):
            res = ops_logistic.glm_logistic(
                kept, ns, y, covars, dev, sample_idx=subset, firth=firth, **kw)
        _log_firth(res.firth, firth)
        return None, _TestView(res), None, None
    with timer.stage("moments", nbytes):
        m = ops_glm.glm_moments_mesh(kept, ns, y, covars, dev, sample_idx=subset, timer=timer,
                                     **kw)
    with timer.stage("solve"):
        res = ops_glm.glm_solve(m, k)
    return None, _TestView(res), None, None


def _log_firth(fused, firth: str) -> None:
    if fused is not None and fused.any():
        log.info("glm: %d site(s) fit by Firth regression (%s)", int(fused.sum()), firth)


def _cells(b, s_, st, pv, logistic: bool) -> str:
    if np.isnan(b):
        return "NA\tNA\tNA\tNA"
    if logistic:
        return f"{np.exp(b):.6g}\t{s_:.6g}\t{st:.6g}\t{pv:.6g}"
    return f"{b:.6g}\t{s_:.6g}\t{st:.6g}\t{pv:.6g}"


def _emit(fh, pvar, var_idx, tests, multi, res, joint_stat, joint_p, model) -> None:
    """The plink2 .glm table: a header, then per kept variant one row per
    test and, for the 2-df designs, a GENO_2DF row (BETA/SE NA; the stat
    column holds F or the Wald chi-square)."""
    chroms, poss, ids, refs, alts = (
        pvar.get_column_strs(c) for c in ("CHROM", "POS", "ID", "REF", "ALT")
    )
    has_joint = joint_stat is not None
    logistic = model == "logistic"
    if logistic:
        statname = "Z_OR_CHISQ_STAT" if has_joint else "Z_STAT"
        cols = f"OR\tLOG(OR)_SE\t{statname}\tP"
    else:
        statname = "T_OR_F_STAT" if has_joint else "T_STAT"
        cols = f"BETA\tSE\t{statname}\tP"
    fh.write(f"#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\t{cols}\n")
    for r, v in enumerate(var_idx):
        v = int(v)
        prefix_row = f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t{refs[v]}\t{alts[v]}\t{alts[v]}"
        for ti, tname in enumerate(tests):
            if multi is not None:
                tail = _cells(multi.beta[r, ti], multi.se[r, ti], multi.t_stat[r, ti],
                              multi.p[r, ti], logistic)
            else:
                tail = _cells(res.beta[r], res.se[r], res.t_stat[r], res.p[r], logistic)
            fh.write(f"{prefix_row}\t{tname}\t{res.n_obs[r]}\t{tail}\n")
        if has_joint:
            js, jp = joint_stat[r], joint_p[r]
            jtail = "NA\tNA\tNA\tNA" if np.isnan(js) else f"NA\tNA\t{js:.6g}\t{jp:.6g}"
            fh.write(f"{prefix_row}\t{ops_glm.JOINT_TEST_NAME}\t{res.n_obs[r]}\t{jtail}\n")


def _write_adjusted(path, pvar, var_idx, adj) -> None:
    chroms, poss, ids, refs, alts = (
        pvar.get_column_strs(c) for c in ("CHROM", "POS", "ID", "REF", "ALT")
    )
    with open(path, "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tA1\tUNADJ\tGC\tBONF\tHOLM\tSIDAK_SS\t"
                 "SIDAK_SD\tFDR_BH\tFDR_BY\n")
        for i, r in enumerate(adj.order):
            v = int(var_idx[r])
            cells = "\t".join(
                f"{col[i]:.6g}"
                for col in (adj.unadj, adj.gc, adj.bonf, adj.holm, adj.sidak_ss,
                            adj.sidak_sd, adj.fdr_bh, adj.fdr_by)
            )
            fh.write(f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t{refs[v]}\t{alts[v]}\t{alts[v]}\t"
                     f"{cells}\n")


def glm_pfile(
    pfile_prefix: str,
    pheno_name: str = "PHENO1",
    covar_names=(),
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    device="cuda",
    block_variants: int | None = None,
    model: str = "auto",
    firth: str = "fallback",
    pheno_file: str | None = None,
    covar_file: str | None = None,
    condition=(),
    write: bool = True,
    out=None,
    interaction: bool = False,
    adjust: bool = False,
    adjust_lambda: float | None = None,
    covar_variance_standardize: bool = False,
    out_base: str | None = None,
    modifier: str | None = None,
) -> GlmRunResult:
    """pgen_tpu's ``glm_pfile`` with ``provider="device"``, its device work
    on ``device`` (``"cuda"``, which must be available, or ``"cpu"``, the
    kernels' plain versions), over this rank's variant shard under a
    process group. Same arguments otherwise, same output bytes up to the
    f32 rounding of the moments, written by rank 0."""
    if adjust and out is not None:
        raise ValueError(
            "glm: --adjust writes a separate .adjusted file; use a file -o, not '-'"
        )
    if modifier is not None:
        if modifier not in ops_glm.MODIFIER_COLS:
            raise ValueError(f"glm: unknown modifier {modifier!r}")
        if interaction:
            raise ValueError(
                "glm: --modifier and --interaction are mutually exclusive (pick one design)"
            )
    timer = StageTimer()
    with variant_mesh(device, timer) as mesh:
        return _glm_pfile(pfile_prefix, pheno_name, covar_names, var_query, sam_query,
                          out_file, block_variants, model, firth, pheno_file, covar_file,
                          condition, write, out, interaction, adjust, adjust_lambda,
                          covar_variance_standardize, out_base, modifier, mesh)


def _glm_pfile(pfile_prefix, pheno_name, covar_names, var_query, sam_query, out_file,
               block_variants, model, firth, pheno_file, covar_file, condition, write, out,
               interaction, adjust, adjust_lambda, covar_variance_standardize, out_base,
               modifier, mesh) -> GlmRunResult:
    dev, timer = mesh.device, mesh.timer
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
        var_idx = np.flatnonzero(var_mask)

    with timer.stage("phenotypes"):
        kept_before = int(sam_mask.sum())
        y_all, cov_all, sam_mask = _phenotypes(pheno_name, covar_names, pheno_file,
                                               covar_file, psam, sam_mask, model)
        sam_idx = np.flatnonzero(sam_mask)
        dropped = kept_before - len(sam_idx)
    n_sam = len(sam_idx)
    k = len(covar_names)
    if n_sam < k + 3:
        raise ValueError(
            f"glm: {n_sam} analyzable samples is too few for {k} covariate(s) "
            f"(need >= {k + 3})"
        )
    if dropped:
        log.warning("glm: %d sample(s) dropped for missing %s/covariates", dropped, pheno_name)
    y = y_all[sam_idx]
    covars = np.stack([c[sam_idx] for c in cov_all], axis=1) if k else np.zeros((n_sam, 0))
    covar_labels = list(covar_names)
    condition = [c for c in (condition or ()) if c]
    if condition:
        covars = np.concatenate(
            [covars, _condition_dosages(condition, pvar, records, header, sam_idx)], axis=1
        )
        covar_labels += [f"dosage({v})" for v in condition]
        k = covars.shape[1]
        if n_sam < k + 3:
            raise ValueError(
                f"glm: {n_sam} analyzable samples is too few for {k} covariate(s) incl. "
                f"--condition (need >= {k + 3})"
            )
    if covar_variance_standardize and k:
        mu, sd = covars.mean(axis=0), covars.std(axis=0)
        if (sd == 0).any():
            bad = [covar_labels[i] for i in np.flatnonzero(sd == 0)]
            raise ValueError(
                "glm: --covar-variance-standardize: constant covariate column(s) over the "
                f"cohort: {', '.join(bad)}"
            )
        covars = (covars - mu) / sd
    if np.nanstd(y) == 0:
        raise ValueError(f"glm: phenotype {pheno_name} is constant")
    model, y = detect_model(y, model)
    if k:
        x0 = np.column_stack([np.ones(n_sam), covars])
        if np.linalg.matrix_rank(x0) < x0.shape[1]:
            raise ValueError(
                "glm: covariates are collinear with the intercept over the analysis "
                f"cohort (constant column among {covar_labels}?)"
            )
    if interaction:
        if k == 0:
            raise ValueError("glm: --interaction needs at least one covariate")
        if n_sam < 2 * k + 3:
            raise ValueError(
                f"glm: {n_sam} analyzable samples is too few for the interaction design "
                f"(need >= {2 * k + 3})"
            )

    if mesh.world > 1 and (model == "logistic" or interaction):
        raise SingleRankOnly(ranks_refusal(
            "glm --interaction" if interaction else "logistic glm", mesh.world,
            "its --interaction scan" if interaction else "its logistic IRLS"))

    lo, hi = mesh.shard(len(var_idx), "moments")
    with timer.stage("gather", (hi - lo) * rec):
        kept = _gather_rows(records, var_idx[lo:hi])
    subset = None if n_sam == header.num_samples else sam_idx.astype(np.int32)
    kw = {"block_variants": int(block_variants)} if block_variants else {}
    multi, res, joint_stat, joint_p = _fit(kept, header, y, covars, model, modifier,
                                           interaction, firth, dev, subset, kw, timer, rec)
    mesh.report_ranks()
    write = write and mesh.rank == 0

    if out_file is not None:
        out_path = out_file
    elif out_base is not None:
        out_path = f"{out_base}.glm.{model}"
    else:
        out_path = f"{pfile_prefix}.{pheno_name}.glm.{model}"
    if write:
        if interaction:
            tests = ["ADD"] + [f"ADDx{lab}" for lab in covar_labels]
        elif modifier is not None:
            tests = list(ops_glm.MODIFIER_TESTS[modifier])
        else:
            tests = ["ADD"]
        with timer.stage("emit"):
            cm = contextlib.nullcontext(out) if out is not None else open(out_path, "w")
            with cm as fh:
                _emit(fh, pvar, var_idx, tests, multi, res, joint_stat, joint_p, model)
    if adjust:
        from pgen_tpu_torch.ops.adjust import adjust_pvalues

        with timer.stage("adjust"):
            adj = adjust_pvalues(res.p, res.t_stat, lambda_gc=adjust_lambda)
        log.info("glm --adjust: genomic inflation est. lambda = %.6g over %d tested "
                 "variant(s)", adj.lambda_gc, len(adj.order))
        if write:
            _write_adjusted(f"{out_path}.adjusted", pvar, var_idx, adj)
    log.info("glm (%s): %s", dev, timer.report())
    return GlmRunResult(
        pheno_name=pheno_name,
        model=model,
        num_variants=len(var_idx),
        num_samples=n_sam,
        num_dropped=dropped,
        n_obs=res.n_obs,
        beta=res.beta,
        se=res.se,
        t_stat=res.t_stat,
        p=res.p,
        out_path=None if out is not None else out_path,
        timer=timer,
    )
