"""Per-variant logistic association (case/control GWAS): batched IRLS
where every gradient/Hessian entry is a masked-moment matmul.

The plink2 `--glm` logistic analog (plink2 runs logistic whenever the
phenotype is case/control; extension over the reference, which is a
query/filter tool — pgen-rs/README.md:3-5). For each variant v,
maximum-likelihood logistic regression of case status on
[1, covariates, alt-dosage] over that variant's complete cases.

TPU-first formulation, same trick as the linear path (ops/glm.py): with
per-iteration working weights w_vs = mu(1-mu)·mask and working residual
r_vs = (y - mu)·mask, Newton's update needs

    grad_v  = [sum r,  r @ C,          sum r·g]
    hess_v  = masked-weighted sums of {1, c_i, c_i c_j, g, g c_i, g^2}

— all (V, S) x (S, P) matmuls per IRLS iteration (MXU work on the
device provider, dgemm on host), plus a batched (k+2)-dim solve on host
f64. Variants converge independently and retire from the active set.

Per-variant gates and failures (reported NaN, matching plink2's NA):
  - fewer complete cases than k + 3, zero dosage variance,
  - single-class outcome among complete cases (quasi-separation of the
    trivial kind), or
  - IRLS failing to converge in max_iter Newton steps.

Firth rescue (plink2 `--glm firth-fallback` semantics, plink2's default
logistic mode): sites where vanilla IRLS fails to converge — the classic
(quasi-)separation signature — re-fit with Jeffreys-prior penalized
likelihood (Firth 1993): the score gains the hat-diagonal term
    U*(b) = X^T (y - mu + h (1/2 - mu)),   h_s = w_s x_s^T (X^T W X)^-1 x_s
which keeps the MLE finite under separation. In the blocked masked-moment
formulation h is three extra small (V,k)x(k,S) products against the
inverted per-variant information matrix — the big (V,S)x(S,P) moment
matmuls are unchanged (same MXU path on the device provider).
`firth="always"` forces Firth everywhere (plink2 `--glm firth`);
`firth="none"` disables the rescue (plink2 `--glm no-firth`).

Wald test: Z = beta_g / SE, SE^2 = (H^-1)_gg at the optimum; two-sided
p from the exact normal tail (math.erfc — elementwise-exact f64).

Copied from ``pgen_tpu/ops/logistic.py``, the host IRLS: only the
imports differ, and ``pgen-rs/`` stands for the reference tool's sources
in citations. Left out, because they run jax: ``_device_matmul``,
``glm_logistic`` (whose device provider takes it), ``glm_logistic_modifier``
(which imports pgen_tpu's jax-importing ``ops/glm.py``) and the
``provider == "device"`` branch of ``glm_logistic_interaction``. The
port's entry points, with the products on the card, are
``ops/logistic.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class LogisticResult(NamedTuple):
    n_obs: np.ndarray  # (V,) i64 complete-case count
    beta: np.ndarray  # (V,) f64 log-odds per alt allele, NaN on failure
    se: np.ndarray  # (V,) f64
    z_stat: np.ndarray  # (V,) f64
    p: np.ndarray  # (V,) f64
    n_iter: np.ndarray  # (V,) i32 Newton steps used (0 where gated)
    firth: np.ndarray = None  # (V,) bool: site fit by Firth regression


def _cov_pairs(covars: np.ndarray) -> np.ndarray:
    """(S, k(k+1)/2) upper-triangle covariate products, row-major."""
    k = covars.shape[1]
    return np.stack(
        [covars[:, i] * covars[:, j] for i in range(k) for j in range(i, k)],
        axis=1,
    ) if k else np.zeros((covars.shape[0], 0))


_erfc = np.vectorize(math.erfc)


def normal_sf2(z) -> np.ndarray:
    """Two-sided normal p-value P(|Z| >= |z|) = erfc(|z|/sqrt(2)), f64."""
    z = np.asarray(z, dtype=np.float64)
    out = np.full(z.shape, np.nan)
    fin = np.isfinite(z)
    if fin.any():
        out[fin] = _erfc(np.abs(z[fin]) / math.sqrt(2.0))
    return out


# additive recode: het weight 1, hom-alt weight 2 (the classic dosage)
_ADD_GLUT = ((1.0, 2.0),)


def _geno_columns(codes: np.ndarray, gluts) -> list:
    """(Vb, S) genotype design columns from the (het, hom) weights.
    Missing (code 3) contributes 0 to every column, like the mask."""
    het = (codes == 1).astype(np.float64)
    hom = (codes == 2).astype(np.float64)
    return [a1 * het + a2 * hom for (a1, a2) in gluts]


def _geno_gates(n, gs, ncase, d):
    """Per-variant estimability gate shared by the IRLS drivers: enough
    complete cases, both outcome classes, variance in every genotype
    column, and (2-column designs) a non-singular genotype Gram."""
    ok = (n >= d + 1) & (ncase > 0) & (ncase < n)
    nz = np.maximum(n, 1)
    sums = [g.sum(axis=1) for g in gs]
    with np.errstate(invalid="ignore", divide="ignore"):
        for g, s in zip(gs, sums):
            gvar = (g * g).sum(axis=1) - np.where(n > 0, s * s / nz, 0.0)
            ok &= gvar > 1e-9 * nz
        if len(gs) == 2:
            c00 = (gs[0] * gs[0]).sum(axis=1) - sums[0] ** 2 / nz
            c11 = (gs[1] * gs[1]).sum(axis=1) - sums[1] ** 2 / nz
            c01 = (gs[0] * gs[1]).sum(axis=1) - sums[0] * sums[1] / nz
            ok &= (c00 * c11 - c01 * c01) > 1e-9 * nz
    return ok


def _assemble_hess_multi(h1, hc, hcc, hgs, hgcs, hggs, k: int) -> np.ndarray:
    """Symmetric (V, d, d) from weighted moments for m genotype columns;
    d = k + 1 + m, layout [1, c_1..c_k, g_1..g_m]. hgs/hgcs are length-m
    lists; hggs maps (i, j) i<=j to the (V,) cross sums."""
    m = len(hgs)
    v = h1.shape[0]
    d = k + 1 + m
    h = np.zeros((v, d, d), dtype=np.float64)
    h[:, 0, 0] = h1
    h[:, 0, 1 : 1 + k] = hc
    h[:, 1 : 1 + k, 0] = hc
    pos = 0
    for i in range(k):
        for j in range(i, k):
            h[:, 1 + i, 1 + j] = hcc[:, pos]
            h[:, 1 + j, 1 + i] = hcc[:, pos]
            pos += 1
    for t in range(m):
        j = k + 1 + t
        h[:, 0, j] = hgs[t]
        h[:, j, 0] = hgs[t]
        h[:, 1 : 1 + k, j] = hgcs[t]
        h[:, j, 1 : 1 + k] = hgcs[t]
        for u in range(t, m):
            h[:, j, k + 1 + u] = hggs[(t, u)]
            h[:, k + 1 + u, j] = hggs[(t, u)]
    return h


def _joint_wald(zsol, b, k: int, m: int):
    """2-df Wald chi-square from the unit-column solves: S = the m x m
    genotype block of H^-1, chi2 = b' S^-1 b (NaN on a bad block)."""
    gidx = np.arange(k + 1, k + 1 + m)
    s = zsol[:, gidx, :][:, :, :]  # (F, m, m)
    det = s[:, 0, 0] * s[:, 1, 1] - s[:, 0, 1] * s[:, 1, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        inv00 = s[:, 1, 1] / det
        inv11 = s[:, 0, 0] / det
        inv01 = -s[:, 0, 1] / det
        chi2 = (
            b[:, 0] ** 2 * inv00
            + b[:, 1] ** 2 * inv11
            + 2.0 * b[:, 0] * b[:, 1] * inv01
        )
    bad = ~(np.isfinite(chi2) & (det > 0) & (chi2 >= 0))
    return np.where(bad, np.nan, chi2)


def _irls_block(
    codes: np.ndarray,  # (Vb, S) u8, 3 = missing
    y: np.ndarray,  # (S,) f64 in {0, 1}
    covars: np.ndarray,  # (S, k)
    cc: np.ndarray,  # (S, k(k+1)/2) covariate products
    max_iter: int,
    tol: float,
    matmul=None,
    gluts=_ADD_GLUT,
):
    """IRLS over one variant block; returns per-variant (n, beta (Vb, m),
    se (Vb, m), niter, converged, ok, joint_chi2). `matmul(A, B)` computes
    the masked-moment products (host dgemm by default; the device provider
    supplies an MXU closure). `gluts` selects the genotype design columns
    (ops/glm.py MODIFIER_COLS recodes); the default is the additive model.
    """
    vb, ns = codes.shape
    k = covars.shape[1]
    nm = len(gluts)
    d = k + 1 + nm
    mm = matmul if matmul is not None else lambda a, b: a @ b
    cal = codes != 3
    m = cal.astype(np.float64)
    gs = _geno_columns(codes, gluts)
    n = m.sum(axis=1)
    ncase = m @ y
    ok = _geno_gates(n, gs, ncase, d)
    beta = np.zeros((vb, d), dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        p0 = np.clip(ncase / np.maximum(n, 1), 1e-12, 1 - 1e-12)
    beta[:, 0] = np.where(ok, np.log(p0 / (1.0 - p0)), 0.0)
    se = np.full((vb, nm), np.nan)
    joint = np.full(vb, np.nan)
    niter = np.zeros(vb, dtype=np.int32)
    converged = np.zeros(vb, dtype=bool)
    active = np.flatnonzero(ok)
    # Q columns for the r/w moment matmuls: [c_1..c_k, c_i c_j products]
    q = np.concatenate([covars, cc], axis=1)  # (S, k + kk)
    kk = cc.shape[1]
    for it in range(1, max_iter + 1):
        if active.size == 0:
            break
        ba = beta[active]
        ma = m[active]
        gas = [g[active] for g in gs]
        # eta/mu/w/r: (Va, S) elementwise — the only non-matmul bulk work
        eta = ba[:, [0]] + ba[:, 1 : 1 + k] @ covars.T
        for t, ga in enumerate(gas):
            eta += ba[:, [k + 1 + t]] * ga
        np.clip(eta, -30.0, 30.0, out=eta)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu) * ma
        r = (y[None, :] - mu) * ma
        wgs = [w * ga for ga in gas]
        # moment matmuls: grad and Hessian entries in (Va,S)x(S,P) GEMMs
        rq = mm(r, covars)  # (Va, k)
        wq = mm(w, q)  # (Va, k + kk): [w@C | w@CC]
        wgcs = [mm(wg, covars) for wg in wgs]  # (Va, k) each
        grad = np.concatenate(
            [r.sum(axis=1)[:, None], rq]
            + [(r * ga).sum(axis=1)[:, None] for ga in gas],
            axis=1,
        )
        hggs = {
            (t, u): (wgs[t] * gas[u]).sum(axis=1)
            for t in range(nm)
            for u in range(t, nm)
        }
        hess = _assemble_hess_multi(
            w.sum(axis=1), wq[:, :k], wq[:, k : k + kk],
            [wg.sum(axis=1) for wg in wgs], wgcs, hggs, k,
        )
        delta = _batched_solve(hess, grad[:, :, None])[:, :, 0]
        # NaN rows (singular Hessians) retire as failed below
        # step-halving cap: |delta| <= 10 componentwise keeps early
        # iterations from overshooting into the flat tails
        scale = np.max(np.abs(delta), axis=1)
        big = scale > 10.0
        delta[big] *= (10.0 / scale[big])[:, None]
        bad = ~np.isfinite(delta).all(axis=1)
        beta[active] += np.where(bad[:, None], 0.0, delta)
        niter[active] = it
        done = (np.abs(delta).max(axis=1) < tol) & ~bad
        if done.any() or bad.any():
            fin = active[done]
            converged[fin] = True
            # SE at the optimum: (H^-1)_gjgj via solves on the unit cols
            if fin.size:
                eg = np.zeros((fin.size, d, nm))
                for t in range(nm):
                    eg[:, k + 1 + t, t] = 1.0
                zsol = _batched_solve(hess[done], eg)
                for t in range(nm):
                    zg = zsol[:, k + 1 + t, t]
                    se[fin, t] = np.sqrt(np.where(zg > 0, zg, np.nan))
                if nm == 2:
                    joint[fin] = _joint_wald(
                        zsol, beta[fin][:, k + 1 :], k, nm
                    )
            keep = ~(done | bad)
            active = active[keep]
    return n, beta[:, k + 1 :], se, niter, converged, ok, joint


def _batched_solve(h: np.ndarray, b: np.ndarray):
    """Batched np.linalg.solve with per-item singular fallback: singular
    members come back NaN instead of poisoning the whole batch."""
    try:
        return np.linalg.solve(h, b)
    except np.linalg.LinAlgError:
        out = np.full(b.shape, np.nan)
        for i in range(h.shape[0]):
            try:
                out[i] = np.linalg.solve(h[i], b[i])
            except np.linalg.LinAlgError:
                pass
        return out


def _batched_inv(h: np.ndarray):
    """(V,d,d) batched inverse; singular members come back NaN with
    ok=False instead of poisoning the whole batch."""
    ok = np.ones(h.shape[0], dtype=bool)
    try:
        return np.linalg.inv(h), ok
    except np.linalg.LinAlgError:
        out = np.full_like(h, np.nan)
        for i in range(h.shape[0]):
            try:
                out[i] = np.linalg.inv(h[i])
            except np.linalg.LinAlgError:
                ok[i] = False
        return out, ok


def _firth_block(
    codes: np.ndarray,  # (Vb, S) u8, 3 = missing
    y: np.ndarray,
    covars: np.ndarray,
    cc: np.ndarray,
    idx: np.ndarray,  # block-local variant indices to (re)fit
    max_iter: int,
    tol: float,
    matmul=None,
    gluts=_ADD_GLUT,
):
    """Firth-penalized IRLS over the selected variants.

    Identical moment structure to `_irls_block` plus the hat diagonal:
    with A = (X^T W X)^-1 and x_s = [1, C_s, g_1s(, g_2s)],
        x_s^T A x_s = A_00 + 2 A_0c.C_s + C_s^T A_cc C_s
                      + sum_j 2 g_j (A_0gj + A_gjc.C_s)
                      + sum_{i<=j} (2 - [i==j]) g_i g_j A_gigj
    — the covariate quadratic reuses the same upper-triangle pair columns
    `cc` the Hessian moments use. SE comes from A_gjgj at the optimum (the
    penalized-likelihood Wald convention, same as logistf/plink2).
    """
    mm = matmul if matmul is not None else lambda a, b: a @ b
    k = covars.shape[1]
    kk = cc.shape[1]
    nm = len(gluts)
    d = k + 1 + nm
    cal = codes[idx] != 3
    m = cal.astype(np.float64)
    gs = _geno_columns(codes[idx], gluts)
    n = m.sum(axis=1)
    ncase = m @ y
    q = np.concatenate([covars, cc], axis=1)
    nb = len(idx)
    beta = np.zeros((nb, d), dtype=np.float64)
    # Firth's penalty is equivalent to splitting each case/control half a
    # count: the matching intercept start is the shrunk log-odds
    p0 = np.clip((ncase + 0.5) / (n + 1.0), 1e-12, 1 - 1e-12)
    beta[:, 0] = np.log(p0 / (1.0 - p0))
    se = np.full((nb, nm), np.nan)
    joint = np.full(nb, np.nan)
    niter = np.zeros(nb, dtype=np.int32)
    converged = np.zeros(nb, dtype=bool)
    active = np.arange(nb)
    # upper-triangle (i<=j) index/weight vectors for the A_cc quadratic
    ii = np.array([i for i in range(k) for j in range(i, k)], dtype=np.intp)
    jj = np.array([j for i in range(k) for j in range(i, k)], dtype=np.intp)
    pw = np.where(ii == jj, 1.0, 2.0)
    for it in range(1, max_iter + 1):
        if active.size == 0:
            break
        ba = beta[active]
        ma = m[active]
        gas = [g[active] for g in gs]
        eta = ba[:, [0]] + ba[:, 1 : 1 + k] @ covars.T
        for t, ga in enumerate(gas):
            eta += ba[:, [k + 1 + t]] * ga
        np.clip(eta, -30.0, 30.0, out=eta)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu) * ma
        wgs = [w * ga for ga in gas]
        wq = mm(w, q)
        wgcs = [mm(wg, covars) for wg in wgs]
        hggs = {
            (t, u): (wgs[t] * gas[u]).sum(axis=1)
            for t in range(nm)
            for u in range(t, nm)
        }
        hess = _assemble_hess_multi(
            w.sum(axis=1), wq[:, :k], wq[:, k : k + kk],
            [wg.sum(axis=1) for wg in wgs], wgcs, hggs, k,
        )
        ainv, inv_ok = _batched_inv(hess)
        a00 = ainv[:, 0, 0]
        a0c = ainv[:, 0, 1 : 1 + k]
        acc_pairs = ainv[:, 1 + ii, 1 + jj] * pw if kk else np.zeros((len(active), 0))
        with np.errstate(invalid="ignore"):
            xax = (
                a00[:, None]
                + 2.0 * (a0c @ covars.T)
                + (acc_pairs @ cc.T)
            )
            for t, ga in enumerate(gas):
                jt = k + 1 + t
                xax += ga * (
                    2.0 * (ainv[:, 0, jt][:, None]
                           + ainv[:, jt, 1 : 1 + k] @ covars.T)
                )
                for u in range(t, nm):
                    ju = k + 1 + u
                    wgt = 1.0 if t == u else 2.0
                    xax += wgt * gas[t] * gas[u] * ainv[:, jt, ju][:, None]
            h = w * xax
            r = (y[None, :] - mu + h * (0.5 - mu)) * ma
        rq = mm(r, covars)
        grad = np.concatenate(
            [r.sum(axis=1)[:, None], rq]
            + [(r * ga).sum(axis=1)[:, None] for ga in gas],
            axis=1,
        )
        with np.errstate(invalid="ignore"):
            delta = np.einsum("vij,vj->vi", ainv, grad)
        # logistf-style step cap: componentwise |delta| <= 5
        scale = np.max(np.abs(delta), axis=1)
        big = scale > 5.0
        delta[big] *= (5.0 / scale[big])[:, None]
        bad = ~np.isfinite(delta).all(axis=1) | ~inv_ok
        beta[active] += np.where(bad[:, None], 0.0, delta)
        niter[active] = it
        done = (np.abs(delta).max(axis=1) < tol) & ~bad
        if done.any() or bad.any():
            fin = active[done]
            converged[fin] = True
            for t in range(nm):
                jt = k + 1 + t
                agg_t = ainv[done, jt, jt]
                se[fin, t] = np.sqrt(np.where(agg_t > 0, agg_t, np.nan))
            if nm == 2:
                zsol = ainv[done][:, :, k + 1 :]  # A columns for g block
                joint[fin] = _joint_wald(zsol, beta[fin][:, k + 1 :], k, nm)
            active = active[~(done | bad)]
    return n, beta[:, k + 1 :], se, niter, converged, joint


class LogisticModResult(NamedTuple):
    """Modifier-design logistic fit; test axis follows the gluts order
    (ops/glm.py MODIFIER_TESTS)."""

    n_obs: np.ndarray    # (V,) i64
    beta: np.ndarray     # (V, T) f64 log-odds, NaN on failure
    se: np.ndarray       # (V, T)
    z_stat: np.ndarray   # (V, T)
    p: np.ndarray        # (V, T)
    joint_stat: np.ndarray | None  # (V,) 2-df Wald chi-square
    joint_p: np.ndarray | None     # (V,)
    n_iter: np.ndarray
    firth: np.ndarray


def _cells_newton(
    nc, yc, n, ncase, x3, tests, idx, firth_mode, iters, cap, tol,
    joint_k=None,
):
    """Vectorized cell-sum Newton/Firth over the selected variants.

    nc/yc: (V, cells) totals/cases; x3: (cells, d) cell design; tests:
    design-column indices reported (beta + SE per column). joint_k:
    when the two test columns form a 2-df genotype block at
    [joint_k+1, joint_k+2], also return the joint Wald chi-square.
    Mirrors the per-sample IRLS/Firth blocks exactly (start, clip,
    step cap, tolerance, SE at the pre-final-step information).
    Returns (beta_tests (F, T), se (F, T), joint (F,), niter, conv)."""
    d = x3.shape[1]
    nt = len(tests)
    f = len(idx)
    ncf, ycf = nc[idx], yc[idx]
    nf, ncasef = n[idx], ncase[idx]
    beta = np.zeros((f, d))
    if firth_mode:
        p0 = np.clip((ncasef + 0.5) / (nf + 1.0), 1e-12, 1 - 1e-12)
    else:
        p0 = np.clip(ncasef / np.maximum(nf, 1), 1e-12, 1 - 1e-12)
    beta[:, 0] = np.log(p0 / (1.0 - p0))
    se = np.full((f, nt), np.nan)
    joint = np.full(f, np.nan)
    niter = np.zeros(f, dtype=np.int32)
    conv = np.zeros(f, dtype=bool)
    active = np.arange(f)
    for it in range(1, iters + 1):
        if active.size == 0:
            break
        eta = np.clip(beta[active] @ x3.T, -30.0, 30.0)  # (A, cells)
        mu = 1.0 / (1.0 + np.exp(-eta))
        wsc = mu * (1.0 - mu)              # per-sample weight
        w = ncf[active] * wsc              # cell-sum weight
        hess = np.einsum("vc,ci,cj->vij", w, x3, x3)
        if firth_mode:
            ainv, inv_ok = _batched_inv(hess)
            hat = wsc * np.einsum("ci,vij,cj->vc", x3, ainv, x3)
            r = (
                ycf[active] - ncf[active] * mu
                + ncf[active] * hat * (0.5 - mu)
            )
            grad = r @ x3
            with np.errstate(invalid="ignore"):
                delta = np.einsum("vij,vj->vi", ainv, grad)
            bad_extra = ~inv_ok
        else:
            grad = (ycf[active] - ncf[active] * mu) @ x3
            delta = _batched_solve(hess, grad[:, :, None])[:, :, 0]
            bad_extra = np.zeros(active.size, dtype=bool)
        scale = np.max(np.abs(delta), axis=1)
        big = scale > cap
        delta[big] *= (cap / scale[big])[:, None]
        bad = ~np.isfinite(delta).all(axis=1) | bad_extra
        beta[active] += np.where(bad[:, None], 0.0, delta)
        niter[active] = it
        done = (np.abs(delta).max(axis=1) < tol) & ~bad
        if done.any() or bad.any():
            fin = active[done]
            conv[fin] = True
            if fin.size:
                if firth_mode:
                    zsol = ainv[done][:, :, tests]
                else:
                    eg = np.zeros((fin.size, d, nt))
                    for c, t in enumerate(tests):
                        eg[:, t, c] = 1.0
                    zsol = _batched_solve(hess[done], eg)
                for c, t in enumerate(tests):
                    zg = zsol[:, t, c]
                    se[fin, c] = np.sqrt(np.where(zg > 0, zg, np.nan))
                if joint_k is not None and nt == 2:
                    joint[fin] = _joint_wald(
                        zsol, beta[fin][:, tests], joint_k, nt
                    )
            active = active[~(done | bad)]
    return beta[:, tests], se, joint, niter, conv


def _cells_triage(
    nc, yc, n, ncase, x3, tests, idx, firth, max_iter, tol, joint_k=None
):
    """Run the vanilla/Firth triage over the selected variants with the
    shared _cells_newton core: firth='always' fits everything penalized;
    'fallback' retries only non-converged sites; 'none' leaves them NA.
    Returns (beta, se, joint, niter, conv, fused) indexed like `idx`."""
    firth_iter = max(max_iter, 256)
    f = len(idx)
    fused = np.zeros(f, dtype=bool)
    if firth == "always":
        beta, se, joint, niter, conv = _cells_newton(
            nc, yc, n, ncase, x3, tests, idx, True, firth_iter, 5.0, tol,
            joint_k=joint_k,
        )
        fused[:] = conv
        return beta, se, joint, niter, conv, fused
    beta, se, joint, niter, conv = _cells_newton(
        nc, yc, n, ncase, x3, tests, idx, False, max_iter, 10.0, tol,
        joint_k=joint_k,
    )
    if firth == "fallback":
        retry = np.flatnonzero(~conv)
        if retry.size:
            fb, fs, fj, fi, fc = _cells_newton(
                nc, yc, n, ncase, x3, tests, idx[retry], True, firth_iter,
                5.0, tol, joint_k=joint_k,
            )
            beta[retry], se[retry], joint[retry] = fb, fs, fj
            niter[retry], conv[retry] = fi, fc
            fused[retry] = fc
    return beta, se, joint, niter, conv, fused


def _logistic_fit_counts(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    sample_idx,
    max_iter: int,
    tol: float,
    firth: str,
    gluts,
    group_inv=None,
    uniq_covars=None,
):
    """Sufficient-statistics fast path: when the linear predictor takes
    one value per (GENOTYPE CLASS x COVARIATE GROUP) cell — always true
    with k = 0 (3 cells), and with covariates whenever they take few
    distinct row values (e.g. SEX, batch: 3G cells) — each variant's
    likelihood depends only on its cases/totals table over the cells.
    2G native genotype-count passes, then Newton/Firth vectorized over
    ALL variants at once on (V, 3G) cell sums. Algebraically the same
    iteration as the per-sample blocks (identical start, step caps,
    tolerance), ~100x faster at cohort scale. Returns the
    _logistic_fit_multi tuple."""
    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    nm = len(gluts)
    if uniq_covars is None:
        uniq_covars = np.zeros((1, 0))
    ng, k = uniq_covars.shape
    d = 1 + k + nm
    goff = 1 + k
    # cell design: row (g, c) = [1, uniq[g], g_1(c)..g_m(c)]; cell order
    # [g0c0, g0c1, g0c2, g1c0, ...]
    gvals = np.array([[0.0, a1, a2] for (a1, a2) in gluts])  # (m, 3)
    x3 = np.empty((ng * 3, d))
    for g in range(ng):
        for c in range(3):
            x3[g * 3 + c, 0] = 1.0
            x3[g * 3 + c, 1 : 1 + k] = uniq_covars[g]
            x3[g * 3 + c, goff:] = gvals[:, c]
    if group_inv is None:
        group_inv = np.zeros(len(np.asarray(y)), dtype=np.intp)
    nc, yc = _cell_tables(packed, num_samples, y, sample_idx, group_inv, ng)
    n = nc.sum(axis=1)
    ncase = yc.sum(axis=1)
    # estimability gates == _geno_gates on the cell representation
    # (gcell = each genotype column's value per cell, tiled over groups)
    # (m, 3G) cell order [g0c0, g0c1, g0c2, g1c0, ...]
    gcell = np.array([np.tile(gvals[t], ng) for t in range(nm)])
    ok = (n >= d + 1) & (ncase > 0) & (ncase < n)
    nz = np.maximum(n, 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        for t in range(nm):
            s1 = (nc * gcell[t]).sum(axis=1)
            s2 = (nc * gcell[t] ** 2).sum(axis=1)
            ok &= (s2 - s1 * s1 / nz) > 1e-9 * nz
        if nm == 2:
            s10 = (nc * gcell[0]).sum(axis=1)
            s20 = (nc * gcell[0] ** 2).sum(axis=1)
            s11 = (nc * gcell[1]).sum(axis=1)
            s21 = (nc * gcell[1] ** 2).sum(axis=1)
            s01 = (nc * gcell[0] * gcell[1]).sum(axis=1)
            c00 = s20 - s10**2 / nz
            c11 = s21 - s11**2 / nz
            c01 = s01 - s10 * s11 / nz
            ok &= (c00 * c11 - c01 * c01) > 1e-9 * nz

    tests = list(range(goff, goff + nm))

    beta = np.full((nvar, nm), np.nan)
    se = np.full((nvar, nm), np.nan)
    joint = np.full(nvar, np.nan)
    niter = np.zeros(nvar, dtype=np.int32)
    conv = np.zeros(nvar, dtype=bool)
    fused = np.zeros(nvar, dtype=bool)
    idx = np.flatnonzero(ok)
    if idx.size:
        (beta[idx], se[idx], joint[idx], niter[idx], conv[idx],
         fused[idx]) = _cells_triage(
            nc, yc, n, ncase, x3, tests, idx, firth, max_iter, tol,
            joint_k=(k if nm == 2 else None),
        )
    good = conv & np.isfinite(se).all(axis=1)
    beta = np.where(good[:, None], beta, np.nan)
    se = np.where(good[:, None], se, np.nan)
    joint = np.where(good, joint, np.nan)
    with np.errstate(invalid="ignore"):
        z = beta / se
    p = normal_sf2(z)
    if nm == 2:
        with np.errstate(invalid="ignore", over="ignore"):
            joint_p = np.where(
                np.isfinite(joint), np.exp(-0.5 * joint), np.nan
            )
    else:
        joint = joint_p = None
    return (
        n.astype(np.int64), beta, se, z, p, joint, joint_p, niter,
        fused & good,
    )


def _logistic_fit_multi(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    covars: np.ndarray,
    block_variants: int,
    sample_idx,
    max_iter: int,
    tol: float,
    matmul,
    firth: str,
    gluts,
):
    """Shared blocked IRLS driver; (V, m)-shaped per-test outputs."""
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    if firth not in ("fallback", "always", "none"):
        raise ValueError(f"logistic: unknown firth mode {firth!r}")
    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if y.shape != (ns,) or covars.shape[0] != ns:
        raise ValueError(
            f"glm: y {y.shape} / covars {covars.shape} do not match "
            f"{ns} samples"
        )
    if not np.isin(y, (0.0, 1.0)).all():
        raise ValueError("logistic: y must be 0/1")
    if matmul is None and (
        sample_idx is None
        or len(np.unique(np.asarray(sample_idx))) == len(sample_idx)
    ):
        # sufficient-statistics fast path: the likelihood depends only
        # on per-(genotype class x covariate group) cell tables when the
        # covariates take few distinct row values — always with k = 0,
        # and e.g. SEX/batch designs. 2G count passes + class-sum Newton
        # beat per-sample IRLS while 3G stays small. (A duplicated
        # sample_idx needs the column-gather semantics of the per-sample
        # path below.)
        if covars.shape[1] == 0:
            return _logistic_fit_counts(
                packed, num_samples, y, sample_idx, max_iter, tol, firth,
                gluts,
            )
        if covars.shape[0] and covars.shape[1] <= 4 and all(
            # cheap per-column screen first: continuous covariates (PCs)
            # can never qualify, and the full row-unique below lexsorts
            len(np.unique(covars[:, j])) <= 16
            for j in range(covars.shape[1])
        ):
            uniq, inv = np.unique(covars, axis=0, return_inverse=True)
            if len(uniq) <= 16:
                return _logistic_fit_counts(
                    packed, num_samples, y, sample_idx, max_iter, tol,
                    firth, gluts, group_inv=inv, uniq_covars=uniq,
                )
    nm = len(gluts)
    cc = _cov_pairs(covars)
    n = np.empty(nvar)
    beta = np.empty((nvar, nm))
    se = np.empty((nvar, nm))
    joint = np.full(nvar, np.nan)
    niter = np.empty(nvar, dtype=np.int32)
    conv = np.empty(nvar, dtype=bool)
    fused = np.zeros(nvar, dtype=bool)
    bv = min(block_variants, max(nvar, 1))
    # Firth needs far more steps than vanilla Newton: the update uses the
    # UNPENALIZED Hessian, so near separation it converges linearly
    # (measured rate ~0.7/step) rather than quadratically — ~100+ steps to
    # tol=1e-7. Cheap in practice: converged sites retire from the active
    # set, so the tail iterations run on a shrinking handful of variants.
    firth_iter = max(max_iter, 256)
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        sl = slice(lo, lo + codes.shape[0])
        nb, bb, sb, ib, cb, ok, jb = _irls_block(
            codes, y, covars, cc,
            0 if firth == "always" else max_iter, tol, matmul, gluts,
        )
        if firth != "none":
            retry = np.flatnonzero(ok & ~cb)
            if retry.size:
                _, fb, fs, fi, fc, fj = _firth_block(
                    codes, y, covars, cc, retry, firth_iter, tol, matmul,
                    gluts,
                )
                bb[retry], sb[retry], ib[retry], cb[retry] = fb, fs, fi, fc
                jb[retry] = fj
                fused[lo + retry] = fc
        n[sl], beta[sl], se[sl] = nb, bb, sb
        niter[sl], conv[sl], joint[sl] = ib, cb, jb
    good = conv & np.isfinite(se).all(axis=1)
    beta = np.where(good[:, None], beta, np.nan)
    se = np.where(good[:, None], se, np.nan)
    joint = np.where(good, joint, np.nan)
    with np.errstate(invalid="ignore"):
        z = beta / se
    p = normal_sf2(z)
    if nm == 2:
        # chi2_2 survival is exactly exp(-x/2)
        with np.errstate(invalid="ignore", over="ignore"):
            joint_p = np.where(
                np.isfinite(joint), np.exp(-0.5 * joint), np.nan
            )
    else:
        joint = joint_p = None
    return (
        n.astype(np.int64), beta, se, z, p, joint, joint_p, niter,
        fused & good,
    )


def glm_logistic_numpy(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    covars: np.ndarray,
    block_variants: int = 256,
    sample_idx=None,
    max_iter: int = 24,
    tol: float = 1e-7,
    matmul=None,
    firth: str = "fallback",
) -> LogisticResult:
    """Host provider, additive model. y must be 0/1; covars (S, k).

    Block default 256: each IRLS iteration makes 4-5 elementwise passes
    over (bv, S) f64 arrays; at 2504 samples a 256-row block (~5 MB)
    stays cache-resident, measured 11x faster than the old 1<<12
    default (0.28k vs 3.1k variants/s, r5).

    firth: "fallback" (default, plink2's `--glm firth-fallback`) re-fits
    non-converged sites with Firth regression; "always" (`--glm firth`)
    fits every estimable site with Firth; "none" (`--glm no-firth`)
    reports non-converged sites as NA.
    """
    n, beta, se, z, p, _, _, niter, fused = _logistic_fit_multi(
        packed, num_samples, y, covars, block_variants, sample_idx,
        max_iter, tol, matmul, firth, _ADD_GLUT,
    )
    return LogisticResult(
        n, beta[:, 0], se[:, 0], z[:, 0], p[:, 0], niter, fused
    )


class LogisticIntResult(NamedTuple):
    """Interaction-design logistic fit; test columns = [g, g*c_1..g*c_k]."""

    n_obs: np.ndarray   # (V,) i64 complete-case count
    beta: np.ndarray    # (V, 1+k) f64 log-odds, NaN on failure
    se: np.ndarray      # (V, 1+k) f64
    z_stat: np.ndarray  # (V, 1+k) f64
    p: np.ndarray       # (V, 1+k) f64
    n_iter: np.ndarray  # (V,) i32
    firth: np.ndarray = None  # (V,) bool: site fit by Firth regression


def _assemble_hess_int(
    h1, hc, hcc, hg, hgc, hgcc, hgg, hg2c, hg2cc, k: int
) -> np.ndarray:
    """Symmetric (V, d, d) interaction-design Hessian; d = 2k + 2,
    column layout [1, c_1..c_k, g, g*c_1..g*c_k].

    Moment inputs (w = working weights, g = dosage, per variant row):
      h1    = sum w            hc   = w @ C         hcc   = w @ CC
      hg    = sum w*g          hgc  = (w*g) @ C     hgcc  = (w*g) @ CC
      hgg   = sum w*g^2        hg2c = (w*g^2) @ C   hg2cc = (w*g^2) @ CC
    where CC holds the k(k+1)/2 upper-triangle covariate products. Every
    Hessian entry is one of these: e.g. H[c_i, g*c_j] = sum w g c_i c_j
    rides hgcc (symmetric in i,j)."""
    v = h1.shape[0]
    d = 2 * k + 2
    gi = k + 1
    h = np.zeros((v, d, d), dtype=np.float64)
    h[:, 0, 0] = h1
    h[:, 0, 1 : 1 + k] = hc
    h[:, 1 : 1 + k, 0] = hc
    h[:, 0, gi] = hg
    h[:, gi, 0] = hg
    h[:, 1 : 1 + k, gi] = hgc
    h[:, gi, 1 : 1 + k] = hgc
    h[:, gi, gi] = hgg
    h[:, 0, gi + 1 :] = hgc  # (1, g*c_i) = (g, c_i)
    h[:, gi + 1 :, 0] = hgc
    h[:, gi, gi + 1 :] = hg2c
    h[:, gi + 1 :, gi] = hg2c
    pos = 0
    for i in range(k):
        for j in range(i, k):
            h[:, 1 + i, 1 + j] = hcc[:, pos]
            h[:, 1 + j, 1 + i] = hcc[:, pos]
            # (c_i, g*c_j) and (c_j, g*c_i): both sum w g c_i c_j
            h[:, 1 + i, gi + 1 + j] = hgcc[:, pos]
            h[:, gi + 1 + j, 1 + i] = hgcc[:, pos]
            h[:, 1 + j, gi + 1 + i] = hgcc[:, pos]
            h[:, gi + 1 + i, 1 + j] = hgcc[:, pos]
            h[:, gi + 1 + i, gi + 1 + j] = hg2cc[:, pos]
            h[:, gi + 1 + j, gi + 1 + i] = hg2cc[:, pos]
            pos += 1
    return h


def _irls_int_block(
    codes: np.ndarray,   # (Vb, S) u8, 3 = missing
    y: np.ndarray,       # (S,) f64 in {0, 1}
    covars: np.ndarray,  # (S, k), k >= 1
    cc: np.ndarray,      # (S, k(k+1)/2)
    max_iter: int,
    tol: float,
    matmul=None,
):
    """Newton/IRLS over the interaction design [1, C, g, g*C] for one
    variant block. Returns (n, beta_tests, se_tests, niter, converged)
    with test columns [g, g*c_1..g*c_k]. Three (Va,S)x(S,k+kk) moment
    GEMMs per iteration (w, w*g, w*g^2 against [C | CC]) — the same
    masked-moment shape as the base model, so the device provider's MXU
    closure applies unchanged."""
    vb, ns = codes.shape
    k = covars.shape[1]
    d = 2 * k + 2
    gi = k + 1
    mm = matmul if matmul is not None else lambda a, b: a @ b
    cal = codes != 3
    m = cal.astype(np.float64)
    g = codes.astype(np.float64) * cal
    n = m.sum(axis=1)
    ncase = m @ y
    with np.errstate(invalid="ignore", divide="ignore"):
        gvar = (g * g).sum(axis=1) - np.where(
            n > 0, g.sum(axis=1) ** 2 / np.maximum(n, 1), 0.0
        )
    ok = (
        (n >= d + 1)
        & (gvar > 1e-9 * np.maximum(n, 1))
        & (ncase > 0)
        & (ncase < n)
    )
    beta = np.zeros((vb, d), dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        p0 = np.clip(ncase / np.maximum(n, 1), 1e-12, 1 - 1e-12)
    beta[:, 0] = np.where(ok, np.log(p0 / (1.0 - p0)), 0.0)
    se = np.full((vb, 1 + k), np.nan)
    niter = np.zeros(vb, dtype=np.int32)
    converged = np.zeros(vb, dtype=bool)
    active = np.flatnonzero(ok)
    q = np.concatenate([covars, cc], axis=1)  # (S, k + kk)
    kk = cc.shape[1]
    tests = [gi] + list(range(gi + 1, d))
    for it in range(1, max_iter + 1):
        if active.size == 0:
            break
        ba = beta[active]
        ma, ga = m[active], g[active]
        eta = (
            ba[:, [0]]
            + ba[:, 1 : 1 + k] @ covars.T
            + ga * (ba[:, [gi]] + ba[:, gi + 1 :] @ covars.T)
        )
        np.clip(eta, -30.0, 30.0, out=eta)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu) * ma
        r = (y[None, :] - mu) * ma
        wg = w * ga
        wg2 = wg * ga
        rg = r * ga
        wq = mm(w, q)      # [w@C   | w@CC]
        wgq = mm(wg, q)    # [wg@C  | wg@CC]
        wg2q = mm(wg2, q)  # [wg2@C | wg2@CC]
        rc = mm(r, covars)
        rgc = mm(rg, covars)
        grad = np.concatenate(
            [
                r.sum(axis=1)[:, None],
                rc,
                rg.sum(axis=1)[:, None],
                rgc,
            ],
            axis=1,
        )
        hess = _assemble_hess_int(
            w.sum(axis=1), wq[:, :k], wq[:, k : k + kk],
            wg.sum(axis=1), wgq[:, :k], wgq[:, k : k + kk],
            wg2.sum(axis=1), wg2q[:, :k], wg2q[:, k : k + kk], k,
        )
        try:
            delta = np.linalg.solve(hess, grad[:, :, None])[:, :, 0]
        except np.linalg.LinAlgError:
            delta = np.full_like(grad, np.nan)
            for i in range(active.size):
                try:
                    delta[i] = np.linalg.solve(hess[i], grad[i])
                except np.linalg.LinAlgError:
                    pass
        scale = np.max(np.abs(delta), axis=1)
        big = scale > 10.0
        delta[big] *= (10.0 / scale[big])[:, None]
        bad = ~np.isfinite(delta).all(axis=1)
        beta[active] += np.where(bad[:, None], 0.0, delta)
        niter[active] = it
        done = (np.abs(delta).max(axis=1) < tol) & ~bad
        if done.any() or bad.any():
            fin = active[done]
            converged[fin] = True
            if fin.size:
                hf = hess[done]
                eg = np.zeros((fin.size, d, 1 + k))
                for c, t in enumerate(tests):
                    eg[:, t, c] = 1.0
                try:
                    z = np.linalg.solve(hf, eg)
                    diag = np.stack([z[:, t, c] for c, t in enumerate(tests)], axis=1)
                except np.linalg.LinAlgError:
                    diag = np.full((fin.size, 1 + k), np.nan)
                    for i in range(fin.size):
                        try:
                            zi = np.linalg.solve(hf[i], eg[i])
                            diag[i] = [zi[t, c] for c, t in enumerate(tests)]
                        except np.linalg.LinAlgError:
                            pass
                se[fin] = np.sqrt(np.where(diag > 0, diag, np.nan))
            keep = ~(done | bad)
            active = active[keep]
    return n, beta[:, tests], se, niter, converged, ok


def _cell_tables(packed, num_samples, y, sample_idx, group_inv, ng):
    """(V, 3G) totals/cases tables via 2G native genotype-count passes
    (cell order [g0c0, g0c1, g0c2, g1c0, ...])."""
    from pgen_tpu_torch.ops.gt_stats_host import gt_counts, gt_counts_subset

    nvar = packed.shape[0]
    if sample_idx is None:
        cohort = np.arange(num_samples)
    else:
        cohort = np.asarray(sample_idx)
    yv = np.asarray(y)
    nc = np.empty((nvar, ng * 3))
    yc = np.empty((nvar, ng * 3))
    for g in range(ng):
        sel = group_inv == g
        rows_g = cohort[sel].astype(np.int32)
        case_g = cohort[sel & (yv == 1.0)].astype(np.int32)
        if sample_idx is None and ng == 1:
            c_all = gt_counts(packed, num_samples)
        else:
            c_all = (
                gt_counts_subset(packed, rows_g)
                if len(rows_g)
                else np.zeros((nvar, 4), dtype=np.int64)
            )
        c_case = (
            gt_counts_subset(packed, case_g)
            if len(case_g)
            else np.zeros((nvar, 4), dtype=np.int64)
        )
        nc[:, g * 3 : g * 3 + 3] = c_all[:, :3]
        yc[:, g * 3 : g * 3 + 3] = c_case[:, :3]
    return nc, yc


def _logistic_int_counts(
    packed, num_samples, y, sample_idx, max_iter, tol, uniq, inv,
    firth="none",
) -> "LogisticIntResult":
    """Cell fast path for the interaction design (see the dispatch
    site): Newton/Firth on (V, 3G) cell sums via the shared
    _cells_newton core, mirroring _irls_int_block/_firth_int_block."""
    packed = np.asarray(packed, dtype=np.uint8)
    ng, k = uniq.shape
    d = 2 * k + 2
    gi = k + 1
    tests = [gi] + list(range(gi + 1, d))
    # cell design rows [1, C_g, g_c, g_c*C_g]
    x3 = np.empty((ng * 3, d))
    for g in range(ng):
        for c in range(3):
            row = x3[g * 3 + c]
            row[0] = 1.0
            row[1 : 1 + k] = uniq[g]
            row[gi] = float(c)
            row[gi + 1 :] = float(c) * uniq[g]
    nc, yc = _cell_tables(packed, num_samples, y, sample_idx, inv, ng)
    n = nc.sum(axis=1)
    ncase = yc.sum(axis=1)
    gcell = np.tile(np.array([0.0, 1.0, 2.0]), ng)
    nz = np.maximum(n, 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        s1 = (nc * gcell).sum(axis=1)
        s2 = (nc * gcell**2).sum(axis=1)
        gvar = s2 - s1 * s1 / nz
    ok = (n >= d + 1) & (gvar > 1e-9 * nz) & (ncase > 0) & (ncase < n)
    nvar = packed.shape[0]
    beta_t = np.full((nvar, 1 + k), np.nan)
    se = np.full((nvar, 1 + k), np.nan)
    niter = np.zeros(nvar, dtype=np.int32)
    conv = np.zeros(nvar, dtype=bool)
    fused = np.zeros(nvar, dtype=bool)
    idx = np.flatnonzero(ok)
    if idx.size:
        (beta_t[idx], se[idx], _, niter[idx], conv[idx],
         fused[idx]) = _cells_triage(
            nc, yc, n, ncase, x3, tests, idx, firth, max_iter, tol,
        )
    good = conv[:, None] & np.isfinite(se)
    beta_t = np.where(good, beta_t, np.nan)
    se = np.where(good, se, np.nan)
    with np.errstate(invalid="ignore"):
        z = beta_t / se
    return LogisticIntResult(
        n.astype(np.int64), beta_t, se, z, normal_sf2(z), niter,
        fused & good.all(axis=1),
    )


def _firth_int_block(
    codes: np.ndarray,   # (Vb, S) u8, 3 = missing
    y: np.ndarray,
    covars: np.ndarray,
    cc: np.ndarray,
    idx: np.ndarray,     # block-local variant indices to (re)fit
    max_iter: int,
    tol: float,
    matmul=None,
):
    """Firth-penalized Newton over the interaction design for the
    selected variants. With A = (X'WX)^-1 and x_s = u_s + g_s v_s
    (u = [1, C_s, 0..0], v = [0..0, 1, C_s]), the hat quadratic splits
        x'Ax = u'Au + 2 g u'Av + g^2 v'Av
    — three covariate quadratics over the matching A blocks, each
    expressed through the shared cc pair columns; the cross block is
    NON-symmetric, so its pair weights are M_ij + M_ji. SE from the
    penalized A's test-column diagonals (logistf/plink2 convention)."""
    mm = matmul if matmul is not None else lambda a, b: a @ b
    k = covars.shape[1]
    kk = cc.shape[1]
    d = 2 * k + 2
    gi = k + 1
    tests = [gi] + list(range(gi + 1, d))
    cal = codes[idx] != 3
    m = cal.astype(np.float64)
    g = codes[idx].astype(np.float64) * cal
    n = m.sum(axis=1)
    ncase = m @ y
    q = np.concatenate([covars, cc], axis=1)
    nb = len(idx)
    beta = np.zeros((nb, d), dtype=np.float64)
    p0 = np.clip((ncase + 0.5) / (n + 1.0), 1e-12, 1 - 1e-12)
    beta[:, 0] = np.log(p0 / (1.0 - p0))
    se = np.full((nb, 1 + k), np.nan)
    niter = np.zeros(nb, dtype=np.int32)
    converged = np.zeros(nb, dtype=bool)
    active = np.arange(nb)
    ii = np.array([i for i in range(k) for j in range(i, k)], dtype=np.intp)
    jj = np.array([j for i in range(k) for j in range(i, k)], dtype=np.intp)
    pw = np.where(ii == jj, 1.0, 2.0)
    for it in range(1, max_iter + 1):
        if active.size == 0:
            break
        ba = beta[active]
        ma, ga = m[active], g[active]
        eta = (
            ba[:, [0]]
            + ba[:, 1 : 1 + k] @ covars.T
            + ga * (ba[:, [gi]] + ba[:, gi + 1 :] @ covars.T)
        )
        np.clip(eta, -30.0, 30.0, out=eta)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu) * ma
        wg = w * ga
        wg2 = wg * ga
        wq = mm(w, q)
        wgq = mm(wg, q)
        wg2q = mm(wg2, q)
        hess = _assemble_hess_int(
            w.sum(axis=1), wq[:, :k], wq[:, k : k + kk],
            wg.sum(axis=1), wgq[:, :k], wgq[:, k : k + kk],
            wg2.sum(axis=1), wg2q[:, :k], wg2q[:, k : k + kk], k,
        )
        ainv, inv_ok = _batched_inv(hess)
        na = len(active)
        zero_p = np.zeros((na, 0))
        a00 = ainv[:, 0, 0]
        a0c = ainv[:, 0, 1 : 1 + k]
        accp = (ainv[:, 1 + ii, 1 + jj] * pw) if kk else zero_p
        a0g = ainv[:, 0, gi]
        a0i = ainv[:, 0, gi + 1 :]
        acg = ainv[:, 1 : 1 + k, gi]
        cross = ainv[:, 1 : 1 + k, gi + 1 :]
        crossp = (
            cross[:, ii, jj] + np.where(ii != jj, cross[:, jj, ii], 0.0)
        ) if kk else zero_p
        agg = ainv[:, gi, gi]
        agi = ainv[:, gi, gi + 1 :]
        iblk = ainv[:, gi + 1 :, gi + 1 :]
        ipairs = (iblk[:, ii, jj] * pw) if kk else zero_p
        with np.errstate(invalid="ignore"):
            uau = a00[:, None] + 2.0 * (a0c @ covars.T) + (accp @ cc.T)
            vav = agg[:, None] + 2.0 * (agi @ covars.T) + (ipairs @ cc.T)
            uav = (
                a0g[:, None] + a0i @ covars.T + acg @ covars.T
                + crossp @ cc.T
            )
            xax = uau + ga * (2.0 * uav) + ga * ga * vav
            h = w * xax
            r = (y[None, :] - mu + h * (0.5 - mu)) * ma
        rg = r * ga
        rc = mm(r, covars)
        rgc = mm(rg, covars)
        grad = np.concatenate(
            [r.sum(axis=1)[:, None], rc, rg.sum(axis=1)[:, None], rgc],
            axis=1,
        )
        with np.errstate(invalid="ignore"):
            delta = np.einsum("vij,vj->vi", ainv, grad)
        scale = np.max(np.abs(delta), axis=1)
        big = scale > 5.0
        delta[big] *= (5.0 / scale[big])[:, None]
        bad = ~np.isfinite(delta).all(axis=1) | ~inv_ok
        beta[active] += np.where(bad[:, None], 0.0, delta)
        niter[active] = it
        done = (np.abs(delta).max(axis=1) < tol) & ~bad
        if done.any() or bad.any():
            fin = active[done]
            converged[fin] = True
            if fin.size:
                diag = np.stack(
                    [ainv[done][:, t, t] for t in tests], axis=1
                )
                se[fin] = np.sqrt(np.where(diag > 0, diag, np.nan))
            active = active[~(done | bad)]
    return n, beta[:, tests], se, niter, converged


def glm_logistic_interaction(
    packed,
    num_samples: int,
    y,
    covars,
    provider: str = "numpy",
    block_variants: int = 1 << 12,
    sample_idx=None,
    max_iter: int = 48,
    tol: float = 1e-7,
    matmul=None,
    firth: str = "fallback",
) -> LogisticIntResult:
    """plink2 `--glm interaction` for the logistic model: per variant,
    case status on [1, C, g, g*C]; one (beta, SE, Wald Z, p) row per
    dosage term [ADD, ADDxC_1..]. firth follows the base model
    (plink2's firth-fallback default): non-converged (separated) sites
    re-fit with the Jeffreys penalty via _firth_int_block, whose hat
    quadratic splits over the interaction design's A blocks."""
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    if firth not in ("fallback", "always", "none"):
        raise ValueError(f"logistic: unknown firth mode {firth!r}")
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if covars.ndim != 2 or covars.shape[1] == 0:
        raise ValueError(
            "glm --interaction needs at least one covariate (the "
            "interaction terms are dosage x covariate)"
        )
    if not np.isin(y, (0.0, 1.0)).all():
        raise ValueError("logistic: y must be 0/1")
    if matmul is None and covars.shape[0] and covars.shape[1] <= 4 and (
        sample_idx is None
        or len(np.unique(np.asarray(sample_idx))) == len(sample_idx)
    ) and all(
        len(np.unique(covars[:, j])) <= 16 for j in range(covars.shape[1])
    ):
        # interaction cells: [1, C_g, g_c, g_c*C_g] is fully determined
        # by (genotype class, covariate group), so few-unique-covariate
        # designs collapse to the same 3G-cell sufficient statistics as
        # the base model (see _logistic_fit_counts)
        uniq, inv = np.unique(covars, axis=0, return_inverse=True)
        if len(uniq) <= 16:
            return _logistic_int_counts(
                packed, num_samples, y, sample_idx, max_iter, tol, uniq,
                inv, firth=firth,
            )
    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    k = covars.shape[1]
    cc = _cov_pairs(covars)
    n = np.empty(nvar)
    beta = np.empty((nvar, 1 + k))
    se = np.empty((nvar, 1 + k))
    niter = np.empty(nvar, dtype=np.int32)
    conv = np.empty(nvar, dtype=bool)
    fused = np.zeros(nvar, dtype=bool)
    bv = min(block_variants, max(nvar, 1))
    firth_iter = max(max_iter, 256)  # see glm_logistic_numpy's rationale
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        sl = slice(lo, lo + codes.shape[0])
        nb, bb, sb, ib, cb, okb = _irls_int_block(
            codes, y, covars, cc,
            0 if firth == "always" else max_iter, tol, matmul,
        )
        if firth != "none":
            retry = np.flatnonzero(okb & ~cb)
            if retry.size:
                _, fb, fs, fi, fc = _firth_int_block(
                    codes, y, covars, cc, retry, firth_iter, tol, matmul
                )
                bb[retry], sb[retry], ib[retry], cb[retry] = fb, fs, fi, fc
                fused[lo + retry] = fc
        n[sl], beta[sl], se[sl], niter[sl], conv[sl] = nb, bb, sb, ib, cb
    good = conv[:, None] & np.isfinite(se)
    beta = np.where(good, beta, np.nan)
    se = np.where(good, se, np.nan)
    with np.errstate(invalid="ignore"):
        z = beta / se
    return LogisticIntResult(
        n.astype(np.int64), beta, se, z, normal_sf2(z), niter,
        fused & good.all(axis=1),
    )
