"""Multiple-testing-corrected p-value columns (plink2 --adjust analog).

Given the per-variant association p-values (and the Wald/t statistics
they came from), computes plink2's .adjusted column family, vectorized:

    UNADJ     the raw p
    GC        genomic-control corrected: chisq_i = qchisq(1 - p_i, 1)
              (the 1-df chi-square equivalent of the reported p) scaled
              by lambda = median(chisq)/qchisq(0.5, 1) (clamped >= 1),
              then p = chi2_1 survival = erfc(sqrt(chisq'/2)). Deriving
              chisq from the p-value rather than squaring the statistic
              keeps the linear model's Student-t exact at small N
              (E[t^2] = df/(df-2) > 1 would inflate lambda); for the
              logistic z the two are identical. Underflowed p (== 0.0)
              falls back to stat^2.
    BONF      min(1, m p)
    HOLM      Holm step-down: cummax_i min(1, (m - i) p_(i))
    SIDAK_SS  1 - (1 - p)^m (single-step)
    SIDAK_SD  step-down: cummax_i (1 - (1 - p_(i))^(m - i))
    FDR_BH    Benjamini-Hochberg step-up: rev-cummin_i min(1, m/(i+1) p_(i))
    FDR_BY    Benjamini-Yekutieli: BH with the harmonic factor c(m)

m counts the TESTED (finite-p) variants only, matching plink2 (NA rows
are excluded from the report). Reference: plink2 --adjust documentation;
the reference CLI has no analog (query/filter tool only).

Copied from ``pgen_tpu/ops/adjust.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# median of the 1-df chi-square distribution, qchisq(0.5, 1)
_CHI2_1_MEDIAN = 0.45493642311957184


class AdjustResult(NamedTuple):
    order: np.ndarray      # (M,) indices into the input arrays, UNADJ asc
    unadj: np.ndarray      # (M,) each sorted ascending along `order`
    gc: np.ndarray
    bonf: np.ndarray
    holm: np.ndarray
    sidak_ss: np.ndarray
    sidak_sd: np.ndarray
    fdr_bh: np.ndarray
    fdr_by: np.ndarray
    lambda_gc: float


def _chi2_1_sf(x: np.ndarray) -> np.ndarray:
    """chi2(1 df) survival = two-sided normal tail of sqrt(x):
    erfc(sqrt(x/2)); reuses ops/logistic's vectorized erfc."""
    from pgen_tpu_torch.ops.logistic_host import normal_sf2

    return normal_sf2(np.sqrt(np.maximum(x, 0.0)))


# Acklam's rational approximation of the standard normal quantile
# (lower tail), |rel err| < 1.15e-9, refined below by one Halley step
# against the exact erfc to full double precision.
_PPF_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_PPF_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_PPF_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_PPF_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    """Vectorized standard-normal quantile Phi^{-1}(q), q in (0, 1)."""
    q = np.asarray(q, dtype=np.float64)
    x = np.full(q.shape, np.nan)
    a, b, c, d = _PPF_A, _PPF_B, _PPF_C, _PPF_D
    lo = (q > 0.0) & (q < 0.02425)
    hi = (q > 1.0 - 0.02425) & (q < 1.0)
    mid = (q >= 0.02425) & (q <= 1.0 - 0.02425)
    if mid.any():
        r = q[mid] - 0.5
        s = r * r
        num = ((((a[0]*s + a[1])*s + a[2])*s + a[3])*s + a[4])*s + a[5]
        den = ((((b[0]*s + b[1])*s + b[2])*s + b[3])*s + b[4])*s + 1.0
        x[mid] = r * num / den
    for sel, sign in ((lo, 1.0), (hi, -1.0)):
        if sel.any():
            qt = q[sel] if sign > 0 else 1.0 - q[sel]
            r = np.sqrt(-2.0 * np.log(qt))
            num = ((((c[0]*r + c[1])*r + c[2])*r + c[3])*r + c[4])*r + c[5]
            den = (((d[0]*r + d[1])*r + d[2])*r + d[3])*r + 1.0
            x[sel] = sign * num / den
    # one Halley refinement with the exact erfc (skip where exp(x^2/2)
    # would overflow — the raw approximation is already sub-1e-9 there)
    from pgen_tpu_torch.ops.logistic_host import _erfc

    fin = np.isfinite(x) & (np.abs(x) < 37.0)
    if fin.any():
        xf = x[fin]
        e = 0.5 * _erfc(-xf / np.sqrt(2.0)) - q[fin]
        u = e * np.sqrt(2.0 * np.pi) * np.exp(xf * xf / 2.0)
        x[fin] = xf - u / (1.0 + xf * u / 2.0)
    return x


def adjust_pvalues(p: np.ndarray, stat: np.ndarray | None = None,
                   lambda_gc: float | None = None) -> AdjustResult:
    """p: raw p-values (NaN = untested, dropped). stat: the z/t statistic
    per variant (needed for GC; without it GC falls back to UNADJ and
    lambda reports NaN). lambda_gc overrides the estimated lambda
    (plink2 --lambda)."""
    p = np.asarray(p, dtype=np.float64)
    tested = np.flatnonzero(np.isfinite(p))
    m = len(tested)
    if m == 0:
        z = np.zeros(0)
        return AdjustResult(tested, z, z, z, z, z, z, z, z, float("nan"))
    order = tested[np.argsort(p[tested], kind="stable")]
    ps = p[order]

    if stat is not None:
        # chi-square equivalents from the p-values themselves
        # (qchisq(1-p, 1) = ndtri(p/2)^2): exact for a z statistic, and
        # maps a linear-model t through its own distribution instead of
        # treating t^2 as chi2_1 (which inflates lambda at small df —
        # r4 advisor finding). stat^2 only backstops underflowed p==0.
        chisq = _norm_ppf(np.minimum(ps, 1.0) / 2.0) ** 2
        bad = ~np.isfinite(chisq)
        if bad.any():
            chisq[bad] = np.asarray(stat, dtype=np.float64)[order][bad] ** 2
        if lambda_gc is None:
            lambda_gc = float(np.median(chisq) / _CHI2_1_MEDIAN)
        lambda_gc = max(lambda_gc, 1.0)  # plink2 clamps deflation to 1
        gc = _chi2_1_sf(chisq / lambda_gc)
    else:
        lambda_gc = float("nan")
        gc = ps.copy()

    idx = np.arange(m, dtype=np.float64)
    bonf = np.minimum(m * ps, 1.0)
    holm = np.maximum.accumulate(np.minimum((m - idx) * ps, 1.0))
    # log1p form keeps precision for tiny p (1-(1-p)^k = -expm1(k log1p(-p)))
    with np.errstate(divide="ignore"):
        l1p = np.log1p(-np.minimum(ps, 1.0 - 1e-300))
    sidak_ss = -np.expm1(m * l1p)
    sidak_sd = np.maximum.accumulate(-np.expm1((m - idx) * l1p))
    bh_terms = np.minimum(m / (idx + 1.0) * ps, 1.0)
    fdr_bh = np.minimum.accumulate(bh_terms[::-1])[::-1]
    cm = float(np.sum(1.0 / np.arange(1, m + 1)))
    fdr_by = np.minimum.accumulate(
        np.minimum(cm * m / (idx + 1.0) * ps, 1.0)[::-1]
    )[::-1]
    return AdjustResult(
        order, ps, gc, bonf, holm, sidak_ss, sidak_sd, fdr_bh, fdr_by,
        lambda_gc,
    )
