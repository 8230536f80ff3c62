"""Exact Hardy-Weinberg equilibrium test, vectorized over variants.

Implements the standard exact SNP-HWE test (Wigginton, Cutler & Abecasis
2005, Am J Hum Genet 76:887-893): given observed genotype counts
(hom-ref, het, hom-alt), the p-value is the probability mass of all het
counts whose conditional probability (given allele counts and sample
size) does not exceed the observed het count's.

This backs the ``GT_HWE_P`` expression variable (an extension over the
reference, which has no genotype-valued queries at all —
pgen-rs/README.md:259-264). Design notes:

- The distribution over het counts depends only on (rare allele copies,
  called genotypes). Variants are grouped by that pair via np.unique, the
  recurrence runs once per unique pair (numpy cumprod, not a scalar
  loop), and p-values broadcast back. With full call rates the number of
  unique pairs is at most 2N+1, so chr22-scale cohorts cost ~milliseconds.
- Monomorphic sites and singletons (rare copies < 2) have a single-point
  distribution: p = 1.0, short-circuited. Real allele-frequency spectra
  are dominated by these.
- Ties use a relative tolerance of 1+1e-12, matching common SNP-HWE
  implementations' EPSILON guard against float round-off.

Copied from ``pgen_tpu/ops/hwe.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np

_TIE_TOL = 1.0 + 1e-12


def _het_prob_dist(rare: int, genotypes: int) -> np.ndarray:
    """Probabilities over het counts {parity(rare), +2, ..., rare},
    normalized. Returned array is indexed by (het - parity) // 2."""
    n2 = 2 * genotypes
    mid = rare * (n2 - rare) // n2
    if mid % 2 != rare % 2:
        mid += 1
    par = rare % 2
    # grid of admissible het counts and the mid's index on it
    hs = np.arange(par, rare + 1, 2, dtype=np.float64)
    k_mid = (mid - par) // 2
    probs = np.empty(len(hs))
    probs[k_mid] = 1.0
    # upward ratios: P(h+2)/P(h) = 4*homr(h)*homc(h) / ((h+2)*(h+1))
    if k_mid + 1 < len(hs):
        h = hs[k_mid:-1]
        homr = (rare - h) / 2.0
        homc = genotypes - h - homr
        probs[k_mid + 1 :] = np.cumprod(4.0 * homr * homc / ((h + 2.0) * (h + 1.0)))
    # downward ratios: P(h-2)/P(h) = h*(h-1) / (4*(homr(h)+1)*(homc(h)+1))
    if k_mid > 0:
        h = hs[k_mid:0:-1]
        homr = (rare - h) / 2.0
        homc = genotypes - h - homr
        probs[k_mid - 1 :: -1] = np.cumprod(
            h * (h - 1.0) / (4.0 * (homr + 1.0) * (homc + 1.0))
        )
    probs /= probs.sum()
    return probs


def hwe_exact_p(counts: np.ndarray, midp: bool = False) -> np.ndarray:
    """Exact HWE p-value per row of a (V, 4) genotype-count matrix
    (columns: hom-ref, het, hom-alt, missing; missing is ignored).

    midp=True applies the mid-p adjustment (plink2's `midp` modifier):
    subtract HALF the observed het configuration's probability —
    Lancaster's mid-p, less conservative for discrete tests. Rows that
    short-circuit (rare < 2: single-point distributions) report 0.5
    under mid-p (1 - 0.5 * 1), matching the adjustment's definition.
    Zero-genotype (all-missing) rows report 1.0 under BOTH modes — there
    is no observed configuration to halve, and GT_HWE_MIDP should agree
    with GT_HWE_P's no-data convention."""
    counts = np.asarray(counts, dtype=np.int64)
    het = counts[:, 1]
    hom1 = counts[:, 0]
    hom2 = counts[:, 2]
    genotypes = hom1 + het + hom2
    rare = 2 * np.minimum(hom1, hom2) + het

    p = np.full(len(counts), 0.5 if midp else 1.0, dtype=np.float64)
    if midp:
        p[genotypes == 0] = 1.0
    todo = np.flatnonzero((rare >= 2) & (genotypes > 0))
    if len(todo) == 0:
        return p

    keys = rare[todo] * (genotypes[todo].max() + 1) + genotypes[todo]
    uniq, inv = np.unique(keys, return_inverse=True)
    # group rows per unique pair in one stable sort (not a mask scan per
    # unique value, which would be O(U*V))
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
    for u in range(len(uniq)):
        rows = todo[order[bounds[u] : bounds[u + 1]]]
        r = int(rare[rows[0]])
        n = int(genotypes[rows[0]])
        dist = _het_prob_dist(r, n)
        obs_k = (het[rows] - (r % 2)) // 2
        # p = mass of all het counts at most as probable as the observed
        thresh = dist[obs_k] * _TIE_TOL
        pv = (dist[None, :] <= thresh[:, None]) @ dist
        if midp:
            pv = pv - 0.5 * dist[obs_k]
        p[rows] = np.minimum(pv, 1.0)
    return p
