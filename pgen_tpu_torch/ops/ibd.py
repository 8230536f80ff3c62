"""Pairwise IBD sharing (PLINK --genome analog) on the GPU: the port of
``pgen_tpu/ops/ibd.py``.

The observed IBS counts are five Gram matrices of the indicator planes H,
R, A and C (``ops/relatedness.py``):

    HETHET = H^T H,  RA = R^T A,  RR = R^T R,  AA = A^T A,  NSNP = C^T C

``ibd_counts_device`` makes them per block of 32,768 rows through the same
scan as ``ops/king.py``: on a card K12's bit planes and its Gram kernel,
the five Grams in one launch a block (H^T H, R^T R, A^T A and C^T C over
their triangle), exact; on the CPU int8 planes and ``torch._int_mm``. It
refuses 2^24 rows or more in one call as pgen_tpu's device provider does
(pipeline/genome.py chunks at 2^23 and sums the chunks in f64). The method
of moments (``ibd_estimates``) runs on the host in f64.

``ibd_counts_mesh`` is pgen_tpu's mesh step (``build_ibd_mesh_step``,
:278) over the ranks of a process group, as ``ops/king.py``'s: one
all_reduce a Gram in f64.

``IbdCounts``, ``ibs_from_counts``, ``ibd_counts_reference`` and
``ibd_estimates`` are copied from pgen_tpu (``ops/ibd.py:63-112``, ``:334``),
whose module imports jax at module level; the tests pin each copy equal to
pgen_tpu's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.ops.relatedness import GRAM_SETS, relatedness_grams
from pgen_tpu_torch.parallel.mesh import all_reduce_sum

# H^T H, R^T A, R^T R, A^T A, C^T C (pgen_tpu's _block_grams, :142)
IBD_GRAMS = GRAM_SETS[1]


class IbdCounts(NamedTuple):
    """Integer pair-count Grams, each (S, S), f64 on host.

    hethet[i,j] = #{v: both het}; ra[i,j] = #{v: i homref, j homalt};
    rr / aa = both-homref / both-homalt; nsnp = both called.
    """

    hethet: np.ndarray
    ra: np.ndarray
    rr: np.ndarray
    aa: np.ndarray
    nsnp: np.ndarray


def ibs_from_counts(c: IbdCounts):
    """Derive (ibs0, ibs1, ibs2) pair-count matrices from the Grams."""
    ibs0 = c.ra + c.ra.T
    ibs2 = c.rr + c.hethet + c.aa
    ibs1 = c.nsnp - ibs0 - ibs2
    return ibs0, ibs1, ibs2


def ibd_counts_reference(codes: np.ndarray) -> IbdCounts:
    """Brute-force O(S^2 * V) oracle over a (V, S) u8 code matrix."""
    codes = np.asarray(codes, dtype=np.uint8)
    _, ns = codes.shape
    out = [np.zeros((ns, ns), dtype=np.float64) for _ in range(5)]
    hethet, ra, rr, aa, nsnp = out
    for i in range(ns):
        ci = codes[:, i]
        for j in range(ns):
            cj = codes[:, j]
            both = (ci != 3) & (cj != 3)
            hethet[i, j] = np.sum(both & (ci == 1) & (cj == 1))
            ra[i, j] = np.sum(both & (ci == 0) & (cj == 2))
            rr[i, j] = np.sum(both & (ci == 0) & (cj == 0))
            aa[i, j] = np.sum(both & (ci == 2) & (cj == 2))
            nsnp[i, j] = np.sum(both)
    return IbdCounts(*out)


def ibd_counts_device(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> IbdCounts:
    """pgen_tpu's ``ibd_counts_device`` on ``device`` (``"cuda"`` or
    ``"cpu"``, the kernels' plain versions): the five count Grams of the
    (V, R) u8 records over the samples of ``sample_idx`` (all S without
    it), exact, as f64. Refuses 2^24 rows or more, as pgen_tpu does."""
    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"ibd_counts_device: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/genome.py "
            "does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return IbdCounts(*(z.copy() for _ in range(5)))
    bv = min(block_variants, 1 << 24)
    return IbdCounts(*relatedness_grams(packed, num_samples, device, IBD_GRAMS, bv, sample_idx))


def ibd_counts_mesh(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 15,
    sample_idx=None,
    timer=None,
) -> IbdCounts:
    """pgen_tpu's ``ibd_counts_mesh`` over the ranks of the default process
    group: ``packed`` is this rank's shard of the rows (fewer than 2^24),
    and every rank gets the five Grams of every rank's rows. The all_reduce
    is ``timer``'s."""
    counts = ibd_counts_device(packed, num_samples, device, block_variants, sample_idx)
    return IbdCounts(*all_reduce_sum(counts, resolve_device(device), timer))


def ibd_estimates(counts: IbdCounts, alt_freq: np.ndarray):
    """Method-of-moments Z0/Z1/Z2/PI_HAT from the count Grams + cohort
    ALT frequencies of the kept variants (NaN freqs — zero-called
    variants — are excluded from the expectation means).

    Returns dict of (S, S) arrays: ibs0/ibs1/ibs2 (counts), dst, z0, z1,
    z2, pi_hat. Pairs with NSNP == 0, or a fileset whose kept variants
    carry no IBS information (all monomorphic -> m00 == 0), come out NaN.
    """
    ibs0, ibs1, ibs2 = ibs_from_counts(counts)
    p = np.asarray(alt_freq, dtype=np.float64)
    p = p[np.isfinite(p)]
    q = 1.0 - p
    if p.size:
        m00 = float(np.mean(2 * p**2 * q**2))
        m10 = float(np.mean(4 * p**3 * q + 4 * p * q**3))
        m20 = float(np.mean(p**4 + q**4 + 4 * p**2 * q**2))
        m11 = float(np.mean(2 * p**2 * q + 2 * p * q**2))
        m21 = float(np.mean(p**3 + q**3 + p**2 * q + p * q**2))
    else:
        m00 = m10 = m20 = m11 = m21 = 0.0

    n = counts.nsnp
    with np.errstate(divide="ignore", invalid="ignore"):
        dst = np.where(n > 0, (ibs2 + 0.5 * ibs1) / np.maximum(n, 1), np.nan)
        if m00 > 0 and m11 > 0:
            z0 = ibs0 / (n * m00)
            z1 = (ibs1 - z0 * n * m10) / (n * m11)
            z2 = (ibs2 - z0 * n * m20 - z1 * n * m21) / n
        else:
            z0 = np.full_like(dst, np.nan)
            z1 = np.full_like(dst, np.nan)
            z2 = np.full_like(dst, np.nan)
        bad = ~(n > 0)
        # plink-style bounding, simplified: clamp each Z to [0, 1] and
        # renormalize so the triple stays on the simplex
        z0 = np.clip(z0, 0.0, 1.0)
        z1 = np.clip(z1, 0.0, 1.0)
        z2 = np.clip(z2, 0.0, 1.0)
        tot = z0 + z1 + z2
        ok = tot > 0
        z0 = np.where(ok, z0 / np.where(ok, tot, 1), np.nan)
        z1 = np.where(ok, z1 / np.where(ok, tot, 1), np.nan)
        z2 = np.where(ok, z2 / np.where(ok, tot, 1), np.nan)
        for z in (z0, z1, z2):
            z[bad] = np.nan
        pi_hat = 0.5 * z1 + z2
    return {
        "ibs0": ibs0, "ibs1": ibs1, "ibs2": ibs2, "dst": dst,
        "z0": z0, "z1": z1, "z2": z2, "pi_hat": pi_hat,
    }
