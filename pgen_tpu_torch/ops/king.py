"""Pairwise KING-robust kinship on the GPU: the port of
``pgen_tpu/ops/king.py``.

The estimator (Manichaikul et al. 2010, the between-family robust form) is
exact integer arithmetic over four Gram matrices of 0/1 indicator planes,
H (het), R (hom-ref), A (hom-alt) and C (called):

    HetHet = H^T H,  IBS0 = R^T A + (R^T A)^T,  HetCal = H^T C,  NSNP = C^T C

``king_counts_device`` makes them per block of 32,768 rows through the
shared scan of ``ops/relatedness.py``: on a card K12's transposer writes the
block's bit planes (as many bytes as the records; K5 re-packs a cohort
first) and its Gram kernel adds the four int32 Grams from them by .b1
AND-POPC, H^T H and C^T C over their triangle; on the CPU int8 planes and
``torch._int_mm``. Like pgen_tpu's device provider it refuses 2^24 rows or
more in one call (pipeline/king.py chunks at 2^23 and sums the chunks in
f64).

``king_counts_mesh`` is pgen_tpu's mesh step (``build_king_mesh_step``,
:315) over the ranks of a process group: each rank's Grams of its own rows,
summed by one all_reduce a Gram in f64 (exact: integers below 2^53, where
pgen_tpu's f32 psum is exact below 2^24 rows).

``KingCounts``, ``king_counts_reference`` and ``king_kinship`` are copied
from pgen_tpu (``ops/king.py:51-85``, ``:302``), whose module imports jax at
module level; the tests pin each copy equal to pgen_tpu's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.ops.relatedness import GRAM_SETS, relatedness_grams
from pgen_tpu_torch.parallel.mesh import all_reduce_sum

# H^T H, R^T A, H^T C, C^T C (pgen_tpu's _device_block_grams, :134)
KING_GRAMS = GRAM_SETS[0]


class KingCounts(NamedTuple):
    """Integer pair-count Grams, each (S, S), f64 on host.

    hethet[i, j] = #{v: both het};  ra[i, j] = #{v: i homref, j homalt}
    hetcal[i, j] = #{v: i het, j called};  nsnp[i, j] = #{v: both called}
    IBS0 = ra + ra.T (derived, not stored).
    """

    hethet: np.ndarray
    ra: np.ndarray
    hetcal: np.ndarray
    nsnp: np.ndarray


def king_counts_reference(codes: np.ndarray) -> KingCounts:
    """Brute-force O(S^2 * V) oracle over a (V, S) u8 code matrix."""
    codes = np.asarray(codes, dtype=np.uint8)
    _, ns = codes.shape
    hethet = np.zeros((ns, ns), dtype=np.float64)
    ra = np.zeros((ns, ns), dtype=np.float64)
    hetcal = np.zeros((ns, ns), dtype=np.float64)
    nsnp = np.zeros((ns, ns), dtype=np.float64)
    for i in range(ns):
        ci = codes[:, i]
        for j in range(ns):
            cj = codes[:, j]
            both = (ci != 3) & (cj != 3)
            hethet[i, j] = np.sum(both & (ci == 1) & (cj == 1))
            ra[i, j] = np.sum(both & (ci == 0) & (cj == 2))
            hetcal[i, j] = np.sum(both & (ci == 1))
            nsnp[i, j] = np.sum(both)
    return KingCounts(hethet, ra, hetcal, nsnp)


def king_counts_device(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> KingCounts:
    """pgen_tpu's ``king_counts_device`` on ``device`` (``"cuda"`` or
    ``"cpu"``, the kernels' plain versions): the four count Grams of the
    (V, R) u8 records over the samples of ``sample_idx`` (all S without
    it), exact, as f64. Refuses 2^24 rows or more, as pgen_tpu does."""
    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"king_counts_device: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/king.py does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return KingCounts(z, z.copy(), z.copy(), z.copy())
    bv = min(block_variants, 1 << 24)
    return KingCounts(*relatedness_grams(packed, num_samples, device, KING_GRAMS, bv, sample_idx))


def king_counts_mesh(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 15,
    sample_idx=None,
    timer=None,
) -> KingCounts:
    """pgen_tpu's ``king_counts_mesh`` over the ranks of the default process
    group: ``packed`` is this rank's shard of the rows (fewer than 2^24; zero
    rows give zero Grams), and every rank gets the Grams of every rank's
    rows (a lone process its own). The all_reduce is ``timer``'s."""
    counts = king_counts_device(packed, num_samples, device, block_variants, sample_idx)
    return KingCounts(*all_reduce_sum(counts, resolve_device(device), timer))


def king_kinship(counts: KingCounts):
    """Derive the (S, S) robust kinship matrix + IBS0 from the count Grams.

    Entries with a zero denominator (a sample het at no both-called
    variant) are NaN, matching KING's undefined-estimate convention.
    """
    ibs0 = counts.ra + counts.ra.T
    den = counts.hetcal + counts.hetcal.T
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.where(den > 0, (counts.hethet - 2.0 * ibs0) / den, np.nan)
    return kin, ibs0
