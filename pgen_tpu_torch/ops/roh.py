"""Runs of homozygosity: plink --homozyg's windowed scan, vectorized.

An extension over the reference (query/filter only,
pgen-rs/README.md:3-5). plink 1.9's ROH caller is a per-sample
sequential scan; here every per-SNP quantity is computed for ALL samples
at once with two cumulative-sum passes over (V, S) boolean matrices —
no per-sample inner loops until the (rare) segment extraction.

Algorithm (plink 1.9 --homozyg semantics, pinned here):
 1. Slide a window of `window_snp` consecutive SNPs along each
    chromosome. For sample s, the window starting at i is ACCEPTABLE if
    it holds <= `window_het` het calls and <= `window_missing` missing.
    Windowed counts come from one cumsum along the variant axis.
 2. A SNP is in the homozygous STATE if the fraction of acceptable
    windows among all windows covering it is >= `window_threshold`.
    Cover counts come from a second cumsum over the window-start axis.
 3. Candidate segments are maximal state runs, split where consecutive
    kept SNPs are > `gap` kb apart, then trimmed so both ends are
    clean homozygous calls (not het/missing).
 4. A segment is reported if it has >= `min_snp` SNPs, spans >=
    `min_kb` kb, and averages <= `density` kb per SNP.

The state matrix is exact integer arithmetic (cumsums of 0/1 in i64);
there is no floating-point beyond the final threshold compare.

Copied from ``pgen_tpu/ops/roh.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RohParams(NamedTuple):
    window_snp: int = 50
    window_het: int = 1
    window_missing: int = 5
    window_threshold: float = 0.05
    min_snp: int = 100
    min_kb: float = 1000.0
    density: float = 50.0
    gap: float = 1000.0


class RohSegment(NamedTuple):
    sample: int  # cohort-local column index
    chrom: str
    lo: int      # kept-variant row index of first SNP (inclusive)
    hi: int      # ... of last SNP (inclusive)
    pos1: int
    pos2: int
    nsnp: int
    nhet: int
    nmiss: int


def roh_state(
    het: np.ndarray, miss: np.ndarray, params: RohParams
) -> np.ndarray:
    """(L, S) bool state matrix for one chromosome's het/missing bools.

    Chromosomes shorter than one window produce an all-False state
    (plink calls nothing there)."""
    return _state_sm(
        np.ascontiguousarray(het.T), np.ascontiguousarray(miss.T), params
    ).T


def _state_sm(het_sm, miss_sm, params: RohParams) -> np.ndarray:
    """(S, L) sample-major state. All cumsums run along the CONTIGUOUS
    axis (numpy's accumulate is ~6x slower along a strided axis), and
    prefix sums are MODULAR u16: the prefix may wrap on long
    chromosomes, but a W-window difference is < 2^16, so the wraparound
    cancels exactly; u16 also halves the touched bytes (the scan is
    bound by first-touch page backing on lazy-backing hypervisors —
    ROADMAP.md Host IO — not ALU)."""
    S, L = het_sm.shape
    W = params.window_snp
    if L < W:
        return np.zeros((S, L), dtype=bool)
    if W >= 1 << 16:
        raise ValueError(f"window_snp {W} >= 2^16 (u16 window arithmetic)")
    ch = np.cumsum(het_sm, axis=1, dtype=np.uint16)
    cm = np.cumsum(miss_sm, axis=1, dtype=np.uint16)
    win_het = ch[:, W - 1 :].copy()     # (S, nwin): sum(x[i : i + W])
    win_het[:, 1:] -= ch[:, :-W]
    win_miss = cm[:, W - 1 :].copy()
    win_miss[:, 1:] -= cm[:, :-W]
    ok = (
        (win_het <= params.window_het) & (win_miss <= params.window_missing)
    )
    nwin = L - W + 1
    # hits[j] = # acceptable windows with start in [j-W+1, j] ∩ [0, nwin)
    ca = np.zeros((S, nwin + 1), dtype=np.uint16)
    np.cumsum(ok, axis=1, out=ca[:, 1:])
    j = np.arange(L)
    hi = np.minimum(j, nwin - 1)        # last covering start
    lo = np.maximum(j - W + 1, 0)       # first covering start
    hits = ca[:, hi + 1] - ca[:, lo]    # modular diff, exact (<= W)
    cover = hi - lo + 1
    # integer threshold: h >= t  <=>  h >= ceil(t) for integer h, so the
    # compare stays u16 (no (S, L) f64 temporary)
    tmin = np.ceil(params.window_threshold * cover).astype(np.uint16)
    return hits >= tmin[None, :]


def _trim(run_lo, run_hi, het_col, miss_col):
    """Shrink [lo, hi] so both ends are clean homozygous calls."""
    while run_lo <= run_hi and (het_col[run_lo] or miss_col[run_lo]):
        run_lo += 1
    while run_hi >= run_lo and (het_col[run_hi] or miss_col[run_hi]):
        run_hi -= 1
    return run_lo, run_hi


def roh_segments_chrom(
    chrom: str,
    pos: np.ndarray,
    het: np.ndarray,
    miss: np.ndarray,
    params: RohParams,
    row_offset: int = 0,
) -> list:
    """Call segments for one chromosome slice; returns RohSegment list.

    pos is the (L,) physical position vector (ascending for sane
    output, not enforced); row_offset maps local rows back to the kept
    fileset's variant rows."""
    het_sm = np.ascontiguousarray(het.T)
    miss_sm = np.ascontiguousarray(miss.T)
    state_sm = _state_sm(het_sm, miss_sm, params)
    S, L = state_sm.shape
    if L == 0:
        return []
    gap_bp = params.gap * 1000.0
    # a break BEFORE row j (j>0) if the gap to the previous SNP is too big
    brk = np.zeros(L, dtype=bool)
    if L > 1:
        brk[1:] = (pos[1:] - pos[:-1]) > gap_bp
    segs = []
    for s in range(S):
        col = state_sm[s]
        if not col.any():
            continue
        d = np.diff(col.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1  # exclusive
        if col[0]:
            starts = np.concatenate(([0], starts))
        if col[-1]:
            ends = np.concatenate((ends, [L]))
        # trimming and gap-splitting only shrink a run, so anything
        # already shorter than min_snp can never report — drop the noise
        # runs before the per-run Python work (real data at the default
        # 0.05 threshold produces thousands of tiny runs per sample)
        long_enough = (ends - starts) >= params.min_snp
        starts, ends = starts[long_enough], ends[long_enough]
        hcol = het_sm[s]
        mcol = miss_sm[s]
        for a, b in zip(starts.tolist(), ends.tolist()):
            # split the run at gap breaks
            cut = [a] + [int(x) for x in np.flatnonzero(brk[a + 1 : b]) + a + 1]
            cut.append(b)
            for lo, hi_ex in zip(cut, cut[1:]):
                lo2, hi2 = _trim(lo, hi_ex - 1, hcol, mcol)
                if hi2 < lo2:
                    continue
                nsnp = hi2 - lo2 + 1
                kb = (float(pos[hi2]) - float(pos[lo2])) / 1000.0
                if nsnp < params.min_snp or kb < params.min_kb:
                    continue
                if nsnp > 0 and kb / nsnp > params.density:
                    continue
                segs.append(RohSegment(
                    sample=s,
                    chrom=chrom,
                    lo=row_offset + lo2,
                    hi=row_offset + hi2,
                    pos1=int(pos[lo2]),
                    pos2=int(pos[hi2]),
                    nsnp=nsnp,
                    nhet=int(hcol[lo2 : hi2 + 1].sum()),
                    nmiss=int(mcol[lo2 : hi2 + 1].sum()),
                ))
    return segs
