"""Plain reference of a KING-robust kinship table (Manichaikul et al.,
Bioinformatics 26:2867, 2010, the between-family estimator).

Over the variants where both samples are called, with N_AaAa the variants
where both are het, N_AA,aa those where one is hom-ref and the other
hom-alt, and N_Aa^(i) those where sample i is het:

    kinship(i, j) = (N_AaAa - 2 N_AA,aa) / (N_Aa^(i) + N_Aa^(j))

undefined (NaN) where the denominator is 0. The counts are four Grams of
0/1 planes (H het, R hom-ref, A hom-alt, C called), each a float32 product
of a block of rows on the device with TF32 off: every partial sum is an
integer below 2^24, so exact, and the blocks add up in float64. The
``.kin0`` text is ``#IID1 IID2 NSNP HETHET IBS0 KINSHIP``, one row per pair
i < j in ``.psam`` order with kinship >= the threshold, HETHET and IBS0 as
shares of NSNP, each float ``%.6g``.

The control computes the kinship (and the shares) in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fileset import codes

BLOCK_ROWS = 1 << 15


def counts(records: np.ndarray, num_samples: int, device) -> dict:
    """{hethet, ra, hetcal, nsnp}: (S, S) float64 pair counts, ra[i, j] the
    variants with i hom-ref and j hom-alt, hetcal[i, j] those with i het and
    j called, nsnp[i, j] those with both called."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = {k: torch.zeros((num_samples, num_samples), dtype=torch.float64, device=device)
               for k in ("hethet", "ra", "hetcal", "nsnp")}
        for lo in range(0, records.shape[0], BLOCK_ROWS):
            c = codes(torch.from_numpy(np.array(records[lo : lo + BLOCK_ROWS])).to(device),
                      num_samples)
            h, r, a, called = (c == 1).float(), (c == 0).float(), (c == 2).float(), (c != 3).float()
            acc["hethet"] += (h.T @ h).double()
            acc["ra"] += (r.T @ a).double()
            acc["hetcal"] += (h.T @ called).double()
            acc["nsnp"] += (called.T @ called).double()
            del c, h, r, a, called
        return {k: v.cpu().numpy() for k, v in acc.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def kinship(cnt: dict, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """(kinship, IBS0 count) matrices, kinship computed in ``dtype``."""
    ibs0 = cnt["ra"] + cnt["ra"].T
    den = (cnt["hetcal"] + cnt["hetcal"].T).astype(dtype)
    num = (cnt["hethet"] - 2.0 * ibs0).astype(dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.where(den > 0, num / den, np.nan).astype(dtype)
    return kin, ibs0


def kin0_bytes(iids: list, cnt: dict, kin: np.ndarray, ibs0: np.ndarray,
               min_kinship: float) -> bytes:
    """The ``.kin0`` table of the pairs with kinship >= ``min_kinship``."""
    ii, jj = np.triu_indices(len(iids), k=1)
    keep = kin[ii, jj] >= min_kinship
    ii, jj = ii[keep], jj[keep]
    dtype = kin.dtype.type
    lines = [b"#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP\n"]
    for i, j in zip(ii.tolist(), jj.tolist()):
        n = cnt["nsnp"][i, j]
        het = dtype(cnt["hethet"][i, j]) / dtype(n) if n > 0 else 0.0
        i0 = dtype(ibs0[i, j]) / dtype(n) if n > 0 else 0.0
        lines.append(f"{iids[i]}\t{iids[j]}\t{int(n)}\t{het:.6g}\t{i0:.6g}\t"
                     f"{kin[i, j]:.6g}\n".encode())
    return b"".join(lines)
