"""Plain reference of an exact PCA of the genomic relationship matrix.

Each variant's calls are standardized over the called samples,
z = (g - 2p) / sqrt(2p(1 - p)) with g the alt-allele count (0, 1, 2) and p
the alt frequency among the called, 0 on a missing call; a monomorphic
variant (p(1 - p) = 0) is left out. GRM = Z^T Z / m with m the variants
kept. Z and its product are float64 on the device, in blocks of rows; the
top k eigenpairs of the GRM by ``torch.linalg.eigh`` in float64.

The control does all of it in float32 (TF32 off), the product summed in
float32 over the blocks.

The program's eigenpairs are judged against the reference GRM G and its
eigenvalues lambda:

- ``eigval_rel_err``: max_k |l_k - lambda_k| / lambda_k;
- ``eigvec_residual``: max_k ||G u_k - lambda_k u_k|| / lambda_1 +
  | ||u_k|| - 1 |, which does not depend on the sign of u_k or on how a
  near-degenerate pair of eigenvectors is rotated.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fileset import codes

BLOCK_ROWS = 1 << 14


def grm(records: np.ndarray, num_samples: int, device, dtype=torch.float64) -> torch.Tensor:
    """(S, S) GRM on ``device`` in ``dtype``."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.zeros((num_samples, num_samples), dtype=dtype, device=device)
        used = 0
        for lo in range(0, records.shape[0], BLOCK_ROWS):
            c = codes(torch.from_numpy(np.array(records[lo : lo + BLOCK_ROWS])).to(device),
                      num_samples)
            called = c != 3
            g = torch.where(called, c, 0).to(dtype)
            n = called.sum(1).to(dtype)
            p = torch.where(n > 0, g.sum(1) / (2 * n).clamp(min=1), 0)
            var = 2 * p * (1 - p)
            ok = var > 0
            z = torch.where(called, (g - 2 * p[:, None]) / var.clamp(min=1e-300).sqrt()[:, None],
                            0)
            z = z[ok]
            used += int(ok.sum())
            acc += z.T @ z
            del c, called, g, z
        return acc / used
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def top_eigen(g: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(k,) eigenvalues, descending, and (S, k) unit eigenvectors."""
    vals, vecs = torch.linalg.eigh(g)
    order = torch.argsort(vals, descending=True)[:k]
    return vals[order].cpu().numpy(), vecs[:, order].cpu().numpy()


def compare(vals: np.ndarray, vecs: np.ndarray, g: torch.Tensor, ref_vals: np.ndarray) -> dict:
    """{eigval_rel_err, eigvec_residual} of eigenpairs against the reference."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.shape != ref_vals.shape or vecs.shape != (g.shape[0], len(ref_vals)):
        return {"eigval_rel_err": float("inf"), "eigvec_residual": float("inf")}
    u = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float64)).to(g.device)
    lam = torch.from_numpy(ref_vals.astype(np.float64)).to(g.device)
    res = torch.linalg.vector_norm(g.double() @ u - u * lam, dim=0) / lam[0]
    norm_err = (torch.linalg.vector_norm(u, dim=0) - 1).abs()
    err = np.abs(vals - ref_vals) / np.abs(ref_vals)
    worst = lambda x: float(np.nan_to_num(np.max(x), nan=np.inf))
    return {"eigval_rel_err": worst(err), "eigvec_residual": worst((res + norm_err).cpu().numpy())}
