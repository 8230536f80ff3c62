"""Plain reference of ``pca --approx``: randomized subspace iteration on the
standardized dosages, as plink2 --pca approx (FastPCA, Galinsky et al.
2016) runs it, without the S x S GRM.

z is formed as ``reference/pca.py`` forms it: each variant's calls
standardized over the called samples, z = (g - 2p) / sqrt(2p(1 - p)), 0 on
a missing call, a monomorphic variant left out; m is the variants kept and
G = Z^T Z / m. The iteration, from the same start as the program's:

    Q_0 = orth(numpy default_rng(seed).standard_normal((S, L))),
    L = min(S, k + oversample)
    Q_{t+1} = orth(G Q_t)                      x iters
    C = Q^T G Q, symmetrised; eigh(C) -> the top k (lam, W)
    V = Q W, unit columns, each column's largest |entry| made positive

Each G Q is applied in blocks of rows of Z on the card (the records held
there once), never formed; orth is ``torch.linalg.qr``. Everything is float64
with TF32 off. The control runs the same with each G Q in float32 with TF32
on, each product's operands rounded to TF32's 10 bits of mantissa here as
the card's tensor cores round them, so that the CPU shows it too (the QR
and Rayleigh-Ritz steps stay float64).

The program's eigenpairs (l, u) are judged against the reference's Ritz
values lambda and G:

- ``eigval_rel_err``: max_k |l_k - lambda_k| / lambda_k. The data carry no
  planted structure, so the top of the spectrum is a flat bulk and 10
  iterations do not converge: this holds the program to the same path,
  not to G's eigenvalues;
- ``rayleigh_err``: max_k |u_k^T G u_k - l_k| / lambda_1 + | ||u_k|| - 1 |,
  which depends neither on the sign of u_k nor on how near-equal Ritz
  vectors are rotated;
- ``eigvec_err``: max_k max_i |u_ik - s_k v_ik| / max_i |v_ik|, v_k the
  reference's vector and s_k = +-1 the sign that makes s_k v_jk positive at
  the program's largest |entry| j, where the sign rule makes u_jk positive:
  so the sign counts (a column written negated reads about 2), and the
  rule's choice of j between two near-equal entries does not.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fileset import codes

BLOCK_ENTRIES = 1 << 28  # entries of z a block of rows: 2 GB in float64
MAX_BLOCK_ROWS = 1 << 14


def on_device(records: np.ndarray, device) -> torch.Tensor:
    """The (V, R) records, copied to ``device`` once."""
    return torch.from_numpy(np.array(records)).to(device)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 bits of mantissa, to nearest, ties
    to even), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def apply_g(records: torch.Tensor, num_samples: int, q: torch.Tensor,
            dtype=torch.float64, tf32: bool = False) -> tuple[torch.Tensor, int]:
    """(Z^T (Z q) summed in ``dtype`` over blocks of rows, as float64; m).
    ``tf32`` (float32 only): TF32 on, and each product's operands rounded to
    it."""
    cut = to_tf32 if tf32 else (lambda x: x)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        rows = max(1, min(MAX_BLOCK_ROWS, BLOCK_ENTRIES // max(num_samples, 1)))
        qd = cut(q.to(dtype))
        acc = torch.zeros(q.shape, dtype=dtype, device=q.device)
        used = 0
        for lo in range(0, records.shape[0], rows):
            c = codes(records[lo : lo + rows], num_samples)
            called = c != 3
            g = torch.where(called, c, 0).to(dtype)
            n = called.sum(1).to(dtype)
            p = torch.where(n > 0, g.sum(1) / (2 * n).clamp(min=1), 0)
            var = 2 * p * (1 - p)
            ok = var > 0
            z = torch.where(called, (g - 2 * p[:, None]) / var.clamp(min=1e-300).sqrt()[:, None],
                            0)[ok]
            used += int(ok.sum())
            z = cut(z)
            acc += z.T @ cut(z @ qd)
            del c, called, g, z
        return acc.double(), used
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def subspace_pca(records: torch.Tensor, num_samples: int, k: int, iters: int, oversample: int,
                 seed: int, dtype=torch.float64, tf32: bool = False):
    """(k,) Ritz values, descending, and (S, k) unit vectors, as float64
    numpy arrays, with each G Q in ``dtype`` (``tf32``: ``apply_g``'s)."""
    dev = records.device
    L = min(num_samples, k + max(0, oversample))
    q0 = np.random.default_rng(seed).standard_normal((num_samples, L))
    q = torch.linalg.qr(torch.from_numpy(q0).to(dev))[0]
    for _ in range(max(1, iters)):
        y, m = apply_g(records, num_samples, q, dtype, tf32)
        q = torch.linalg.qr(y / m)[0]
    y, m = apply_g(records, num_samples, q, dtype, tf32)
    c = q.T @ (y / m)
    vals, w = torch.linalg.eigh((c + c.T) / 2)
    order = torch.argsort(vals, descending=True)[:k]
    vecs = q @ w[:, order]
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=0)
    lead = vecs[vecs.abs().argmax(dim=0), torch.arange(vecs.shape[1], device=dev)]
    vecs = vecs * torch.where(lead < 0, -1.0, 1.0)
    return vals[order].cpu().numpy(), vecs.cpu().numpy()


def eigvec_err(vecs: np.ndarray, ref_vecs: np.ndarray) -> float:
    """The module docstring's ``eigvec_err`` of (S, k) ``vecs`` against the
    reference's ``ref_vecs``."""
    vecs = np.asarray(vecs, dtype=np.float64)
    cols = np.arange(vecs.shape[1])
    lead = ref_vecs[np.abs(vecs).argmax(axis=0), cols]
    signed = ref_vecs * np.where(lead < 0, -1.0, 1.0)
    err = np.abs(vecs - signed).max(axis=0) / np.abs(ref_vecs).max(axis=0)
    return float(np.nan_to_num(err.max(), nan=np.inf))


def compare(answers: list, records: torch.Tensor, num_samples: int,
            ref_vals: np.ndarray, ref_vecs: np.ndarray) -> list:
    """{eigval_rel_err, rayleigh_err, eigvec_err} of each (l, u) in
    ``answers`` against the reference's Ritz pairs; G applied to every
    answer's u at once."""
    k = len(ref_vals)
    good = [np.asarray(v).shape == (k,) and np.asarray(u).shape == (num_samples, k)
            for v, u in answers]
    out = [{"eigval_rel_err": float("inf"), "rayleigh_err": float("inf"),
            "eigvec_err": float("inf")} for _ in answers]
    if not any(good):
        return out
    u = torch.from_numpy(np.concatenate(
        [np.asarray(u, dtype=np.float64) for (_, u), ok in zip(answers, good) if ok], 1))
    u = u.to(records.device)
    gu, m = apply_g(records, num_samples, u)
    quad = ((u * gu).sum(0) / m).cpu().numpy()
    norm_err = (torch.linalg.vector_norm(u, dim=0) - 1).abs().cpu().numpy()
    worst = lambda x: float(np.nan_to_num(np.max(x), nan=np.inf))
    at = 0
    for i, ((vals, vecs), ok) in enumerate(zip(answers, good)):
        if not ok:
            continue
        vals = np.asarray(vals, dtype=np.float64)
        cols = slice(at, at + k)
        at += k
        out[i] = {"eigval_rel_err": worst(np.abs(vals - ref_vals) / np.abs(ref_vals)),
                  "rayleigh_err": worst(np.abs(quad[cols] - vals) / abs(ref_vals[0])
                                        + norm_err[cols]),
                  "eigvec_err": eigvec_err(vecs, ref_vecs)}
    return out


def eigenvec_rows(iids: list, vecs: np.ndarray, rows: np.ndarray) -> list:
    """The ``.eigenvec`` lines of ``rows``: IID, then each value as Python's
    f"{x:.10g}", tab-separated."""
    return [(iids[r] + "\t" + "\t".join(f"{x:.10g}" for x in vecs[r].tolist())).encode()
            for r in rows]
