"""Principal components via the GRM on the GPU: the port of
``pgen_tpu/ops/pca.py``.

Each variant's calls are standardized over the called samples of the
cohort, z = (g - 2p) / sqrt(2p(1 - p)) with p the row's alt frequency, 0 on
a missing call and on a monomorphic row (which is not counted in m_used).
Then GRM = Z^T Z / m_used, eigendecomposed in f64 on the device that summed
it (``pca_from_grm`` on a tensor: ``torch.linalg.eigh``, cuSOLVER's syevd
on a card), only the top k pairs copied back; or, with ``--approx``, the
top of its spectrum by blocked subspace iteration without the S x S
matrix (``pca_approx``).

Per staged block (``stage_blocks``, pinned when the device is CUDA):

  exact GRM:      K13 ``grm_z`` records -> (V, K) f32 z and (V,) int32
                  used flags, then acc += z.T @ z in f64 (16,384 rows a
                  block)
  --approx pass:  K5 ``subset_repack`` (a cohort), then K13's pass
                  ``pca_approx_pass``: y += Z^T (Z q) and the used count
                  straight from the records, in three kernels (t = Z q,
                  Z^T t by chunks of rows, their sum added to y), fp32
                  FMAs, z never in device memory

Each block's copy in and its kernels' launches, and the top k pairs' copy
back, are spans of the caller's timer (``stage_read``, ``h2d``,
``kernels``, ``d2h``; ``utils/timer.py``); --approx also opens one
``approx_pass`` a pass around its blocks, ``orth`` around each scale and QR
and ``rayleigh_ritz`` around the last step, these two also timed on the
device (``timer.device_seconds``).

The exact GRM's z'z is f64 (z cast in chunks of rows) and sums in f64,
where pgen_tpu's ``_grm_device_jit`` (:109) makes it in f32 and carries an
f32 sum: on the full chr22 fixture that f32 Gram came out 1.275 off an f64
oracle's GRM x m_used, past 1e-6 of its largest entry (1.106; the card's
own f32 accumulation over a block's 16,384 rows is most of it), and the
f64 product is about as fast on the card (FP64 tensor cores; PERF.md). K13
(``csrc/genotype.cu:dosage_*_kernel<GrmRows>``) replaces the Pallas unpack,
the cohort take and ``_standardize_block_jnp`` (:91): each row's code counts
first (its p needs them), then a per-row table of four floats turns each
code into z, in K11's three forms. The --approx pass replaces
``_approx_pass_jit`` (:412), whose products pgen_tpu pins at
``Precision.HIGHEST``: its kernels (``csrc/genotype.cu:pca_zq_kernel``,
``pca_zty_kernel``, ``pca_sum_kernel``) take the same table, sum in full fp32 in a fixed order
and keep y f32 on the device as pgen_tpu carries it. Each wrapper
dispatches on the tensor's device with no fallback: a CUDA tensor launches
its kernels, a CPU tensor runs ``grm_z_plain`` or ``pca_approx_pass_plain``.

Under a process group of several ranks each rank passes its own shard of
the rows, as pgen_tpu's mesh steps shard the variant axis: ``grm_mesh``
sums the ranks' f64 z'z and used counts by one all_reduce each
(``build_grm_mesh_step``, :451), and each --approx pass all_reduces its
(S, L) y and used count (the mesh branch of ``_make_approx_pass_device``,
:342-396) after rank 0's q is broadcast, so every rank starts each pass
from the same q bit for bit.

``GrmResult``, ``pca_from_grm``, ``PcaApproxResult`` and ``pca_approx`` are
copied from pgen_tpu (``ops/pca.py:42-45``, ``:206``, ``:243-317``), whose
module imports jax at module level; ``pca_approx`` takes a device where
pgen_tpu's takes a provider, its pass is this module's, and its QR between
passes and Rayleigh-Ritz step run in f64 on that device, where pgen_tpu
copies each pass's (S, L) y back for numpy (0.7 s a QR at 488,377
samples on an 8-core host; PERF.md §6). pgen_tpu
decomposes the GRM by host LAPACK (``np.linalg.eigh``), as
``pca_from_grm`` still does a numpy array; its tensor branch runs the same
steps where the GRM lies, so that the (S, S) matrix never crosses to the
host and the card does not idle through a host library call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pgen_tpu_torch.device import matmul_fp32, resolve_device
from pgen_tpu_torch.kernels import launch, load
from pgen_tpu_torch.ops.glm import (
    F64_CHUNK_ROWS,
    code_hist,
    device_sel,
    kept_count,
    scratch_view,
    select_codes,
)
from pgen_tpu_torch.ops.gt_stats import stage_blocks
from pgen_tpu_torch.ops.pack import subset_repack
from pgen_tpu_torch.ops.unpack import check_packed
from pgen_tpu_torch.parallel.mesh import all_reduce_sum, broadcast_from_rank0
from pgen_tpu_torch.utils.timer import span

# --approx's rows a pass stages at once, unless given: 1 << 14, or as many
# as hold 64 MiB of records where that is more (narrow records), so that
# each staged copy is large enough to spread over the copy threads
APPROX_BLOCK_ROWS = 1 << 14
APPROX_BLOCK_BYTES = 1 << 26


class GrmResult(NamedTuple):
    # (S, S) f64: sum of z^T z over used variants; a numpy array from
    # grm_device, a tensor on the device that summed it from grm_mesh
    grm_sum: np.ndarray | torch.Tensor
    m_used: int  # polymorphic (sd > 0) variant count


def grm_z_plain(packed: torch.Tensor, num_samples: int, sel=None) -> tuple:
    """Plain PyTorch K13: (V, K) f32 standardized dosages of the selected
    samples and (V,) int32 used flags, in f32 in the order of pgen_tpu's
    ``_standardize_block_jnp``; 1 / sqrt where it has rsqrt, each correctly
    rounded on either device."""
    codes = select_codes(packed, num_samples, sel)
    hist = code_hist(codes)
    n_called = (hist[:, 0] + hist[:, 1] + hist[:, 2]).float()
    ac = (hist[:, 1] + 2 * hist[:, 2]).float()
    p = torch.where(n_called > 0, ac / torch.clamp(2.0 * n_called, min=1.0), 0.0)
    var = 2.0 * p * (1.0 - p)
    used = var > 0
    # the square root of an f32 value taken in f64 and rounded is correctly
    # rounded, as the kernel's sqrtf is (torch's f32 sqrt on the CPU is not
    # always)
    root = torch.sqrt(torch.clamp(var, min=1e-30).double()).float()
    inv_sd = torch.where(used, 1.0 / root, 0.0)
    # z of codes 0, 1, 2 and of a missing call, per row
    table = torch.stack([(g - 2.0 * p) * inv_sd for g in (0.0, 1.0, 2.0)]
                        + [torch.zeros_like(p)], 1)
    return table.gather(1, codes), used.to(torch.int32)


def grm_z(packed: torch.Tensor, num_samples: int, sel=None, out=None) -> tuple:
    """(V, R) u8 records -> (V, K) f32 standardized dosages z of the
    selected samples (``sel``: a 1-D int32 tensor of ids in [0,
    num_samples); all S without it) and (V,) int32 flags of the used
    (polymorphic) rows, on the input's device. ``out`` is an optional flat
    f32 device buffer for z."""
    n_var, rec = check_packed(packed, num_samples)
    n_kept = kept_count(packed, num_samples, sel)
    if packed.device.type == "cpu":
        return grm_z_plain(packed, num_samples, sel)
    z = scratch_view(out, (n_var, n_kept), packed.device)
    if n_var == 0 or n_kept == 0:
        return z, torch.zeros(n_var, dtype=torch.int32, device=packed.device)
    # row v's used flag at [0, v] (the kernel writes every row); rows [1]
    # and [2] are the chunked form's count scratch
    rows = torch.empty((3, n_var), dtype=torch.int32, device=packed.device)
    launch(grm_z, "pgen_grm_z", packed,
           packed.data_ptr(), None if sel is None else sel.data_ptr(), z.data_ptr(),
           rows.data_ptr(), n_var, rec, num_samples, n_kept)
    return z, rows[0]


grm_z.launches = 0


def pca_approx_pass_plain(packed: torch.Tensor, num_samples: int, q: torch.Tensor,
                          y: torch.Tensor, used: torch.Tensor) -> None:
    """Plain PyTorch K13 pass: y += z.T @ (z @ q) in full fp32 and used +=
    the used rows, z and the flags of ``grm_z_plain``, as pgen_tpu's
    ``_approx_pass_jit`` adds a block."""
    z, flags = grm_z_plain(packed, num_samples)
    y += matmul_fp32(z.T, matmul_fp32(z, q))
    used += flags.sum()


def approx_pass_tolerance(packed: torch.Tensor, num_samples: int, q: torch.Tensor,
                          y0: torch.Tensor, z_ulps: int = 0) -> torch.Tensor:
    """(S, L) f64: how far two fp32 evaluations of one pass, y0 + Z^T (Z q)
    with Z ``grm_z_plain``'s z, may lie apart entry by entry when they sum
    in other orders (``pca_approx_pass`` and ``pca_approx_pass_plain``, or
    pgen_tpu's ``_approx_pass_jit``). It is 8 sigma of the probabilistic
    model of rounding (each rounding independent and at most u = 2^-24
    relative; Higham and Mary, SIAM J. Sci. Comput. 41, 2019), in which a
    sum of n terms whose partial sums stay below P is off by at most
    u sqrt(n) P in sigma:
      t = Z q, n = 2 K: P = A_vl = sum_s |z_vs q_sl|, carried into y as
        sqrt(sum_v z_vs² (u sqrt(2 K) A_vl)²);
      y = y0 + Z^T t, n = 2 V + 1: P = |y0_sl| + sum_v |z_vs t_vl|;
      with z_ulps, rows of z that differ by up to z_ulps u relative (each
        row's z scales t and y once): sqrt(sum_v (2 z_ulps u z_vs t_vl)²).
    The factor 8 is sqrt 2 for the difference of two evaluations times 5.7
    sigma. Twice the terms bounds the roundings of any order of a sum."""
    z = grm_z_plain(packed, num_samples)[0].double()
    qd = q.double()
    n_var = z.shape[0]
    t = z @ qd
    a = z.abs() @ qd.abs()
    u = 2.0 ** -24
    var = (2 * num_samples) * u * u * ((z * z).T @ (a * a))
    var += (2 * n_var + 1) * u * u * (y0.double().abs() + z.abs().T @ t.abs()) ** 2
    var += (2 * z_ulps * u) ** 2 * ((z * z).T @ (t * t))
    return 8 * var.sqrt()


def approx_scratch(n_var: int, num_samples: int, device) -> torch.Tensor:
    """The pass kernels' scratch for blocks of up to n_var rows of
    num_samples samples on the card, allocated once a run: bytes, as many
    as the kernels' library asks for (each row's z table, t = Z q and the
    row chunks' partial sums of y)."""
    return torch.empty(load().pgen_pca_approx_scratch_bytes(n_var, num_samples),
                       dtype=torch.uint8, device=device)


def pca_approx_pass(packed: torch.Tensor, num_samples: int, q: torch.Tensor, y: torch.Tensor,
                    used: torch.Tensor, scratch=None) -> None:
    """One block of an --approx pass on the input's device: (V, R) u8
    records of ``num_samples`` samples (a cohort re-packed first), q (S, L)
    f32 -> y (S, L) f32 += Z^T (Z q) and used (an int64 scalar) += the
    block's polymorphic rows, in place; Z is ``grm_z``'s z. ``scratch`` is
    ``approx_scratch``'s, for at least V rows (else made here)."""
    n_var, rec = check_packed(packed, num_samples)
    n_cols = q.shape[1] if q.dim() == 2 else -1
    for name, t, dtype, shape in (("q", q, torch.float32, (num_samples, n_cols)),
                                  ("y", y, torch.float32, (num_samples, n_cols)),
                                  ("used", used, torch.int64, ())):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != packed.device):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                             f"{packed.device}")
    if packed.device.type == "cpu":
        return pca_approx_pass_plain(packed, num_samples, q, y, used)
    if n_var == 0 or num_samples == 0 or n_cols == 0:
        return None
    if scratch is None:
        scratch = approx_scratch(n_var, num_samples, packed.device)
    launch(pca_approx_pass, "pgen_pca_approx_pass", packed,
           packed.data_ptr(), q.data_ptr(), y.data_ptr(), used.data_ptr(), scratch.data_ptr(),
           n_var, rec, num_samples, n_cols, scratch.numel())
    return None


pca_approx_pass.launches = 0


def grm_device(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GrmResult:
    """pgen_tpu's ``grm_device`` on ``device`` (``"cuda"`` or ``"cpu"``, the
    kernels' plain versions): the sum of z^T z over blocks of the (V, R) u8
    records (a memory map is read block by block), f64 on the device, and
    the used-row count, over the samples of ``sample_idx`` (all S
    without it)."""
    acc, m_used = _grm_sums(packed, num_samples, resolve_device(device), block_variants,
                            sample_idx)
    with span("d2h", acc.numel() * acc.element_size()):
        return GrmResult(acc.cpu().numpy(), int(m_used))


def grm_mesh(
    packed,
    num_samples: int,
    device,
    block_variants: int = 1 << 14,
    sample_idx=None,
    timer=None,
) -> GrmResult:
    """pgen_tpu's ``grm_mesh`` over the ranks of the default process group:
    ``packed`` is this rank's shard of the rows (zero rows give zeros), and
    every rank gets the f64 z'z and used count of every rank's rows, summed
    on the device by one all_reduce each (``timer``'s). The z'z stays there,
    a tensor on ``device`` for ``pca_from_grm``."""
    dev = resolve_device(device)
    acc, m_used = all_reduce_sum(_grm_sums(packed, num_samples, dev, block_variants, sample_idx),
                                 dev, timer)
    return GrmResult(acc, int(m_used))


def _grm_sums(packed, num_samples: int, dev, block_variants: int, sample_idx) -> tuple:
    """(S, S) f64 z'z and the () int64 used count of the records, on dev."""
    ns = num_samples if sample_idx is None else len(sample_idx)
    n_var = packed.shape[0]
    acc = torch.zeros((ns, ns), dtype=torch.float64, device=dev)
    m_used = torch.zeros((), dtype=torch.int64, device=dev)
    if n_var == 0:
        return acc, m_used
    sel = device_sel(sample_idx, num_samples, dev)
    scratch = (torch.empty(min(block_variants, n_var) * ns, dtype=torch.float32, device=dev)
               if dev.type == "cuda" else None)
    for _, _, block in stage_blocks(packed, dev, block_variants):
        with span("kernels"):
            z, used = grm_z(block, num_samples, sel, out=scratch)
            add_gram_fp64(acc, z)
            m_used += used.sum()
    return acc, m_used


def add_gram_fp64(acc: torch.Tensor, z: torch.Tensor) -> None:
    """acc += z.T @ z in f64: (V, K) f32 z cast F64_CHUNK_ROWS rows at a time
    into a bounded scratch, each chunk's product added in place."""
    for r0 in range(0, z.shape[0], F64_CHUNK_ROWS):
        chunk = z[r0 : r0 + F64_CHUNK_ROWS].double()
        acc.addmm_(chunk.T, chunk)


def pca_from_grm(grm_sum: np.ndarray | torch.Tensor, m_used: int, k: int):
    """Top-k eigenpairs of GRM = grm_sum / m_used, descending, sign-fixed.

    Returns (eigenvalues (k,), eigenvectors (S, k)) with each column
    scaled to unit norm; ties/negatives kept as eigh reports them.
    A tensor is decomposed on its own device (``_pca_from_grm_tensor``).
    """
    if m_used <= 0:
        raise ValueError("pca: no polymorphic variants after filtering")
    if isinstance(grm_sum, torch.Tensor):
        return _pca_from_grm_tensor(grm_sum, m_used, k)
    g = grm_sum / float(m_used)
    vals, vecs = np.linalg.eigh((g + g.T) / 2.0)  # symmetrize f32 noise
    order = np.argsort(vals)[::-1][:k]
    vals, vecs = vals[order], vecs[:, order]
    # deterministic sign: the largest-|entry| component is positive
    flip = np.sign(vecs[np.argmax(np.abs(vecs), axis=0), np.arange(vecs.shape[1])])
    flip = np.where(flip == 0, 1.0, flip)
    return vals, vecs * flip


def _pca_from_grm_tensor(grm_sum: torch.Tensor, m_used: int, k: int) -> tuple:
    """``pca_from_grm``'s steps in f64 on the tensor's device: the scale,
    the symmetrization, ``torch.linalg.eigh``, the top k descending (eigh's
    ascending order reversed, as numpy's argsort of it reversed) and the
    sign rule (``argmax`` takes the first largest |entry|, as numpy's does).
    Only the k eigenvalues and the (S, k) eigenvectors come back, as f64
    numpy arrays, in a ``d2h`` span."""
    pca_from_grm.tensor_calls += 1
    g = grm_sum.double() / float(m_used)
    g = (g + g.T).div_(2.0)  # symmetrize f32 noise
    vals, vecs = torch.linalg.eigh(g)
    top = max(vals.shape[0] - k, 0)
    vals, vecs = vals[top:].flip(0), vecs[:, top:].flip(1)
    cols = torch.arange(vecs.shape[1], device=vecs.device)
    flip = torch.sign(vecs[vecs.abs().argmax(dim=0), cols])
    vecs = vecs * torch.where(flip == 0, 1.0, flip)
    with span("d2h", (vals.numel() + vecs.numel()) * vecs.element_size()):
        return vals.cpu().numpy(), vecs.cpu().numpy()


pca_from_grm.tensor_calls = 0


class PcaApproxResult(NamedTuple):
    eigenvalues: np.ndarray  # (k,) Rayleigh-Ritz estimates, descending
    eigenvectors: np.ndarray  # (S, k) unit-norm, sign-fixed
    m_used: int


def pca_approx(
    packed,
    num_samples: int,
    k: int,
    device,
    block_variants: int | None = None,
    sample_idx=None,
    iters: int = 10,
    oversample: int = 8,
    seed: int = 1,
    timer=None,
) -> PcaApproxResult:
    """Randomized top-k PCA WITHOUT materializing the S x S GRM.

    Blocked subspace (power) iteration on the standardized dosage matrix Z
    (M x S) — the FastPCA/plink2 `--pca approx` family (Galinsky 2016):

        Q_0 = orth(Gaussian (S, L)),  L = k + oversample
        Q_{t+1} = orth( Z^T (Z Q_t) / M )      x iters
        C = Q^T (Z^T Z Q / M)  (L x L Rayleigh-Ritz),  eigh(C) -> (lam, W)
        V = Q W[:, :k]

    Every data touch is a tall-skinny matmul pair per variant block —
    z_b @ Q (bv x L) then z_b^T @ that (S x L accumulate) — on ``device``
    (``_make_approx_pass``, one ``approx_pass`` span a pass). The Gaussian
    is numpy's, drawn from ``seed`` as pgen_tpu draws it, and copied to the
    device once; from there the subspace stays on the device in f64: each
    pass's y scaled by 1 / M and orthonormalised by ``torch.linalg.qr``
    (``orth`` spans), then the Rayleigh-Ritz step (``rayleigh_ritz``).
    Only the k eigenvalues and the (S, k) eigenvectors come back (``d2h``).

    Deterministic for a fixed seed across devices up to f32 Gram noise.
    Under a process group ``packed`` is this rank's shard of the rows, and
    each pass sums over the ranks (``timer`` times its collectives).
    """
    packed = np.asarray(packed, dtype=np.uint8)
    ns = num_samples if sample_idx is None else len(sample_idx)
    if k < 1:
        raise ValueError("pca approx: k must be >= 1")
    L = min(ns, k + max(0, oversample))
    if L < k:
        raise ValueError(f"pca approx: k={k} exceeds {ns} samples")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((ns, L))).to(dev)
    with span("orth", device=dev):
        q = torch.linalg.qr(q)[0]

    pass_fn = _make_approx_pass(packed, num_samples, dev, sample_idx, block_variants, timer)

    for _ in range(max(1, iters)):
        y, m_used = pass_fn(q)
        with span("orth", device=dev):
            q = torch.linalg.qr(y.double().div_(m_used))[0]
    # Rayleigh-Ritz on the converged subspace: one more data pass
    y, m_used = pass_fn(q)
    with span("rayleigh_ritz", device=dev):
        c = q.T @ y.double().div_(m_used)
        vals, w = torch.linalg.eigh((c + c.T).div_(2.0))
        # eigh's ascending order reversed: the top k, descending
        vals, w = vals[L - k :].flip(0), w[:, L - k :].flip(1)
        vecs = q @ w
        vecs /= torch.linalg.vector_norm(vecs, dim=0, keepdim=True)
        # deterministic sign: the largest-|entry| component is positive
        cols = torch.arange(k, device=dev)
        flip = torch.sign(vecs[vecs.abs().argmax(dim=0), cols])
        vecs *= torch.where(flip == 0, 1.0, flip)
    with span("d2h", (vals.numel() + vecs.numel()) * vecs.element_size()):
        return PcaApproxResult(vals.cpu().numpy(), vecs.cpu().numpy(), m_used)


def _make_approx_pass(packed, num_samples, dev, sample_idx, block_variants, timer=None):
    """pgen_tpu's ``_make_approx_pass_device``: each pass streams the records
    through ``pca_approx_pass`` (after K5 under a cohort), y and the used
    count summed on the device, inside one ``approx_pass`` span (the
    records' bytes); returns y, an (S, L) f32 tensor on dev, and m_used, an
    int. Under a process group (its mesh branch) rank 0's q is broadcast first
    and the pass's y and used count are summed over the ranks on the
    device. Raises when no row is polymorphic."""
    sel = device_sel(sample_idx, num_samples, dev)
    nvar = int(packed.shape[0])
    rec = int(packed.shape[1])
    bv = block_variants or max(APPROX_BLOCK_ROWS, APPROX_BLOCK_BYTES // max(rec, 1))
    bv = min(bv, max(nvar, 1))
    ns = num_samples if sel is None else sel.shape[0]
    cuda = dev.type == "cuda"
    scratch = approx_scratch(min(bv, nvar), ns, dev) if cuda else None
    repacked = (torch.empty(min(bv, nvar) * ((ns + 3) // 4), dtype=torch.uint8, device=dev)
                if cuda and sel is not None else None)

    def pass_fn(q: torch.Tensor):
        with span("approx_pass", packed.nbytes):
            qd = broadcast_from_rank0(q.float().contiguous(), timer)
            y = torch.zeros((ns, q.shape[1]), dtype=torch.float32, device=dev)
            m_used = torch.zeros((), dtype=torch.int64, device=dev)
            for _, _, block in stage_blocks(packed, dev, bv):
                with span("kernels"):
                    if sel is not None:
                        block = subset_repack(block, sel, out=repacked)
                    pca_approx_pass(block, ns, qd, y, m_used, scratch)
            y, m_used = all_reduce_sum((y, m_used), dev, timer)
            m_used = int(m_used)
        if m_used <= 0:
            raise ValueError("pca: no polymorphic variants after filtering")
        return y, m_used

    return pass_fn
