"""Polygenic scoring on the GPU: the port of ``pgen_tpu/ops/score.py``.

Each sample's score sums are ``sum_v d_vs * w_vk`` over the scored
variants, with d the effect-allele dosage (the alt count, or 2 minus it
where the effect allele is REF), missing calls mean-imputed by default
(plink2's default) or 0 with ``mean_impute=False`` (plink2
``no-mean-imputation``). ``ScoreResult`` and the ALLELE_CT semantics are
pgen_tpu's: with mean imputation every variant with a called sample counts
for every sample; without, a variant counts for the samples called there.

``score`` is a blocked loop over a staged (V, R) record matrix
(``stage_blocks``, pinned when the device is CUDA). Per block:

  K11 ``score_dosage``  records -> (V, K) f32 dosages db, (V,) called counts
  ``matmul_fp32``       sums += db.T @ w (torch.matmul in full fp32)
  ``db.sum(0)``         the per-sample dosage sums

K11 (``csrc/genotype.cu:score_dosage_*``) replaces the decode leg of
pgen_tpu's ``_score_device_jit`` (:133-158): the Pallas unpack, the cohort
take, the effect-allele flip and the mean imputation. It writes 4 B a
selected sample against a quarter byte read, so bytes bound it (164 MB a
16,384-row block of 2504 samples). A missing call's fill needs the row's
counts before its first store, so each form counts a row before it
writes it: with every sample scored and S % 4 == 0 one warp per row counts
its bytes by popcount and writes each byte's four dosages as one 16 B
store (the flat form); otherwise K10's tiles, each byte (row, code) mapped
through a per-row table; past 8,192 ids a count pass runs first and the
tiles take column chunks.

The sums and dosage sums add up across blocks in f32 on the device, as
``_score_device_jit`` carries them (:160-166), and come back as f64.
Without mean imputation ALLELE_CT needs, per sample, the number of rows in
which it is called (every called row is a used row). That is the block's
rows minus K9's per-sample missing count (``sample_counts_device``),
gathered by the cohort ids: K9 already counts every code of every slot in
one pass over the block's bytes, so K11 needs no atomics of its own.

``score_mesh`` is pgen_tpu's mesh step (``build_score_mesh_step``, :344)
over the ranks of a process group: each rank scores its own rows and the
four results are summed over the ranks, one all_reduce each, in f64.

``ScoreResult`` is carried over from pgen_tpu, whose module imports jax at
module level. ``score_dosage`` dispatches on the tensor's device with no
fallback: a CUDA tensor launches K11, a CPU tensor runs
``score_dosage_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pgen_tpu_torch.device import matmul_fp32, resolve_device
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.glm import (
    DEFAULT_BLOCK_VARIANTS,
    device_sel,
    kept_count,
    scratch_view,
    select_codes,
)
from pgen_tpu_torch.ops.gt_stats import sample_counts_device, stage_blocks
from pgen_tpu_torch.ops.unpack import check_packed
from pgen_tpu_torch.parallel.mesh import all_reduce_sum


class ScoreResult(NamedTuple):
    sums: np.ndarray  # (S, K) f64 score sums
    dosage_sum: np.ndarray  # (S,) f64 effect-allele dosage sums
    allele_ct: np.ndarray  # (S,) i64 per-sample denominators
    m_used: int  # variants with >= 1 called sample


def score_dosage_plain(packed: torch.Tensor, num_samples: int, flip: torch.Tensor,
                       mean_impute: bool = True, sel=None) -> tuple:
    """Plain PyTorch K11: (V, K) f32 effect dosages and (V,) int32 called
    counts of the selected samples."""
    codes = select_codes(packed, num_samples, sel)
    called = codes != 3
    n_called = called.sum(1, dtype=torch.int32)
    dosage = torch.where(flip.bool()[:, None], 2 - codes, codes)
    dosage = torch.where(called, dosage, 0)
    if mean_impute:
        mean = dosage.sum(1).float() / n_called.clamp(min=1).float()
        fill = torch.where(n_called > 0, mean, 0.0)
    else:
        fill = torch.zeros(codes.shape[0], dtype=torch.float32, device=codes.device)
    return torch.where(called, dosage.float(), fill[:, None]), n_called


def score_dosage(packed: torch.Tensor, num_samples: int, flip: torch.Tensor,
                 mean_impute: bool = True, sel=None, out=None) -> tuple:
    """(V, R) u8 records + flip (V,) u8 -> (V, K) f32 effect-allele dosages
    of the selected samples (``sel``: a 1-D int32 tensor of ids in
    [0, num_samples); all S without it) and (V,) int32 called counts, on the
    input's device. A missing call is 0, or with ``mean_impute`` in a row
    with a called sample the row's mean dosage. ``out`` is an optional flat
    f32 device buffer for the dosages."""
    n_var, rec = check_packed(packed, num_samples)
    n_kept = kept_count(packed, num_samples, sel)
    if not isinstance(flip, torch.Tensor) or flip.dtype != torch.uint8 or flip.shape != (n_var,):
        raise TypeError(f"flip must be a ({n_var},) uint8 torch.Tensor")
    if not flip.is_contiguous() or flip.device != packed.device:
        raise ValueError("flip must be contiguous and on packed's device")
    if packed.device.type == "cpu":
        return score_dosage_plain(packed, num_samples, flip, mean_impute, sel)
    db = scratch_view(out, (n_var, n_kept), packed.device)
    if n_var == 0 or n_kept == 0:
        return db, torch.zeros(n_var, dtype=torch.int32, device=packed.device)
    # row v's called count at [0, v] (the kernel writes every row); row
    # [1] is the chunked form's scratch for the row sums
    called = torch.empty((2, n_var), dtype=torch.int32, device=packed.device)
    launch(score_dosage, "pgen_score_dosage", packed,
           packed.data_ptr(), None if sel is None else sel.data_ptr(), flip.data_ptr(),
           db.data_ptr(), called.data_ptr(), n_var, rec, num_samples, n_kept,
           int(bool(mean_impute)))
    return db, called[0]


score_dosage.launches = 0


def score(packed, num_samples: int, weights, flip, device, mean_impute: bool = True,
          block_variants: int = DEFAULT_BLOCK_VARIANTS, sample_idx=None) -> ScoreResult:
    """pgen_tpu's ``score_device`` on ``device``: (V, R) u8 records (a
    memory map is read block by block), (V, Kw) weights, (V,) flip ->
    f64 ScoreResult over the samples of ``sample_idx`` (all S without it)."""
    dev = resolve_device(device)
    weights = np.asarray(weights, dtype=np.float32)
    flip = np.asarray(flip, dtype=bool)
    n_var = packed.shape[0]
    if weights.ndim != 2 or weights.shape[0] != n_var or flip.shape != (n_var,):
        raise ValueError(
            f"score: weights {weights.shape} / flip {flip.shape} do not match {n_var} variants"
        )
    sel = device_sel(sample_idx, num_samples, dev)
    ns = num_samples if sel is None else sel.shape[0]
    if n_var == 0:
        return ScoreResult(np.zeros((ns, weights.shape[1])), np.zeros(ns),
                           np.zeros(ns, np.int64), 0)
    flip_d = torch.from_numpy(flip.astype(np.uint8)).to(dev)
    sums = torch.zeros((ns, weights.shape[1]), dtype=torch.float32, device=dev)
    dosage = torch.zeros(ns, dtype=torch.float32, device=dev)
    called_ct = torch.zeros(ns, dtype=torch.int64, device=dev)
    scratch = (torch.empty(min(block_variants, n_var) * ns, dtype=torch.float32, device=dev)
               if dev.type == "cuda" else None)
    m_used = 0
    for lo, hi, block in stage_blocks(packed, dev, block_variants):
        db, n_called = score_dosage(block, num_samples, flip_d[lo:hi], mean_impute, sel,
                                    out=scratch)
        m_used += int((n_called > 0).sum())
        if not mean_impute:
            missing = sample_counts_device(block, num_samples)[:, 3]
            if sel is not None:
                missing = missing[sel.long()]
            called_ct += (hi - lo) - missing
        w = torch.from_numpy(weights[lo:hi]).to(dev)
        sums += matmul_fp32(db.T, w)
        dosage += db.sum(0)
    ct = np.full(ns, 2 * m_used, dtype=np.int64) if mean_impute else 2 * called_ct.cpu().numpy()
    return ScoreResult(sums.cpu().numpy().astype(np.float64),
                       dosage.cpu().numpy().astype(np.float64), ct, m_used)


def score_mesh(packed, num_samples: int, weights, flip, device, mean_impute: bool = True,
               block_variants: int = DEFAULT_BLOCK_VARIANTS, sample_idx=None,
               timer=None) -> ScoreResult:
    """pgen_tpu's ``score_mesh`` over the ranks of the default process group:
    ``packed``, ``weights`` and ``flip`` are this rank's shard of the rows
    (zero rows give zeros), and every rank gets the sums, dosage sums,
    ALLELE_CT and used count of every rank's rows, one all_reduce each
    (``timer``'s)."""
    res = score(packed, num_samples, weights, flip, device, mean_impute, block_variants,
                sample_idx)
    return ScoreResult(*all_reduce_sum(res, resolve_device(device), timer))
