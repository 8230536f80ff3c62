"""Relatedness Grams on the GPU: the indicator-plane kernel K12 and the
blocked Gram scan that ``ops/king.py`` and ``ops/ibd.py`` share.

pgen_tpu counts every pair statistic of ``king`` and ``genome`` as an inner
product over the variant axis of 0/1 indicator planes (``ops/king.py:1-40``,
``ops/ibd.py:1-50``): H (het, code 1), R (hom-ref, code 0), A (hom-alt, code
2) and C (called, code != 3). Per block of rows it runs the Pallas unpack,
the take of the cohort's columns, casts the planes to bf16 and makes each
Gram with ``jnp.matmul`` (f32 accumulation, exact below 2^24 rows).

Here, per staged block (``stage_blocks``, pinned when the device is CUDA):

  K12 ``relatedness_planes``  records -> (4, S_pad, V_pad) int8 planes,
                              each sample-major
  ``torch._int_mm``           gram += plane_x @ plane_y.T, int32

K12 (``csrc/genotype.cu:relatedness_planes_kernel``) writes each plane as a
row-major (S_pad, V_pad) matrix, so ``plane_y.t()`` is the column-major
operand the int8 product takes, with no copy. S_pad and V_pad are what
``torch._int_mm`` demands (a first dimension above 16, every dimension a
multiple of 8; V_pad a multiple of 16 so every row starts on 16 B); the pad
samples and pad variants are 0 in every plane, all missing, as pgen_tpu's
0xFF pad rows. The int32 products are exact: a block's counts are at most
its rows, and the callers keep every call below 2^24 rows (pgen_tpu's
guard), so the int32 sums across blocks are exact too. The wrapper
dispatches on the tensor's device with no fallback: a CUDA tensor launches
K12, a CPU tensor runs ``relatedness_planes_plain``; the Grams are
``torch._int_mm`` on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.glm import device_sel, kept_count, select_codes
from pgen_tpu_torch.ops.gt_stats import stage_blocks
from pgen_tpu_torch.ops.unpack import check_packed

# Plane order: H (code 1), R (code 0), A (code 2), C (code != 3).
H, R, A, C = range(4)


def plane_shape(n_var: int, n_kept: int) -> tuple[int, int]:
    """(S_pad, V_pad) of the planes of n_var rows and n_kept samples:
    ``torch._int_mm`` takes a first dimension above 16 and multiples of 8;
    V_pad is a multiple of 16, so each plane row starts on 16 B."""
    s_pad = max(24, -(-n_kept // 8) * 8)
    v_pad = max(16, -(-n_var // 16) * 16)
    return s_pad, v_pad


def relatedness_planes_plain(packed: torch.Tensor, num_samples: int, sel=None) -> torch.Tensor:
    """Plain PyTorch K12: (4, S_pad, V_pad) int8 planes H, R, A, C of the
    selected samples, sample-major, 0 at the pad samples and variants."""
    codes = select_codes(packed, num_samples, sel).T
    n_kept, n_var = codes.shape
    s_pad, v_pad = plane_shape(n_var, n_kept)
    planes = torch.zeros((4, s_pad, v_pad), dtype=torch.int8, device=packed.device)
    for p, mask in enumerate((codes == 1, codes == 0, codes == 2, codes != 3)):
        planes[p, :n_kept, :n_var] = mask
    return planes


def relatedness_planes(packed: torch.Tensor, num_samples: int, sel=None) -> torch.Tensor:
    """(V, R) u8 records -> (4, S_pad, V_pad) int8 planes, planes[p][j][v] =
    1 where the code of sample sel[j] (or j) in row v is plane p's (H: 1,
    R: 0, A: 2, C: not 3), else 0, on the input's device. ``sel`` is a 1-D
    int32 tensor of ids in [0, num_samples), any order, repeats allowed."""
    n_var, rec = check_packed(packed, num_samples)
    n_kept = kept_count(packed, num_samples, sel)
    if packed.device.type == "cpu":
        return relatedness_planes_plain(packed, num_samples, sel)
    s_pad, v_pad = plane_shape(n_var, n_kept)
    # every byte is written: the pad samples and variants as zeros
    planes = torch.empty((4, s_pad, v_pad), dtype=torch.int8, device=packed.device)
    launch(relatedness_planes, "pgen_relatedness_planes", packed,
           packed.data_ptr(), None if sel is None else sel.data_ptr(), planes.data_ptr(),
           n_var, rec, num_samples, n_kept, s_pad, v_pad)
    return planes


relatedness_planes.launches = 0


def relatedness_grams(packed, num_samples: int, device, pairs, block_variants: int,
                      sample_idx=None) -> list:
    """The Grams ``planes[x] @ planes[y].T`` for each (x, y) of ``pairs``,
    summed over blocks of ``block_variants`` rows of the (V, R) u8 records
    (a memory map is read block by block), over the samples of
    ``sample_idx`` (all S without it): a list of (K, K) f64 arrays. The
    caller keeps V below 2^24, so every int32 sum is exact."""
    dev = resolve_device(device)
    sel = device_sel(sample_idx, num_samples, dev)
    n_kept = num_samples if sel is None else sel.shape[0]
    s_pad, _ = plane_shape(0, n_kept)
    grams = [torch.zeros((s_pad, s_pad), dtype=torch.int32, device=dev) for _ in pairs]
    for _, _, block in stage_blocks(packed, dev, block_variants):
        planes = relatedness_planes(block, num_samples, sel)
        for gram, (x, y) in zip(grams, pairs):
            gram += torch._int_mm(planes[x], planes[y].t())
    return [g[:n_kept, :n_kept].cpu().numpy().astype(np.float64) for g in grams]
