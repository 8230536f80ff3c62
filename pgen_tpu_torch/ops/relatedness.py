"""Relatedness Grams on the GPU: K12's two kernels and the blocked Gram scan
that ``ops/king.py`` and ``ops/ibd.py`` share.

pgen_tpu counts every pair statistic of ``king`` and ``genome`` as an inner
product over the variant axis of 0/1 indicator planes (``ops/king.py:1-40``,
``ops/ibd.py:1-50``): H (het, code 1), R (hom-ref, code 0), A (hom-alt, code
2) and C (called, code != 3). Per block of rows it runs the Pallas unpack,
the take of the cohort's columns, casts the planes to bf16 and makes each
Gram with ``jnp.matmul`` (f32 accumulation, exact below 2^24 rows).

Here, per staged block (``stage_blocks``, pinned when the device is CUDA),
on a CUDA tensor:

  K5 ``subset_repack``      a cohort's samples re-packed, when there is one
  K12 ``relatedness_bits``  records -> the bit planes lo and hi of each code,
                            (2, S_pad / 16, ceil(V / 256), 128) u32 words in
                            the order the Gram kernel's fragments read them:
                            as many bytes as the records
  K12 ``relatedness_gram``  gram += X^T Y for each (x, y) of the pairs,
                            straight from the bits: each indicator word made
                            in registers, counted by .b1 AND-POPC on the
                            tensor cores, the symmetric Grams on and above
                            their diagonal only (mirrored once, at the end)

(``csrc/genotype.cu:relatedness_bits_kernel``, ``relatedness_gram_kernel``.)
The Grams stay on the card as one (n, S_pad, S_pad) int32 tensor across
blocks; S_pad is a multiple of 128, the kernel's tile side. Every
slot that is no call reads code 3, in no plane: a row's pad slots, K5's
zero pad bits and the pad samples (by count, never by their bits), and the
rows past V in the last k-step of 256. The int32 sums are exact: the
callers keep every call below 2^24 rows (pgen_tpu's guard). K12's first form
wrote the four planes as int8, 16 times the records' bytes, for
``torch._int_mm``; on a CPU tensor the scan is still that one
(``relatedness_planes_plain`` and ``torch._int_mm``), whose sums
``--device cpu`` outputs keep byte for byte. The wrappers dispatch on the
tensor's device with no fallback: a CUDA tensor launches the kernel, a CPU
tensor runs ``relatedness_bits_plain`` or ``relatedness_gram_plain``, which
the tests and chip_smoke.py hold the kernels to. The Gram kernel makes two
sets of Grams, king's and genome's (GRAM_SETS), so ``relatedness_gram`` and
``relatedness_grams`` take those two and refuse any other pairs on either
device.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.glm import device_sel, scratch_view, select_codes
from pgen_tpu_torch.ops.gt_stats import stage_blocks
from pgen_tpu_torch.ops.pack import subset_repack
from pgen_tpu_torch.ops.unpack import check_packed, unpack_codes_plain

# Plane order: H (code 1), R (code 0), A (code 2), C (code != 3).
H, R, A, C = range(4)
# The pairs of the Gram kernel's two sets (csrc/genotype.cu:rel_product):
# king's H^T H, R^T A, H^T C, C^T C and genome's H^T H, R^T A, R^T R, A^T A,
# C^T C (pgen_tpu's _device_block_grams, ops/king.py:134, and _block_grams,
# ops/ibd.py:142).
GRAM_SETS = (((H, H), (R, A), (H, C), (C, C)), ((H, H), (R, A), (R, R), (A, A), (C, C)))
STEP = 256  # variants of a k-step of mma.sync m16n8k256 (kRelStep)
PAD = 128  # S_pad is a multiple of it (kRelPad)


def plane_shape(n_var: int, n_kept: int) -> tuple[int, int]:
    """(S_pad, V_pad) of the int8 planes of n_var rows and n_kept samples:
    ``torch._int_mm`` takes a first dimension above 16 and multiples of 8;
    V_pad is a multiple of 16, so each plane row starts on 16 B."""
    s_pad = max(24, -(-n_kept // 8) * 8)
    v_pad = max(16, -(-n_var // 16) * 16)
    return s_pad, v_pad


def relatedness_planes_plain(packed: torch.Tensor, num_samples: int, sel=None) -> torch.Tensor:
    """(V, R) u8 records -> (4, S_pad, V_pad) int8 planes H, R, A, C of the
    selected samples, sample-major (``planes[p][j][v]`` = 1 where the code of
    sample sel[j], or j, in row v is plane p's), 0 at the pad samples and
    variants: the CPU's operands of ``torch._int_mm``."""
    codes = select_codes(packed, num_samples, sel).T
    n_kept, n_var = codes.shape
    s_pad, v_pad = plane_shape(n_var, n_kept)
    planes = torch.zeros((4, s_pad, v_pad), dtype=torch.int8, device=packed.device)
    for p, mask in enumerate((codes == 1, codes == 0, codes == 2, codes != 3)):
        planes[p, :n_kept, :n_var] = mask
    return planes


def gram_pad(n_kept: int) -> int:
    """S_pad of the bits and Grams of n_kept samples: a multiple of PAD."""
    return max(PAD, -(-n_kept // PAD) * PAD)


def bits_shape(n_var: int, n_kept: int) -> tuple:
    """(2, S_pad / 16, ceil(n_var / STEP), 128): the shape of K12's bits."""
    return 2, gram_pad(n_kept) // 16, -(-n_var // STEP), 128


def relatedness_bits_plain(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch ``relatedness_bits``: (V, R) u8 records of S samples ->
    (2, S_pad / 16, ceil(V / 256), 128) int32 words. Entry [p][grp][k][4
    lane + e], lane = 4 g + t, is bit plane p (0: the code's low bit, 1: its
    high bit) of sample 16 grp + g + 8 (e & 1) at the 32 variants 256 k + 32
    w + b (at bit b), w = t + 4 (e >> 1): the A fragment of mma.sync
    m16n8k256 for lane (g, t). Samples at or past S and rows at or past V
    are code 3."""
    n_var, _ = check_packed(packed, num_samples)
    _, groups, steps, _ = bits_shape(n_var, num_samples)
    codes = torch.full((steps * STEP, groups * 16), 3, dtype=torch.uint8, device=packed.device)
    codes[:n_var, :num_samples] = unpack_codes_plain(packed, num_samples)
    planes = torch.stack([codes & 1, codes >> 1]).view(2, steps, 8, 32, groups * 16)
    weights = torch.ones(32, dtype=torch.int64, device=packed.device) << torch.arange(
        32, device=packed.device)
    words = (planes.to(torch.int64) * weights[:, None]).sum(3)  # (2, steps, 8, S_pad)
    # word w = 4 hh + t, sample 16 grp + 8 half + g -> [p][grp][k][g][t][hh][half]
    words = words.view(2, steps, 2, 4, groups, 2, 8).permute(0, 4, 1, 6, 3, 2, 5)
    words = words.reshape(2, groups, steps, 128)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _bit_planes(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of ``relatedness_bits_plain``'s order: (2, S_pad, V_pad)
    bool, [p][s][v] = bit p of the code of sample s in row v."""
    _, groups, steps, _ = bits.shape
    words = bits.view(2, groups, steps, 8, 4, 2, 2).permute(0, 1, 6, 3, 2, 5, 4)
    words = words.reshape(2, groups * 16, steps * 8)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((words[..., None] >> shifts) & 1).reshape(2, groups * 16, steps * STEP).bool()


def relatedness_gram_plain(bits: torch.Tensor, pairs, grams: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``relatedness_gram``: grams[i] += X^T Y for the i-th
    (x, y) of ``pairs``, X and Y the indicator planes H, R, A, C of the bits'
    samples (H = lo & ~hi, R = ~(lo | hi), A = hi & ~lo, C = ~(lo & hi)),
    summed over their rows, in int32 by ``torch._int_mm``; a symmetric
    Gram (x == y) on and above its diagonal only. Returns grams."""
    lo, hi = _bit_planes(bits)
    planes = [p.to(torch.int8) for p in (lo & ~hi, ~(lo | hi), hi & ~lo, ~(lo & hi))]
    for gram, (x, y) in zip(grams, pairs):
        product = torch._int_mm(planes[x], planes[y].t())
        gram += product.triu() if x == y else product
    return grams


def mirror_symmetric(grams, pairs):
    """The Grams that ``relatedness_gram`` sums from zero, made whole in
    place: each symmetric one's entries above the diagonal copied below it,
    where it holds zeros. Returns grams."""
    for gram, (x, y) in zip(grams, pairs):
        if x == y:
            gram += gram.T.tril(-1)
    return grams


def relatedness_bits(packed: torch.Tensor, num_samples: int, out=None) -> torch.Tensor:
    """(V, R) u8 records of ``num_samples`` samples -> K12's bits, (2, S_pad /
    16, ceil(V / 256), 128) int32 (``relatedness_bits_plain`` gives the
    order), on the input's device. ``out`` is an optional flat int32 device
    buffer for them (a block loop's, allocated once)."""
    n_var, rec = check_packed(packed, num_samples)
    shape = bits_shape(n_var, num_samples)
    if packed.device.type == "cpu":
        return relatedness_bits_plain(packed, num_samples)
    bits = scratch_view(out, shape, packed.device, torch.int32)
    if bits.numel() == 0:
        return bits
    launch(relatedness_bits, "pgen_relatedness_bits", packed,
           packed.data_ptr(), bits.data_ptr(), n_var, rec, num_samples, shape[1], shape[2])
    return bits


relatedness_bits.launches = 0


def gram_set(pairs) -> int:
    """The index in GRAM_SETS of ``pairs``: 0 for king's, 1 for genome's.
    Any other pairs raise ValueError, on every device alike."""
    pairs = tuple(map(tuple, pairs))
    if pairs not in GRAM_SETS:
        raise ValueError(f"the relatedness Grams are king's or genome's set (GRAM_SETS), "
                         f"not {pairs}")
    return GRAM_SETS.index(pairs)


def relatedness_gram(bits: torch.Tensor, pairs, grams: torch.Tensor) -> torch.Tensor:
    """grams[i] += X^T Y for the i-th (x, y) of ``pairs`` (one of
    GRAM_SETS), over the rows of K12's bits, in place on their device;
    grams is (len(pairs), S_pad, S_pad) int32 and, like the bits, starts on
    16 B (the kernel adds to its rows by bulk reductions). A symmetric Gram
    (x == y) gets its entries on and above the diagonal only;
    ``mirror_symmetric`` copies them below it. Returns grams."""
    set_ = gram_set(pairs)
    if bits.dtype != torch.int32 or bits.dim() != 4 or bits.shape[0] != 2 or bits.shape[3] != 128:
        raise ValueError(f"bits must be (2, G, steps, 128) int32, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    s_pad = 16 * bits.shape[1]
    if (grams.dtype != torch.int32 or tuple(grams.shape) != (len(pairs), s_pad, s_pad)
            or grams.device != bits.device or not grams.is_contiguous()
            or not bits.is_contiguous()):
        raise ValueError(f"grams must be contiguous ({len(pairs)}, {s_pad}, {s_pad}) int32 on "
                         f"{bits.device}, beside contiguous bits")
    if grams.data_ptr() % 16 or bits.data_ptr() % 16:
        raise ValueError("grams and bits must start on 16 B")
    if bits.device.type == "cpu":
        return relatedness_gram_plain(bits, GRAM_SETS[set_], grams)
    if bits.shape[2] == 0:
        return grams
    launch(relatedness_gram, "pgen_relatedness_gram", bits, bits.data_ptr(), grams.data_ptr(),
           bits.shape[1], bits.shape[2], set_)
    return grams


relatedness_gram.launches = 0


def relatedness_grams(packed, num_samples: int, device, pairs, block_variants: int,
                      sample_idx=None) -> list:
    """The Grams ``X^T Y`` for each (x, y) of ``pairs`` (one of GRAM_SETS),
    summed over blocks of ``block_variants`` rows of the (V, R) u8
    records (a memory map is read block by block), over the samples of
    ``sample_idx`` (all S without it, any order, repeats allowed): a list of
    (K, K) f64 arrays. The caller keeps V below 2^24, so every int32 sum is
    exact."""
    gram_set(pairs)
    dev = resolve_device(device)
    sel = device_sel(sample_idx, num_samples, dev)
    n_kept = num_samples if sel is None else sel.shape[0]
    if dev.type == "cpu":
        s_pad, _ = plane_shape(0, n_kept)
        grams = [torch.zeros((s_pad, s_pad), dtype=torch.int32) for _ in pairs]
        for _, _, block in stage_blocks(packed, dev, block_variants):
            planes = relatedness_planes_plain(block, num_samples, sel)
            for gram, (x, y) in zip(grams, pairs):
                gram += torch._int_mm(planes[x], planes[y].t())
        return [g[:n_kept, :n_kept].numpy().astype(np.float64) for g in grams]
    if n_kept == 0:
        return [np.zeros((0, 0), dtype=np.float64) for _ in pairs]
    s_pad = gram_pad(n_kept)
    grams = torch.zeros((len(pairs), s_pad, s_pad), dtype=torch.int32, device=dev)
    rows = min(block_variants, int(packed.shape[0]))
    bits = torch.empty(int(np.prod(bits_shape(rows, n_kept))), dtype=torch.int32, device=dev)
    repacked = (None if sel is None
                else torch.empty(rows * ((n_kept + 3) // 4), dtype=torch.uint8, device=dev))
    for _, _, block in stage_blocks(packed, dev, block_variants):
        if sel is not None:
            block = subset_repack(block, sel, out=repacked)
        relatedness_gram(relatedness_bits(block, n_kept, bits), pairs, grams)
    mirror_symmetric(grams, pairs)
    return [g[:n_kept, :n_kept].cpu().numpy().astype(np.float64) for g in grams]
