"""Genotype code counts: the port of the device half of
``pgen_tpu/ops/gt_stats.py``.

Each variant's (or each sample's) hard-call histogram is one reduction over
the packed records:

    gt_counts:     counts[v, c] = #{samples s : code(v, s) == c}
    sample_counts: counts[s, c] = #{variants v : code(v, s) == c}

They bind the ``GT_*`` query variables (``--maf``, ``--geno``, ``--hwe``,
``--mind``) under ``filter --provider device``. Two wrappers, each dispatching
on the tensor's device with no fallback between the two: a CUDA tensor
launches the kernel, a CPU tensor runs the plain PyTorch version beside it.

- ``gt_counts_device``: K8, ``csrc/genotype.cu:gt_counts_kernel``, for
  pgen_tpu's ``gt_counts_device`` (the Pallas unpack, then a one-hot sum). A
  warp counts a row from the aligned 16-B words that hold its bytes, the
  slots outside the row masked off, by popcount.
- ``sample_counts_device``: K9, ``csrc/genotype.cu:sample_counts_kernel``,
  for pgen_tpu's ``sample_counts_device`` (the Pallas unpack, then a one-hot
  sum over the variants). It reads each record byte once, so bytes bound
  it (41 MB a 65,536-row block of 2504 samples). A thread counts a 4-byte
  word column bit-parallel (each code's count from the rows with a slot's
  low bit, high bit, or both set, in 4- then 8-bit fields); a block's
  warps read whole consecutive rows, meet in shared memory, and add each
  sample's four counts as two 64-bit atomics.

- ``gt_counts_masked``: K14, ``csrc/genotype.cu:gt_counts_masked_kernel``,
  for pgen_tpu's host ``gt_counts_subset`` (a 4-bit keep mask per record
  byte, ``sample_byte_masks``, then the native C++ or a LUT): each
  variant's histogram over the samples each of P keep masks keeps, all P
  from one read of the records (fst counts every cohort at once). Tiles of
  rows staged in shared memory, each row read at its own byte offset, so
  one copy of each mask (its E words, ``mask_words``) serves every row;
  the masks' E words and kept counts K_p (``kept_counts``) are made here.
  The counts are binary products on the tensor cores (``mma.sync`` .b1
  AND-POPC).

``gt_counts``, ``sample_counts`` and ``gt_counts_subset``/``gt_counts_subsets``
stream a memory-mapped (V, R) record matrix through one staging tensor
(pinned when the device is CUDA), block by block, and return int64 numpy as
pgen_tpu's ``gt_counts``/``sample_counts``/``gt_counts_subset`` do. The
other host helpers (``gt_variables``, ``sample_byte_masks``,
``GT_VARIABLE_NAMES``, the HWE test) are the port's copies of pgen_tpu's
(``ops/gt_stats_host.py``, ``ops/hwe.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device, synchronize
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.gt_stats_host import sample_byte_masks
from pgen_tpu_torch.ops.unpack import check_packed, unpack_codes_plain
from pgen_tpu_torch.utils.timer import span

# Rows per staged block: pipeline/filter_host.py's DEFAULT_BLOCK_VARIANTS.
COUNT_BLOCK_ROWS = 1 << 16
# The counts' staging spans, apart from an analytic's own "stage_read" and
# "h2d": the GT_* predicates count inside a job's "predicates" stage
COUNT_SPANS = ("count_read", "count_h2d")
# The kernels count in int32; a call of fewer rows cannot overflow one.
_MAX_ROWS = (1 << 31) - 1
# Keep masks a K14 launch counts (csrc/genotype.cu:kMaskedMaxMasks): more
# sample sets go in several launches.
MAX_MASKS = 32


def gt_counts_plain(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch per-variant counts: (V, R) u8 -> (V, 4) int32."""
    codes = unpack_codes_plain(packed, num_samples)
    return torch.stack([(codes == c).sum(1, dtype=torch.int32) for c in range(4)], 1)


def sample_counts_plain(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch per-sample counts: (V, R) u8 -> (S, 4) int32."""
    codes = unpack_codes_plain(packed, num_samples)
    return torch.stack([(codes == c).sum(0, dtype=torch.int32) for c in range(4)], 1)


def gt_counts_device(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(V, R) u8 packed records -> (V, 4) int32 code histogram of each
    variant over samples [0, num_samples), on the input's device."""
    n_var, rec = check_packed(packed, num_samples)
    if n_var > _MAX_ROWS:
        raise ValueError(f"{n_var} rows: count at most {_MAX_ROWS} per call")
    if n_var == 0 or num_samples == 0:
        return torch.zeros((n_var, 4), dtype=torch.int32, device=packed.device)
    if packed.device.type == "cpu":
        return gt_counts_plain(packed, num_samples)
    counts = torch.empty((n_var, 4), dtype=torch.int32, device=packed.device)
    launch(gt_counts_device, "pgen_gt_counts", packed,
           packed.data_ptr(), counts.data_ptr(), n_var, rec, num_samples)
    return counts


def sample_counts_device(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(V, R) u8 packed records -> (num_samples, 4) int32 code histogram of
    each sample over the V variants, on the input's device."""
    n_var, rec = check_packed(packed, num_samples)
    if n_var > _MAX_ROWS:
        raise ValueError(f"{n_var} rows: count at most {_MAX_ROWS} per call")
    if n_var == 0 or num_samples == 0:
        return torch.zeros((num_samples, 4), dtype=torch.int32, device=packed.device)
    if packed.device.type == "cpu":
        return sample_counts_plain(packed, num_samples)
    # every slot of every record byte is counted (the launcher clears the
    # counts first); the pad slots' rows are cut away below
    counts = torch.empty((4 * rec, 4), dtype=torch.int32, device=packed.device)
    launch(sample_counts_device, "pgen_sample_counts", packed,
           packed.data_ptr(), counts.data_ptr(), n_var, rec)
    return counts[:num_samples]


def _check_masks(masks, packed: torch.Tensor) -> int:
    """Validate K14's keep masks against ``packed``: a (P, R) contiguous u8
    tensor on its device; returns P."""
    if not isinstance(masks, torch.Tensor) or masks.dtype != torch.uint8 or masks.dim() != 2:
        raise TypeError("masks must be a 2-D uint8 torch.Tensor")
    if masks.shape[1] != packed.shape[1]:
        raise ValueError(f"masks have {masks.shape[1]} bytes a row, records {packed.shape[1]}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    if masks.device != packed.device:
        raise ValueError(f"masks are on {masks.device}, packed on {packed.device}")
    return masks.shape[0]


def kept_counts(masks: torch.Tensor) -> torch.Tensor:
    """(P, R) u8 keep masks -> (P,) int32: the slots each mask keeps, the
    popcount of bits 0-3 of its bytes (K_p, from which K14 makes each
    count of code 0)."""
    shifts = torch.arange(4, dtype=torch.int32, device=masks.device)
    bits = (masks.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.sum((1, 2), dtype=torch.int32)


def mask_words(masks: torch.Tensor) -> torch.Tensor:
    """(P, R) u8 keep masks (bit k of byte j keeps slot k of record byte j,
    as ``sample_byte_masks`` makes them) -> K14's (P, 8 ceil(R / 32)) int32
    operand: each mask's E words, bit k of byte j moved to bit 2k of byte j
    (the low bit of its slot, so x & E counts a record word x's kept low
    bits), zero past R, each mask's row a whole number of 32-B products
    (K14 copies a chunk's words, rounded up to 32 B, from inside it)."""
    n_masks, rec = masks.shape
    spread = (masks & 1) | ((masks & 2) << 1) | ((masks & 4) << 2) | ((masks & 8) << 3)
    out = torch.zeros((n_masks, 32 * ((rec + 31) // 32)), dtype=torch.uint8, device=masks.device)
    out[:, :rec] = spread
    return out.view(torch.int32)


def gt_counts_masked_plain(packed: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-variant counts over kept slots: (V, R) u8 records
    and (P, R) u8 keep masks -> (V, P, 4) int32."""
    n_var, rec = packed.shape
    codes = unpack_codes_plain(packed, 4 * rec)
    shifts = torch.arange(4, dtype=torch.int32, device=masks.device)
    keep = ((masks.to(torch.int32).unsqueeze(-1) >> shifts) & 1).reshape(-1, 4 * rec).bool()
    per_mask = [torch.stack([((codes == c) & k).sum(1, dtype=torch.int32) for c in range(4)], 1)
                for k in keep]
    return torch.stack(per_mask, 1).reshape(n_var, masks.shape[0], 4)


def gt_counts_masked(packed: torch.Tensor, masks: torch.Tensor, words: torch.Tensor | None = None,
                     kept: torch.Tensor | None = None) -> torch.Tensor:
    """(V, R) u8 packed records and (P, R) u8 keep masks on one device, P <=
    ``MAX_MASKS`` on CUDA -> (V, P, 4) int32: counts[v, p, c] = #{slots
    kept by mask p whose code in record v is c}, on the input's device.
    ``words`` and ``kept`` are ``mask_words(masks)`` and
    ``kept_counts(masks)`` when the caller keeps them across calls (K14
    reads them; the plain version reads the masks alone)."""
    n_var, rec = check_packed(packed)
    n_masks = _check_masks(masks, packed)
    if n_var > _MAX_ROWS:
        raise ValueError(f"{n_var} rows: count at most {_MAX_ROWS} per call")
    if n_var == 0 or n_masks == 0 or rec == 0:
        return torch.zeros((n_var, n_masks, 4), dtype=torch.int32, device=packed.device)
    if packed.device.type == "cpu":
        return gt_counts_masked_plain(packed, masks)
    if n_masks > MAX_MASKS:
        raise ValueError(f"{n_masks} masks: K14 counts at most {MAX_MASKS} a launch")
    words = mask_words(masks) if words is None else words
    kept = kept_counts(masks) if kept is None else kept
    for name, t, shape in (("words", words, (n_masks, 8 * ((rec + 31) // 32))),
                           ("kept", kept, (n_masks,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != packed.device):
            raise ValueError(f"{name} must be mask_words(masks) and kept_counts(masks): "
                             f"contiguous {shape} int32 on {packed.device}")
    counts = torch.empty((n_var, n_masks, 4), dtype=torch.int32, device=packed.device)
    launch(gt_counts_masked, "pgen_gt_counts_masked", packed, packed.data_ptr(),
           words.data_ptr(), kept.data_ptr(), counts.data_ptr(), n_var, rec, n_masks)
    return counts


gt_counts_device.launches = 0
sample_counts_device.launches = 0
gt_counts_masked.launches = 0


def stage_blocks(records: np.ndarray, dev: torch.device, block_rows: int,
                 spans: tuple = ("stage_read", "h2d")):
    """Yield (lo, hi, the records' rows [lo, hi) on dev), copied through one
    staging tensor, pinned when dev is CUDA: each block's copy into it is a
    span of the caller's timer named ``spans[0]``, its copy to dev and the
    synchronise after it (which also waits for the kernels queued on the
    block before) one named ``spans[1]``."""
    n_var, rec = records.shape
    staging = torch.empty((min(block_rows, n_var), rec), dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
    staged = staging.numpy()
    read, copy = spans
    for lo in range(0, n_var, block_rows):
        hi = min(lo + block_rows, n_var)
        with span(read, (hi - lo) * rec):
            np.copyto(staged[: hi - lo], records[lo:hi])
        with span(copy, (hi - lo) * rec):
            block = staging[: hi - lo].to(dev, non_blocking=True)
            synchronize(dev)
        yield lo, hi, block


def gt_counts(records: np.ndarray, num_samples: int, device,
              block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records (a memory map is read block by block) -> (V, 4)
    int64 per-variant code histogram, counted on ``device``."""
    dev = resolve_device(device)
    out = np.zeros((records.shape[0], 4), dtype=np.int64)
    for lo, hi, block in stage_blocks(records, dev, block_rows, COUNT_SPANS):
        out[lo:hi] = gt_counts_device(block, num_samples).cpu().numpy()
    return out


def sample_counts(records: np.ndarray, num_samples: int, device,
                  block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records (a memory map is read block by block) -> (S, 4)
    int64 per-sample code histogram over all V variants, counted on
    ``device``; the blocks' int32 counts add up in int64."""
    dev = resolve_device(device)
    total = torch.zeros((num_samples, 4), dtype=torch.int64, device=dev)
    for _, _, block in stage_blocks(records, dev, block_rows, COUNT_SPANS):
        total += sample_counts_device(block, num_samples)
    return total.cpu().numpy()


def gt_counts_subsets(records: np.ndarray, sample_sets, device,
                      block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records (a memory map is read block by block) and P sample
    id sets -> (V, P, 4) int64: each variant's code histogram over each
    set's samples, counted on ``device`` (K14, ``MAX_MASKS`` sets a launch).
    A sample named twice in a set counts once, as in pgen_tpu's
    ``gt_counts_subset`` (its keep mask is a bit per sample)."""
    dev = resolve_device(device)
    n_var, rec = records.shape
    host_masks = np.zeros((len(sample_sets), rec), dtype=np.uint8)
    for p, ids in enumerate(sample_sets):
        host_masks[p] = sample_byte_masks(np.asarray(ids), rec)
    masks = torch.from_numpy(host_masks).to(dev)
    groups = [(a, min(a + MAX_MASKS, len(sample_sets))) for a in range(0, len(sample_sets), MAX_MASKS)]
    words, kept = mask_words(masks), kept_counts(masks)
    out = np.zeros((n_var, len(sample_sets), 4), dtype=np.int64)
    for lo, hi, block in stage_blocks(records, dev, block_rows, COUNT_SPANS):
        for a, b in groups:
            out[lo:hi, a:b] = gt_counts_masked(block, masks[a:b], words[a:b],
                                               kept[a:b]).cpu().numpy()
    return out


def gt_counts_subset(records: np.ndarray, sample_idx, device,
                     block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records and one sample id set -> (V, 4) int64 code
    histogram over those samples, counted on ``device`` by K14."""
    return gt_counts_subsets(records, [sample_idx], device, block_rows)[:, 0]
