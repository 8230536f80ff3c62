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

``gt_counts`` and ``sample_counts`` stream a memory-mapped (V, R) record
matrix through one staging tensor (pinned when the device is CUDA), block by
block, and return int64 numpy as pgen_tpu's ``gt_counts``/``sample_counts``
do with ``provider="device"``. The host helpers (``gt_variables``,
``gt_counts_subset``, ``GT_VARIABLE_NAMES``, the HWE test) are the port's
copies of pgen_tpu's (``ops/gt_stats_host.py``, ``ops/hwe.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device, synchronize
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.unpack import check_packed, unpack_codes_plain

# Rows per staged block: pipeline/filter_host.py's DEFAULT_BLOCK_VARIANTS.
COUNT_BLOCK_ROWS = 1 << 16
# The kernels count in int32; a call of fewer rows cannot overflow one.
_MAX_ROWS = (1 << 31) - 1


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


gt_counts_device.launches = 0
sample_counts_device.launches = 0


def stage_blocks(records: np.ndarray, dev: torch.device, block_rows: int):
    """Yield (lo, hi, the records' rows [lo, hi) on dev), copied through one
    staging tensor, pinned when dev is CUDA."""
    n_var, rec = records.shape
    staging = torch.empty((min(block_rows, n_var), rec), dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
    staged = staging.numpy()
    for lo in range(0, n_var, block_rows):
        hi = min(lo + block_rows, n_var)
        np.copyto(staged[: hi - lo], records[lo:hi])
        block = staging[: hi - lo].to(dev, non_blocking=True)
        synchronize(dev)
        yield lo, hi, block


def gt_counts(records: np.ndarray, num_samples: int, device,
              block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records (a memory map is read block by block) -> (V, 4)
    int64 per-variant code histogram, counted on ``device``."""
    dev = resolve_device(device)
    out = np.zeros((records.shape[0], 4), dtype=np.int64)
    for lo, hi, block in stage_blocks(records, dev, block_rows):
        out[lo:hi] = gt_counts_device(block, num_samples).cpu().numpy()
    return out


def sample_counts(records: np.ndarray, num_samples: int, device,
                  block_rows: int = COUNT_BLOCK_ROWS) -> np.ndarray:
    """(V, R) u8 records (a memory map is read block by block) -> (S, 4)
    int64 per-sample code histogram over all V variants, counted on
    ``device``; the blocks' int32 counts add up in int64."""
    dev = resolve_device(device)
    total = torch.zeros((num_samples, 4), dtype=torch.int64, device=dev)
    for _, _, block in stage_blocks(records, dev, block_rows):
        total += sample_counts_device(block, num_samples)
    return total.cpu().numpy()
