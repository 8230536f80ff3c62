"""2-bit genotype unpack: the port of ``pgen_tpu/ops/unpack.py``.

Mode-0x02 records hold four hard calls per byte, LSB-first: sample ``s``
reads byte ``s // 4`` and extracts ``(byte >> (2 * (s % 4))) & 3``. Codes:
0 = 0/0, 1 = 0/1, 2 = 1/1, 3 = ./.

``unpack_codes`` dispatches on the tensor's device: on a CUDA tensor it
launches K1 (``csrc/genotype.cu:unpack_codes_kernel``, the counterpart of the
Pallas ``_unpack_kernel``), on a CPU tensor it runs ``unpack_codes_plain``.
There is no fallback between the two. K2, K3 and K5 decode inside their
own kernels; ``decode_rows`` streams a record matrix's rows through K1 for
the paths that need the codes themselves: ``merge`` (then K4), ``diff``,
``export`` and ``roh``. The input checks shared by every wrapper live here
too.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import synchronize
from pgen_tpu_torch.kernels import launch


def check_packed(packed, num_samples: int | None = None, name: str = "packed") -> tuple[int, int]:
    """Validate a 2-D contiguous u8 matrix (records, or codes when ``name``
    says so) on the CPU or a CUDA device and, when given, that
    ``num_samples`` fits its 4R slots; returns its shape."""
    if not isinstance(packed, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(packed).__name__}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {packed.dtype}")
    if packed.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must be on the CPU or a CUDA device, got {packed.device}")
    n_var, rec = packed.shape
    if num_samples is not None and not 0 <= num_samples <= 4 * rec:
        raise ValueError(f"num_samples={num_samples} does not fit records of {rec} bytes")
    return n_var, rec


def check_sel(sel, packed: torch.Tensor) -> int:
    """Validate kept sample ids for the subset kernels (K3, K5): a 1-D
    contiguous int32 tensor on ``packed``'s device; returns K. The ids' range
    is checked by the kernel's device-side assert, or by ``check_sel_range``
    in the plain versions."""
    if not isinstance(sel, torch.Tensor) or sel.dtype != torch.int32 or sel.dim() != 1:
        raise TypeError("sel must be a 1-D int32 torch.Tensor")
    if not sel.is_contiguous():
        raise ValueError("sel must be contiguous")
    if sel.device != packed.device:
        raise ValueError(f"sel is on {sel.device}, packed on {packed.device}")
    return sel.shape[0]


def check_sel_range(sel: torch.Tensor, rec: int) -> None:
    """Raise IndexError for a sample id outside [0, 4 * rec), the plain
    versions' counterpart of the kernels' device-side assert (a negative id
    would otherwise index from the end)."""
    if sel.numel() and (int(sel.min()) < 0 or int(sel.max()) >= 4 * rec):
        raise IndexError(f"sample ids must lie in [0, {4 * rec})")


def unpack_codes_plain(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch unpack: (V, R) u8 -> (V, num_samples) u8 codes."""
    n_var, rec = packed.shape
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    codes = (packed.to(torch.int32).unsqueeze(-1) >> shifts) & 3
    return codes.to(torch.uint8).reshape(n_var, 4 * rec)[:, :num_samples]


def unpack_codes(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(V, R) u8 packed records -> (V, num_samples) u8 codes, a column slice
    of a (V, 4R) buffer as in pgen_tpu (``unpack.py:110``)."""
    n_var, rec = check_packed(packed, num_samples)
    if n_var == 0 or num_samples == 0:
        return torch.empty((n_var, num_samples), dtype=torch.uint8, device=packed.device)
    if packed.device.type == "cpu":
        return unpack_codes_plain(packed, num_samples)
    codes = torch.empty((n_var, 4 * rec), dtype=torch.uint8, device=packed.device)
    launch(unpack_codes, "pgen_unpack_codes", packed,
           packed.data_ptr(), codes.data_ptr(), n_var, rec)
    return codes[:, :num_samples]


unpack_codes.launches = 0


def decode_rows(records: np.ndarray, rows: np.ndarray, num_samples: int, dev: torch.device,
                block_rows: int, cols: torch.Tensor | None, timer):
    """Yield ``(lo, hi, codes)`` for each block of ``rows``, ids of rows of
    the (V, R) u8 record matrix ``records`` (a memory map is read block by
    block): the rows ``rows[lo:hi]``, gathered on the host into one staging
    tensor (pinned when ``dev`` is CUDA), copied to ``dev`` and decoded by
    ``unpack_codes`` (K1): (hi - lo, num_samples) u8 codes on ``dev``, or
    their columns ``cols`` (int64 sample ids on ``dev``) when given. On
    ``timer`` (a StageTimer) the host gather books ``gather`` and the copy
    and decode ``decode``."""
    rec = records.shape[1]
    n = len(rows)
    staging = torch.empty((max(min(block_rows, n), 1), rec), dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
    staged = staging.numpy()
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        idx = rows[lo:hi]
        with timer.stage("gather", (hi - lo) * rec):
            if (np.diff(idx) == 1).all():
                np.copyto(staged[: hi - lo], records[int(idx[0]) : int(idx[-1]) + 1])
            else:
                np.take(records, idx, axis=0, out=staged[: hi - lo])
        with timer.stage("decode", (hi - lo) * rec):
            codes = unpack_codes(staging[: hi - lo].to(dev, non_blocking=True), num_samples)
            if cols is not None:
                codes = codes.index_select(1, cols)
            synchronize(dev)
        yield lo, hi, codes
