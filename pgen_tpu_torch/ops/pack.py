"""2-bit genotype pack: the port of ``pgen_tpu/ops/pack.py``.

Packs (V, S) u8 codes into mode-0x02 records of R = ceil(S/4) bytes,
LSB-first (code of sample 4j+k at bits 2k..2k+1 of byte j), the inverse of
``unpack_codes``. Each code is masked to its low two bits, as the Pallas
``_pack_kernel`` does, and the pad bits of a row's last byte are zero.

Two entry points, each dispatching on the tensor's device, with no fallback
between the two: a CUDA tensor launches the kernel, a CPU tensor runs the
plain PyTorch version beside it.

- ``pack_codes``: K4, ``csrc/genotype.cu:pack_codes_flat_kernel`` (S % 4 ==
  0 and aligned pointers) or ``pack_codes_staged_kernel`` (any other S or
  alignment), the launcher choosing; the counterpart of ``pack_codes_device``. The VCF
  import path runs it.
- ``subset_repack`` (packed records in, the kept samples' records out): K5,
  ``csrc/genotype.cu:subset_repack_staged_kernel`` (ids that touch most of a
  row: tiles of rows staged in shared memory) or
  ``subset_repack_direct_kernel`` (few ids, or rows wider than a tile: a
  gather from global memory), the launcher choosing from K and R; one kernel
  for the device branch of ``pgen_tpu/pipeline/pgen_out.py:_subset_block``
  (unpack, take of the kept columns, pack). Each thread reads its ids once.
  The ``--out-format pgen`` path runs it.
"""

from __future__ import annotations

import torch

from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.unpack import (
    check_packed,
    check_sel,
    check_sel_range,
    unpack_codes_plain,
)


def pack_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pack: (V, S) u8 codes -> (V, ceil(S/4)) u8 records."""
    n_var, n_samples = codes.shape
    rec = (n_samples + 3) // 4
    padded = torch.zeros((n_var, 4 * rec), dtype=torch.int32, device=codes.device)
    padded[:, :n_samples] = codes.to(torch.int32) & 3
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=codes.device)
    return (padded.reshape(n_var, rec, 4) << shifts).sum(dim=2).to(torch.uint8)


def subset_repack_plain(packed: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch subset re-pack, as pgen_tpu's ``_subset_block``: unpack
    all 4R slots, take the ``sel`` columns, pack. (V, R) u8 + (K,) ids ->
    (V, ceil(K/4)) u8."""
    sel = sel.to(torch.int64)
    check_sel_range(sel, packed.shape[1])
    return pack_codes_plain(unpack_codes_plain(packed, 4 * packed.shape[1])[:, sel])


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(V, S) u8 codes -> (V, ceil(S/4)) u8 records on the input's device. A
    contiguous view that starts at any byte of a larger buffer is taken."""
    n_var, n_samples = check_packed(codes, name="codes")
    rec = (n_samples + 3) // 4
    if n_var == 0 or n_samples == 0:
        return torch.empty((n_var, rec), dtype=torch.uint8, device=codes.device)
    if codes.device.type == "cpu":
        return pack_codes_plain(codes)
    packed = torch.empty((n_var, rec), dtype=torch.uint8, device=codes.device)
    launch(pack_codes, "pgen_pack_codes", codes,
           codes.data_ptr(), packed.data_ptr(), n_var, n_samples)
    return packed


def subset_repack(packed: torch.Tensor, sel: torch.Tensor, out=None) -> torch.Tensor:
    """Records of the kept samples straight from the packed bytes: (V, R) u8
    records and ``sel``, a 1-D int32 tensor of sample ids on the same device
    in any order, -> (V, ceil(K/4)) u8 records in ``sel`` order, pad bits
    zero. On CUDA an id outside [0, 4R) fails a device-side assert. ``out``
    is an optional flat u8 device buffer for the records (a block loop's,
    allocated once)."""
    n_var, rec = check_packed(packed)
    n_kept = check_sel(sel, packed)
    out_rec = (n_kept + 3) // 4
    if n_var == 0 or n_kept == 0:
        return torch.empty((n_var, out_rec), dtype=torch.uint8, device=packed.device)
    if packed.device.type == "cpu":
        return subset_repack_plain(packed, sel)
    if out is None:
        out = torch.empty((n_var, out_rec), dtype=torch.uint8, device=packed.device)
    elif out.dtype != torch.uint8 or out.device != packed.device or out.numel() < n_var * out_rec:
        raise ValueError(f"out must be uint8 on {packed.device} with at least "
                         f"{n_var * out_rec} elements")
    else:
        out = out.view(-1)[: n_var * out_rec].view(n_var, out_rec)
    launch(subset_repack, "pgen_subset_repack", packed,
           packed.data_ptr(), sel.data_ptr(), out.data_ptr(), n_var, rec, n_kept)
    return out


pack_codes.launches = 0
subset_repack.launches = 0
