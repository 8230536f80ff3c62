"""2-bit genotype unpack: the port of ``pgen_tpu/ops/unpack.py``.

Mode-0x02 records hold four hard calls per byte, LSB-first: sample ``s``
reads byte ``s // 4`` and extracts ``(byte >> (2 * (s % 4))) & 3``. Codes:
0 = 0/0, 1 = 0/1, 2 = 1/1, 3 = ./.

``unpack_codes`` dispatches on the tensor's device: on a CUDA tensor it
launches K1 (``csrc/genotype.cu:unpack_codes_kernel``, the counterpart of the
Pallas ``_unpack_kernel``), on a CPU tensor it runs ``unpack_codes_plain``.
There is no fallback between the two. The filter path does not call it: K2
and K3 decode inside their own kernels. It stands alone for the analytics
that reuse the decode.
"""

from __future__ import annotations

import torch

from pgen_tpu_torch.kernels import check_launch, load


def check_packed(packed, num_samples: int | None = None) -> tuple[int, int]:
    """Validate a (V, R) u8 record matrix on the CPU or a CUDA device and,
    when given, that ``num_samples`` fits its 4R slots; returns (V, R)."""
    if not isinstance(packed, torch.Tensor):
        raise TypeError(f"packed must be a torch.Tensor, got {type(packed).__name__}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    if packed.dim() != 2:
        raise ValueError(f"packed must be 2-D (variants, record bytes), got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed must be on the CPU or a CUDA device, got {packed.device}")
    n_var, rec = packed.shape
    if num_samples is not None and not 0 <= num_samples <= 4 * rec:
        raise ValueError(f"num_samples={num_samples} does not fit records of {rec} bytes")
    return n_var, rec


def current_stream(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device. The
    launchers run on the calling thread's current device, so each wrapper
    makes t's device current around its launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


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
    with torch.cuda.device(packed.device):
        status = load().pgen_unpack_codes(
            packed.data_ptr(), codes.data_ptr(), n_var, rec, current_stream(packed)
        )
    check_launch(status, "unpack_codes")
    unpack_codes.launches += 1
    return codes[:, :num_samples]


unpack_codes.launches = 0
