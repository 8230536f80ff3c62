"""Device choice for the port.

This replaces ``pgen_tpu/pipeline/device.py`` rather than porting it: that
module decides Pallas interpret mode and configures the jax compile cache,
neither of which exists here. The port has no global device: every entry
point takes a ``device`` argument and resolves it here.

The f32 matrix products of the analytics (``matmul_fp32``) run here too,
pinned to full fp32 as pgen_tpu pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` as a torch.device.

    ``cuda`` requires ``torch.cuda.is_available()`` and raises otherwise; it
    is never replaced by the CPU. ``cpu`` runs the kernels' plain PyTorch
    versions, which is what the tests hold against pgen_tpu.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(name)!r}: use cuda or cpu")


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on dev's current stream (none on the CPU).
    The block loops call it after each device stage, so that each stage's
    time is its own."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in full fp32 and restore the caller's
    setting on exit. ``"highest"`` turns TF32 off for cuBLAS and bf16 off for
    oneDNN on the CPU; TF32's 10-bit mantissa (relative error about 1e-3)
    would put the moments far outside their 2e-5 tolerance. Only the legacy
    setter is used: torch refuses to read a precision set by a mix of the
    legacy and the per-backend setters."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32 whatever the process-wide precision: the
    counterpart of pgen_tpu's ``jnp.matmul(..., precision=HIGHEST)``."""
    with full_fp32():
        return torch.matmul(a, b)
