"""Device choice for the port.

This replaces ``pgen_tpu/pipeline/device.py`` rather than porting it: that
module decides Pallas interpret mode and configures the jax compile cache,
neither of which exists here. The port has no global device: every entry
point takes a ``device`` argument and resolves it here.
"""

from __future__ import annotations

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
