"""Copied from ``pgen_tpu/native/__init__.py``: only the imports differ."""

from pgen_tpu_torch.native.lib import HAVE_NATIVE, native

__all__ = ["HAVE_NATIVE", "native"]
