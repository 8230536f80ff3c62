"""Copied from ``pgen_tpu/utils/__init__.py``: only the imports differ."""

from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

__all__ = ["get_logger", "StageTimer"]
