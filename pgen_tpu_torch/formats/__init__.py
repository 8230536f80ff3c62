"""Copied from ``pgen_tpu/formats/__init__.py``: only the imports differ."""

from pgen_tpu_torch.formats.header import (
    PGEN_MAGIC,
    PgenHeader,
    read_pgen_header,
    variant_record_size,
)
from pgen_tpu_torch.formats.metadata import MetadataTable, read_metadata
from pgen_tpu_torch.formats.writer import write_pgen

__all__ = [
    "PGEN_MAGIC",
    "PgenHeader",
    "read_pgen_header",
    "variant_record_size",
    "MetadataTable",
    "read_metadata",
    "write_pgen",
]
