"""Genotype ops on torch tensors: each wrapper launches its CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.

Lazy export surface (PEP 562), as ``pgen_tpu.ops``'s: importing the package
or a sibling module loads no kernel module through this ``__init__``, and
``from pgen_tpu_torch.ops import unpack_codes`` loads ``ops/unpack.py`` on
first access. pgen_tpu's names are exported under the port's own; where
they differ, ``RENAMES`` lists pgen_tpu's name beside the port's:
``pack_codes_device`` is K4 ``pack_codes``, and ``genotype_text_planes``
(the text as planes, a workaround for Mosaic's layouts, ROADMAP §2) is K2
``genotype_text``, which writes the interleaved text itself.
``unpack_codes_reference`` is the numpy oracle of ``ops/unpack_host.py``.
"""

_LAZY = {
    "unpack_codes": "pgen_tpu_torch.ops.unpack",
    "unpack_codes_reference": "pgen_tpu_torch.ops.unpack_host",
    "pack_codes": "pgen_tpu_torch.ops.pack",
    "genotype_text": "pgen_tpu_torch.ops.gt_text",
    "genotype_text_from_codes": "pgen_tpu_torch.ops.gt_text",
}

# pgen_tpu.ops's name -> the port's name of the same function
RENAMES = {
    "pack_codes_device": "pack_codes",
    "genotype_text_planes": "genotype_text",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pgen_tpu_torch.ops' has no attribute {name!r}")
