"""End-to-end pipelines of the port.

Lazy export surface (PEP 562), as ``pgen_tpu.pipeline``'s names:
``filter_to_vcf`` (``pipeline/filter.py``) and ``query_metadata``
(``pipeline/query.py``). Importing the package loads neither torch nor a
pipeline; each module loads on first access of its name.
"""

_LAZY = {
    "filter_to_vcf": "pgen_tpu_torch.pipeline.filter",
    "query_metadata": "pgen_tpu_torch.pipeline.query",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pgen_tpu_torch.pipeline' has no attribute {name!r}")
