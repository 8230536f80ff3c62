"""Multi-GPU glue of the port: the process group, the rank-local block step
and the variant shards of the host filter.

Lazy export surface (PEP 562), as ``pgen_tpu.parallel``'s names:
``filter_to_vcf_sharded`` and ``plan_shards`` (``parallel/shard.py``).
Importing the package loads no torch.
"""

_LAZY = {
    "filter_to_vcf_sharded": "pgen_tpu_torch.parallel.shard",
    "plan_shards": "pgen_tpu_torch.parallel.shard",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pgen_tpu_torch.parallel' has no attribute {name!r}")
