"""pgen_tpu_torch — pgen_tpu ported to PyTorch and CUDA for an NVIDIA H100.

The JAX package ``pgen_tpu`` stays the reference; this package sits beside
it, imports torch and never jax. Its module names mirror ``pgen_tpu`` so
that each counterpart is easy to find:

  device.py           resolve_device: "cuda" (required, never replaced by
                      the CPU) or "cpu" (the kernels' plain versions)
  kernels.py          nvcc build of csrc/ (sm_90a) at first use, ctypes load
  csrc/               the hand-written CUDA kernels
  ops/unpack.py       unpack_codes (K1)
  ops/gt_text.py      genotype_text (K2), subset_text_from_packed (K3),
                      genotype_text_transposed (K6),
                      genotype_text_from_codes (K7)
  ops/pack.py         pack_codes (K4), subset_repack (K5)
  ops/gt_stats.py     gt_counts_device (K8), sample_counts_device (K9)
  ops/glm.py          glm_planes (K10); the GWAS moments and the f64 solves
  ops/score.py        score_dosage (K11); polygenic score sums
  ops/logistic.py     the logistic IRLS (pgen_tpu's) with fp32 products
                      on the device
  query/compile_device.py  lower_device: predicates as torch ops on the
                      device over padded column tensors
  parallel/distributed.py  the process group: one process per GPU
  parallel/mesh.py    the rank-local block step and its all-gathers
  pipeline/filter.py  filter_to_vcf on one GPU; compute_masks with the
                      genotype counts on the device
  pipeline/mesh_filter.py  filter_to_vcf_mesh (--provider device) on one
                      or more GPUs
  pipeline/pgen_out.py  filter_to_pgen (--out-format pgen) on one GPU
  pipeline/vcf_import.py  import_vcf on one GPU
  pipeline/glm.py     glm_pfile (--glm) on one GPU
  pipeline/score.py   score_pfile (--score) on one GPU
  cli.py              python -m pgen_tpu_torch.cli filter|import|glm|score ...

The host layers are pgen_tpu's, reused by import and not copied: metadata
and predicates, the output row layout, the C++ row assembler, BGZF and
tabix. The system has no model and no weights; its state is the fileset,
which both packages read through the shared ``pgen_tpu.formats`` loaders.

Imports are lazy (PEP 562), as in ``pgen_tpu.ops``: importing the package
loads neither torch nor the kernel library, and no module of it loads jax.
"""

__version__ = "0.1.0"

_LAZY = {
    "resolve_device": "pgen_tpu_torch.device",
    "unpack_codes": "pgen_tpu_torch.ops.unpack",
    "genotype_text": "pgen_tpu_torch.ops.gt_text",
    "subset_text_from_packed": "pgen_tpu_torch.ops.gt_text",
    "genotype_text_from_codes": "pgen_tpu_torch.ops.gt_text",
    "genotype_text_transposed": "pgen_tpu_torch.ops.gt_text",
    "pack_codes": "pgen_tpu_torch.ops.pack",
    "subset_repack": "pgen_tpu_torch.ops.pack",
    "gt_counts_device": "pgen_tpu_torch.ops.gt_stats",
    "sample_counts_device": "pgen_tpu_torch.ops.gt_stats",
    "glm_planes": "pgen_tpu_torch.ops.glm",
    "score_dosage": "pgen_tpu_torch.ops.score",
    "lower_device": "pgen_tpu_torch.query.compile_device",
    "filter_to_vcf": "pgen_tpu_torch.pipeline.filter",
    "filter_to_vcf_mesh": "pgen_tpu_torch.pipeline.mesh_filter",
    "filter_to_pgen": "pgen_tpu_torch.pipeline.pgen_out",
    "import_vcf": "pgen_tpu_torch.pipeline.vcf_import",
    "glm_pfile": "pgen_tpu_torch.pipeline.glm",
    "score_pfile": "pgen_tpu_torch.pipeline.score",
}

__all__ = [*_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pgen_tpu_torch' has no attribute {name!r}")
