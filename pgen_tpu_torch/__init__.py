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

The package imports nothing of pgen_tpu. The jax-free host layers its entry
points run are copies of pgen_tpu's, each naming its source and differing
only in its imports (the exceptions say so in their docstrings), at the
same paths: formats/ (header, metadata, tabix, writer; fixtures.py copies
tools/make_fixtures.py's ensure_chr22), query/ (the expression engine),
native/ (the C++ host runtime, built with g++ into build/pgen_tpu_torch/),
utils/, ops/adjust.py, ops/hwe.py, ops/unpack_host.py, pipeline/vcf.py and
cli_parser.py; a module that is only partly copied, because the rest runs
jax or is pgen_tpu's own pipeline, is copied as X_host.py beside the port's
X.py (pipeline/filter_host.py, vcf_import_host.py, pgen_out_host.py,
glm_host.py, score_host.py, ops/gt_stats_host.py, ops/logistic_host.py).
The system has no model and no weights; its state is the fileset.

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
