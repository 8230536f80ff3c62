"""pgen_tpu_torch — pgen_tpu ported to PyTorch and CUDA for an NVIDIA H100.

The JAX package ``pgen_tpu`` stays the reference; this package sits beside
it, imports torch and never jax. Its module names mirror ``pgen_tpu`` so
that each counterpart is easy to find:

  device.py           resolve_device: "cuda" (required, never replaced by
                      the CPU) or "cpu" (the kernels' plain versions)
  kernels.py          nvcc build of csrc/ (sm_90a) at first use, ctypes load
  csrc/               the hand-written CUDA kernels (K1-K15)
  formats/            .pgen header, .pvar/.psam metadata, the .pgen writer,
                      tabix, describe and the chr22-scale fixtures
  query/              the expression engine; compile_device.py lowers
                      predicates to torch ops on the device
  ops/                the kernels' wrappers: unpack (K1), gt_text (K2, K3,
                      K6, K7), pack (K4, K5), gt_stats (K8, K9, K14), glm
                      (K10), score (K11), relatedness (K12), pca (K13 and
                      its --approx pass), ld (K15); the logistic IRLS, king, ibd, hwe and adjust
  pipeline/           every subcommand: filter (filter_to_vcf, one GPU;
                      derive_row_layout and duplicated_ids with the GT_*
                      counts on the device for --provider device),
                      mesh_filter (--provider device on one or more GPUs),
                      pgen_out and bed_import (--out-format pgen|bed,
                      import X.bed), vcf_import, query, glm, score, king,
                      genome, pca, the reports, stats, fst, ld, prune,
                      clump, and the fileset tools (merge, diff, annotate,
                      export, roh, describe, index, view, split, concat,
                      sort, isec)
  parallel/           distributed.py: the process group and
                      run_distributed_filter (one process a shard, on
                      several hosts or cards); mesh.py: the rank-local
                      block steps and their collectives; shard.py: --shards,
                      --shard-index, --workers and --resume
  cli.py              python -m pgen_tpu_torch.cli SUBCOMMAND ... (the
                      console script pgen-tpu-torch): every subcommand and
                      flag of pgen_tpu, --device cuda|cpu on those with a
                      card stage; --provider native|numpy is refused by
                      decision (ROADMAP §1)

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

The exports are pgen_tpu's (``PgenHeader``, ``read_pgen_header``,
``MetadataTable``, ``read_metadata``, and those of ``pipeline``,
``parallel`` and ``ops``, each package's own), ``run_distributed_filter``,
and the entry points and kernel wrappers listed in ``_LAZY``. Every
exported function takes its pgen_tpu counterpart's parameters by the same
names and defaults, with ``device`` after them. Imports are lazy (PEP 562),
as in ``pgen_tpu.ops``: importing the package or a subpackage loads neither
torch nor the kernel library, and no module of it loads jax.
"""

__version__ = "0.1.0"

_LAZY = {
    "PgenHeader": "pgen_tpu_torch.formats.header",
    "read_pgen_header": "pgen_tpu_torch.formats.header",
    "MetadataTable": "pgen_tpu_torch.formats.metadata",
    "read_metadata": "pgen_tpu_torch.formats.metadata",
    "run_distributed_filter": "pgen_tpu_torch.parallel.distributed",
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
