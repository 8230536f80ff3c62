"""Faults planted under the timed path, for the tests that see a run's
``correct`` come out false: each a list of (module, attribute, wrapper)
patches of the program, by job kind."""

from __future__ import annotations

import importlib

import numpy as np


def _mesh_filter_unchanged(inner):
    """The filter returns at once, its output left as it was."""
    def _filter(pfile_prefix, var_query, sam_query, out_file, *args):
        from pgen_tpu_torch.pipeline.mesh_filter import MeshFilterResult

        timer = args[-1]
        return MeshFilterResult(out_path=out_file, num_variants_kept=0, num_samples_kept=0,
                                bytes_written=0, timer=timer)
    return _filter


def _half_valid(inner):
    """Each block's second half of rows taken as padding (left out)."""
    def step(packed, pred, valid, *args, **kw):
        valid = valid.clone()
        valid[valid.shape[0] // 2 :] = False
        return inner(packed, pred, valid, *args, **kw)
    return step


def _altered_text(inner):
    """One GT byte of each block's first kept row altered where it is made."""
    def kernel(*args, **kw):
        text = inner(*args, **kw)
        if text.numel() > 1:
            text[0, 1] ^= 1
        return text
    return kernel


def _no_exchange(inner):
    """The all-gather left out: each rank takes every shard to be its own."""
    def gather(local, group=None):
        import torch.distributed as dist

        world = dist.get_world_size(group) if dist.is_initialized() else 1
        return local.repeat(world, *([1] * (local.dim() - 1)))
    return gather


def _king_unchanged(inner):
    def _king_table(pfile_prefix, *args):
        from pgen_tpu_torch.pipeline.king import KingResult

        z = np.zeros((1, 1))
        return KingResult(0, 0, 0, None, z, z, z, timer=args[-1].timer)
    return _king_table


def _half_rows(inner):
    def gather(records, idx):
        return inner(records, idx[: len(idx) // 2])
    return gather


def _altered_counts(inner):
    def counts(*args, **kw):
        out = inner(*args, **kw)
        out.hethet[0, 1] += 1
        return out
    return counts


def _pca_unchanged(inner):
    def _pca(pfile_prefix, k, *args):
        from pgen_tpu_torch.pipeline.pca import PcaResult

        return PcaResult(0, 0, 0, np.zeros(k), np.zeros((1, k)), None, timer=args[-1].timer)
    return _pca


def _altered_grm(inner):
    def grm(*args, **kw):
        res = inner(*args, **kw)
        res.grm_sum[0, :] *= 1.01
        res.grm_sum[:, 0] *= 1.01
        return res
    return grm


FAULTS = {
    "filter_vcf": {
        "unchanged": [("pgen_tpu_torch.pipeline.mesh_filter", "_filter", _mesh_filter_unchanged)],
        "half": [("pgen_tpu_torch.pipeline.mesh_filter", "mesh_pipeline_step", _half_valid)],
        "altered": [("pgen_tpu_torch.parallel.mesh", "subset_text_from_packed", _altered_text)],
        "no_exchange": [("pgen_tpu_torch.parallel.mesh", "_gather_shards", _no_exchange)],
    },
    "king": {
        "unchanged": [("pgen_tpu_torch.pipeline.king", "_king_table", _king_unchanged)],
        "half": [("pgen_tpu_torch.pipeline.king", "_gather_rows", _half_rows)],
        "altered": [("pgen_tpu_torch.pipeline.king", "king_counts_chunked", _altered_counts)],
    },
    "pca": {
        "unchanged": [("pgen_tpu_torch.pipeline.pca", "_pca", _pca_unchanged)],
        "half": [("pgen_tpu_torch.pipeline.pca", "_gather_rows", _half_rows)],
        "altered": [("pgen_tpu_torch.pipeline.pca", "grm_mesh", _altered_grm)],
    },
}


def plant(kind: str, fault: str) -> list:
    """Apply the fault; returns what ``unplant`` needs to undo it."""
    undo = []
    for mod_name, attr, wrap in FAULTS[kind][fault]:
        mod = importlib.import_module(mod_name)
        inner = getattr(mod, attr)
        undo.append((mod, attr, inner))
        setattr(mod, attr, wrap(inner))
    return undo


def unplant(undo: list) -> None:
    for mod, attr, inner in reversed(undo):
        setattr(mod, attr, inner)
