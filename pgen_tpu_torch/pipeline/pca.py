"""``pca`` on one GPU: the port of ``pgen_tpu/pipeline/pca.py`` with
pgen_tpu's device provider.

The plink2 ``--pca`` analog: the same include/exclude predicates, regions
and sample lists as ``filter``; the GRM on ``device`` (``ops/pca.py``: K13
and ``torch.matmul`` in full fp32), its top-k eigenpairs by host LAPACK, or
with ``--approx`` randomized subspace iteration (``pca_approx``, every data
pass on ``device``). Writes

    OUT.eigenvec   #IID  PC1 .. PCK      (unit-norm eigenvector columns)
    OUT.eigenval   one eigenvalue per line, descending

and with ``--make-rel [bin|text]`` the relationship matrix itself,
OUT.rel.bin (row-major little-endian f64) or OUT.rel (text), plus
OUT.rel.id; ``-k 0`` skips the eigendecomposition. The masks are the port's
``compute_masks`` (genotype counts on the device, as glm's); ``pca`` is
copied from pgen_tpu, with a device where pgen_tpu takes a provider.

Under a process group of several ranks (``parallel/mesh.py``) rank r
gathers and standardizes only its contiguous shard of the kept variants:
the GRM's z'z and used count are summed over the ranks (``grm_mesh``), and
each --approx pass's y likewise; rank 0 alone writes.

Stages (``PcaResult.timer``): process_group, metadata_load, predicates,
gather, grm (inside it each block's stage_read and h2d, the all_reduce and
the GRM's d2h) and eigh, or pca_approx (each pass's stage_read and h2d,
its broadcasts and all_reduces inside); emit, emit_rel; under several
ranks, one line a rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.pca import grm_mesh, pca_approx, pca_from_grm
from pgen_tpu_torch.parallel.mesh import variant_mesh
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.filter_host import _gather_rows
from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class PcaResult:
    num_variants: int  # variants entering the GRM (post-filter)
    num_used: int  # polymorphic variants actually counted
    num_samples: int
    eigenvalues: np.ndarray  # (k,)
    eigenvectors: np.ndarray  # (S, k)
    out_prefix: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def pca(
    pfile_prefix: str,
    k: int = 10,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_prefix: str | None = None,
    device="cuda",
    block_variants: int | None = None,
    write: bool = True,
    make_rel: str | None = None,
    approx: bool = False,
    approx_iters: int = 10,
    seed: int = 1,
) -> PcaResult:
    """pgen_tpu's ``pca`` with ``provider="device"``, its device work on
    ``device`` (``"cuda"``, which must be available, or ``"cpu"``, the
    kernels' plain versions), over this rank's variant shard under a
    process group. Same arguments otherwise; rank 0 writes."""
    if make_rel not in (None, "bin", "text"):
        raise ValueError(f"--make-rel must be 'bin' or 'text', got {make_rel!r}")
    if k == 0 and make_rel is None:
        raise ValueError("pca: -k 0 only makes sense with --make-rel")
    if approx and make_rel is not None:
        raise ValueError(
            "--make-rel materializes the exact S x S GRM, which --approx "
            "exists to avoid; drop one of the two"
        )
    timer = StageTimer()
    with variant_mesh(device, timer) as mesh:
        return _pca(pfile_prefix, k, var_query, sam_query, out_prefix, block_variants, write,
                    make_rel, approx, approx_iters, seed, mesh)


def _pca(pfile_prefix, k, var_query, sam_query, out_prefix, block_variants, write, make_rel,
         approx, approx_iters, seed, mesh) -> PcaResult:
    dev, timer = mesh.device, mesh.timer
    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
        psam.column_index("IID")

        rec = header.record_size
        mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
        records = mm[12 : 12 + header.num_variants * rec].reshape(
            header.num_variants, rec
        )
    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, dev
        )
        var_idx = np.flatnonzero(var_mask)
        sam_idx = np.flatnonzero(sam_mask)
    n_sam = len(sam_idx)
    if n_sam < 2:
        raise ValueError(f"pca needs >= 2 samples after filtering (got {n_sam})")
    k = min(k, n_sam)
    lo, hi = mesh.shard(len(var_idx), "pca_approx" if approx else "grm")
    with timer.stage("gather", (hi - lo) * rec):
        kept = _gather_rows(records, var_idx[lo:hi])

    subset = (
        None if n_sam == header.num_samples else sam_idx.astype(np.int32)
    )
    kw = {"block_variants": int(block_variants)} if block_variants else {}
    if approx:
        # randomized subspace iteration: never materializes the S x S GRM
        # (plink2 --pca approx analog; right for S >> 10^4 cohorts)
        with timer.stage("pca_approx", kept.shape[0] * rec):
            ares = pca_approx(
                kept, header.num_samples, k, dev,
                sample_idx=subset, iters=approx_iters, seed=seed, timer=timer, **kw,
            )
        vals, vecs = ares.eigenvalues, ares.eigenvectors
        m_used = ares.m_used
        mesh.report_ranks()
    else:
        with timer.stage("grm", kept.shape[0] * rec):
            res = grm_mesh(kept, header.num_samples, dev,
                           sample_idx=subset, timer=timer, **kw)
        m_used = res.m_used
        mesh.report_ranks()
        if k > 0 and mesh.rank == 0:
            with timer.stage("eigh"):
                vals, vecs = pca_from_grm(res.grm_sum, res.m_used, k)
        else:
            vals = np.zeros(0)
            vecs = np.zeros((n_sam, 0))

    out = out_prefix or f"{pfile_prefix}.pca"
    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]
    write = write and mesh.rank == 0
    if write and k > 0:
        with timer.stage("emit"):
            with open(f"{out}.eigenvec", "w") as fh:
                fh.write("#IID\t" + "\t".join(f"PC{i+1}" for i in range(k)) + "\n")
                for row, iid in enumerate(iids):
                    fh.write(
                        iid + "\t"
                        + "\t".join(f"{vecs[row, c]:.10g}" for c in range(k))
                        + "\n"
                    )
            with open(f"{out}.eigenval", "w") as fh:
                fh.writelines(f"{v:.10g}\n" for v in vals)
    if write and make_rel is not None:
        if m_used <= 0:
            raise ValueError("pca: no polymorphic variants after filtering")
        rel = res.grm_sum / float(m_used)
        with timer.stage("emit_rel", rel.nbytes):
            with open(f"{out}.rel.id", "w") as fh:
                fh.writelines(f"{iid}\n" for iid in iids)
            if make_rel == "bin":
                rel.astype("<f8").tofile(f"{out}.rel.bin")
            else:
                with open(f"{out}.rel", "w") as fh:
                    for row in rel:
                        fh.write("\t".join(f"{v:.10g}" for v in row) + "\n")
    return PcaResult(
        num_variants=len(var_idx),
        num_used=m_used,
        num_samples=n_sam,
        eigenvalues=vals,
        eigenvectors=vecs,
        out_prefix=out if write else None,
        timer=timer,
    )
