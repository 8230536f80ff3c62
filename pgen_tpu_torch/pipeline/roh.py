"""Runs of homozygosity on one GPU: the port of ``pgen_tpu/pipeline/roh.py``
(``roh``).

The kept variants' records go to the device by blocks: K1
``unpack_codes`` decodes each block, ``index_select`` takes the kept
samples, and the het (code 1) and missing (code 3) masks are made there
and copied into the host's two (variants, samples) bool matrices, where
pgen_tpu decodes on the host with numpy. The predicates are the port's
``compute_masks`` (``pipeline/filter.py``, genotype counts on the device).
The windowed scan (``ops/roh.py``) and the ``.hom`` / ``.hom.indiv`` text
are pgen_tpu's, copied, and stay on the host as there; ``RohResult`` and
``_chrom_runs`` are in ``pipeline/roh_host.py``. Output bytes equal
pgen_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.roh import RohParams, roh_segments_chrom
from pgen_tpu_torch.ops.unpack import decode_rows
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.pipeline.roh_host import RohResult, _chrom_runs
from pgen_tpu_torch.utils.timer import StageTimer


def roh_report(
    pfile_prefix: str,
    out_prefix: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    params: RohParams = RohParams(),
    block_variants: int = 1 << 13,
) -> RohResult:
    dev = resolve_device(device)
    timer = StageTimer()

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
    nv, ns = len(var_idx), len(sam_idx)


    all_chroms = pvar.get_column_strs("CHROM")
    all_pos = pvar.get_column_strs("POS")
    all_ids = pvar.get_column_strs("ID")
    chroms = [all_chroms[int(v)] for v in var_idx]
    try:
        pos = np.array([int(all_pos[int(v)]) for v in var_idx], dtype=np.int64)
    except ValueError as e:
        raise ValueError(f"roh: non-integer POS in {pvar.path}: {e}") from None

    # het/miss bool matrices, built blockwise on the device from the packed rows
    cols = None
    if ns != header.num_samples:
        cols = torch.from_numpy(sam_idx.astype(np.int64)).to(dev)
    het = np.empty((nv, ns), dtype=bool)
    miss = np.empty((nv, ns), dtype=bool)
    blocks = decode_rows(records, var_idx, header.num_samples, dev,
                         max(int(block_variants), 1), cols, timer)
    for lo, hi, blk in blocks:
        with timer.stage("het_miss", 2 * (hi - lo) * ns):
            het[lo:hi] = (blk == 1).cpu().numpy()
            miss[lo:hi] = (blk == 3).cpu().numpy()

    segs = []
    with timer.stage("scan", 2 * nv * ns):
        for chrom, lo, hi in _chrom_runs(chroms):
            segs.extend(roh_segments_chrom(
                chrom, pos[lo:hi], het[lo:hi], miss[lo:hi], params,
                row_offset=lo,
            ))
    # psam order by sample, then position order (scan yields position
    # order per chromosome already)
    segs.sort(key=lambda g: (g.sample, g.lo))

    iids = psam.get_column_strs("IID")
    kept_iids = [iids[int(s)] for s in sam_idx]
    kept_ids = [all_ids[int(v)] for v in var_idx]

    out_prefix = out_prefix or pfile_prefix
    hom_path = f"{out_prefix}.hom"
    indiv_path = f"{out_prefix}.hom.indiv"
    per_sample_n = np.zeros(ns, dtype=np.int64)
    per_sample_kb = np.zeros(ns, dtype=np.float64)
    with timer.stage("emit"):
        with open(hom_path, "w") as fh:
            fh.write("#IID\tCHROM\tSNP1\tSNP2\tPOS1\tPOS2\tKB\tNSNP\t"
                     "NHET\tNMISS\tDENSITY\n")
            for g in segs:
                kb = (g.pos2 - g.pos1) / 1000.0
                per_sample_n[g.sample] += 1
                per_sample_kb[g.sample] += kb
                fh.write(
                    f"{kept_iids[g.sample]}\t{g.chrom}\t{kept_ids[g.lo]}\t"
                    f"{kept_ids[g.hi]}\t{g.pos1}\t{g.pos2}\t{kb:.3f}\t"
                    f"{g.nsnp}\t{g.nhet}\t{g.nmiss}\t{kb / g.nsnp:.4f}\n"
                )
        with open(indiv_path, "w") as fh:
            fh.write("#IID\tNSEG\tKB\tKBAVG\n")
            for s in range(ns):
                avg = per_sample_kb[s] / per_sample_n[s] if per_sample_n[s] else 0.0
                fh.write(f"{kept_iids[s]}\t{per_sample_n[s]}\t"
                         f"{per_sample_kb[s]:.3f}\t{avg:.3f}\n")
    return RohResult(
        num_variants=nv,
        num_samples=ns,
        num_segments=len(segs),
        out_paths=[hom_path, indiv_path],
        timer=timer,
    )
