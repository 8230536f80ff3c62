"""Genotype concordance between two filesets on one GPU: the port of
``pgen_tpu/pipeline/diff.py`` (``diff``).

Variants match on CHROM:POS:REF:ALT (or CHROM:POS with ``--key pos``),
the first occurrence on each side; samples on shared IIDs, the first
occurrence in B. Per block of matched variants, on the device:

  decode   K1 ``unpack_codes`` of each side's matched rows (gathered on the
           host into a staging tensor, pinned when the device is CUDA),
           then ``index_select`` of the shared samples (``sa``, ``sb``)
  compare  the discordance mask (half-missing pairs count only with
           ``include_missing``; both-missing pairs never), the per-sample
           ``s_diff`` / ``s_cmp`` sums and the discordant cells' row,
           column and codes, which alone go to the host

The text, one row per discordant call in A's row order then sample order,
and the ``.sdiff`` table are pgen_tpu's f-strings. pgen_tpu decodes and
compares on the host with numpy. ``DiffResult``, ``_first_occurrence_match``
and the GT texts are its code (``pipeline/diff_host.py``); output bytes
equal pgen_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.unpack import decode_rows
from pgen_tpu_torch.pipeline.diff_host import _GT, DiffResult, _first_occurrence_match
from pgen_tpu_torch.pipeline.isec import _load_side, _variant_keys
from pgen_tpu_torch.utils.timer import StageTimer


def diff_pgen(
    prefix_a: str,
    prefix_b: str,
    out_file: str | None = None,
    key: str = "full",
    include_missing: bool = False,
    block_variants: int = 1 << 13,
    out=None,
    per_sample: bool = False,
    device="cuda",
) -> DiffResult:
    """per_sample=True additionally writes {out}.sdiff — per shared
    sample: DIFF_CT, CMP_CT (compared cells; excludes both-missing and,
    unless --include-missing, half-missing pairs), CONCORDANCE — the
    plink2 --sample-diff counts analog. The cells are compared on
    ``device``."""
    dev = resolve_device(device)
    if key not in ("full", "pos"):
        raise ValueError(f"--key must be 'full' or 'pos', got {key!r}")
    timer = StageTimer()
    ha, pa, ra = _load_side(prefix_a)
    hb, pb, rb = _load_side(prefix_b)
    psa = read_metadata(f"{prefix_a}.psam")
    psb = read_metadata(f"{prefix_b}.psam")

    with timer.stage("keys"):
        aidx, bidx = _first_occurrence_match(
            _variant_keys(pa, key), _variant_keys(pb, key)
        )
    iids_a = psa.get_column_strs("IID")
    iids_b = psb.get_column_strs("IID")
    b_by_iid = {}
    for i, iid in enumerate(iids_b):
        b_by_iid.setdefault(iid, i)  # first occurrence
    seen = set()
    sa, sb, shared_iids = [], [], []
    for i, iid in enumerate(iids_a):
        j = b_by_iid.get(iid)
        if j is not None and iid not in seen:
            seen.add(iid)
            sa.append(i)
            sb.append(j)
            shared_iids.append(iid)
    sa = np.asarray(sa, dtype=np.int64)
    sb = np.asarray(sb, dtype=np.int64)

    chroms = pa.get_column_strs("CHROM")
    poss = pa.get_column_strs("POS")
    ids = pa.get_column_strs("ID")

    nv, ns = len(aidx), len(sa)
    cols_a = torch.from_numpy(sa).to(dev)
    cols_b = torch.from_numpy(sb).to(dev)
    s_diff_dev = torch.zeros(ns, dtype=torch.int64, device=dev)
    s_cmp_dev = torch.zeros(ns, dtype=torch.int64, device=dev)
    n_disc = 0

    def emit(fh):
        nonlocal n_disc
        fh.write("#CHROM\tPOS\tID\tIID\tGT1\tGT2\n")
        bv = max(int(block_variants), 1)
        sides = zip(decode_rows(ra, aidx, ha.num_samples, dev, bv, cols_a, timer),
                    decode_rows(rb, bidx, hb.num_samples, dev, bv, cols_b, timer))
        for (lo, _, ca), (_, _, cb) in sides:
            with timer.stage("compare"):
                neq = ca != cb
                if include_missing:
                    called = (ca != 3) | (cb != 3)  # both-missing never compares
                else:
                    # plink2 default: half-missing pairs neither compare nor diff
                    called = (ca != 3) & (cb != 3)
                    neq &= called
                s_diff_dev.add_(neq.sum(dim=0))
                s_cmp_dev.add_(called.sum(dim=0))
                rc = neq.nonzero()
                r, c = rc[:, 0], rc[:, 1]
                cells = torch.stack([r, c, ca[r, c].long(), cb[r, c].long()]).cpu().numpy()
            with timer.stage("emit"):
                for r, c, ga, gb in cells.T.tolist():
                    v = int(aidx[lo + r])
                    fh.write(
                        f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t{shared_iids[c]}\t"
                        f"{_GT[ga]}\t{_GT[gb]}\n"
                    )
            n_disc += cells.shape[1]

    if out is not None:
        emit(out)
        out_path = None
    else:
        out_path = out_file or f"{prefix_a}.pdiff"
        with open(out_path, "w") as fh:
            emit(fh)
    s_diff = s_diff_dev.cpu().numpy()
    s_cmp = s_cmp_dev.cpu().numpy()
    if per_sample:
        sdiff_path = f"{out_path or prefix_a}.sdiff"
        with timer.stage("sdiff_emit"), open(sdiff_path, "w") as fh:
            fh.write("#IID\tDIFF_CT\tCMP_CT\tCONCORDANCE\n")
            for c in range(ns):
                conc = (
                    f"{1.0 - s_diff[c] / s_cmp[c]:.6g}" if s_cmp[c] else "NA"
                )
                fh.write(f"{shared_iids[c]}\t{s_diff[c]}\t{s_cmp[c]}\t"
                         f"{conc}\n")
    return DiffResult(
        num_variants=nv,
        num_samples=ns,
        num_discordant=n_disc,
        num_cells=nv * ns,
        out_path=out_path,
        timer=timer,
    )
