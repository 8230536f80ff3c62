"""Fileset metadata rewrites on one GPU: the port of
``pgen_tpu/pipeline/annotate.py`` (``annotate``).

``--fill-info`` counts each variant's genotype codes on the device: K8
``gt_counts_device`` over every sample, or K14 ``gt_counts_masked`` over the
cohort a sample query keeps (``--include-sam``, ``--samples``,
``--samples-file``, ``--keep``/``--remove``), where pgen_tpu counts with its
native or numpy provider (or its jax unpack). The device is resolved only
when ``--fill-info`` asks for counts; the other rewrites (``--set-id``,
``--rename-chrs``, ``--rename-samples``, ``--annotations``, ``-x``) are host
code. Everything but the counts is pgen_tpu's, copied
(``pipeline/annotate_host.py``): the tags' text, the INFO splice, the
``##INFO`` declarations and the ``.pgen`` copy. Output bytes equal
pgen_tpu's.
"""

from __future__ import annotations

import shutil

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.annotate_host import (
    _INFO_DECLS,
    AnnotateResult,
    _fill_info_values,
    _fstring_column,
    _parse_fill_tags,
    _read_names_or_pairs,
    _read_pairs,
    _remap,
    _remap_contig_comments,
    _remove_one,
    _strip_tags_py,
    _table_from_rows,
    _transfer_one,
    replace_column_bytes,
)
from pgen_tpu_torch.utils.timer import StageTimer


def fill_info_column(pvar, psam, records, header, tags, sam_query=None,
                     device="cuda") -> tuple:
    """New INFO column values + augmented comments for --fill-info, the
    counts made on ``device`` (K8 for every sample, K14 for a cohort).

    Returns (new_info 'S' array, comments str with missing ##INFO decls).
    """
    from pgen_tpu_torch.ops.gt_stats import gt_counts, gt_counts_subset
    from pgen_tpu_torch.query.compile import compile_predicate

    n_cohort = header.num_samples
    if sam_query is not None:
        sam_mask = compile_predicate(sam_query, psam)
        sam_idx = np.flatnonzero(sam_mask)
        n_cohort = len(sam_idx)
        counts = gt_counts_subset(records, sam_idx.astype(np.int32), device)
    else:
        counts = gt_counts(records, header.num_samples, device)
    new_tags = _fill_info_values(tags, counts, n_cohort)

    old = pvar.get_column_bytes("INFO")
    empty = (old == b".") | (old == b"")
    # rows that may already contain a target tag: crude substring probe,
    # exact boundary-aware strip in Python only for those rows
    probe = np.zeros(len(old), dtype=bool)
    for t in tags:
        probe |= np.char.find(old, f"{t}=".encode()) >= 0
    if probe.any():
        tagset = set(tags)
        stripped = old.astype(object)
        for i in np.flatnonzero(probe):
            stripped[i] = _strip_tags_py(old[i], tagset)
        width = max(max((len(s) for s in stripped[probe]), default=1), 1)
        old = old.astype(f"S{max(old.dtype.itemsize, width)}")
        old[probe] = np.array(
            [stripped[i] for i in np.flatnonzero(probe)], dtype=f"S{width}"
        )
        empty = (old == b".") | (old == b"")
    joined = np.char.add(np.char.add(old, b";"), new_tags)
    new_info = np.where(empty, new_tags, joined)

    comments = pvar.comments
    missing_decls = "".join(
        _INFO_DECLS[t] for t in tags if f"##INFO=<ID={t}," not in comments
    )
    if missing_decls:
        comments = comments + missing_decls
    return new_info, comments


def annotate_pgen(
    pfile_prefix: str,
    out_prefix: str | None = None,
    set_id: str | None = None,
    rename_chrs: str | None = None,
    rename_samples: str | None = None,
    fill_info: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    annotations: str | None = None,
    columns: str = "ID",
    remove: str | None = None,
) -> AnnotateResult:
    if (
        set_id is None
        and rename_chrs is None
        and rename_samples is None
        and fill_info is None
        and annotations is None
        and remove is None
    ):
        raise ValueError(
            "annotate: pass at least one of --set-id / --rename-chrs / "
            "--rename-samples / --fill-info / --annotations / -x"
        )
    if sam_query is not None and fill_info is None:
        raise ValueError(
            "annotate: sample selections only apply to --fill-info counts"
        )
    if fill_info is not None:
        resolve_device(device)  # raises before any output without the card
    timer = StageTimer()
    out_prefix = (
        f"{pfile_prefix}.annotated" if out_prefix is None else str(out_prefix)
    )
    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
        psam.column_index("IID")
    if (set_id or rename_chrs or fill_info) and pvar.num_rows != header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar has {pvar.num_rows} rows but the pgen "
            f"holds {header.num_variants} variant records"
        )

    with timer.stage("annotate_pvar"):
        comments = pvar.comments
        rows = None
        if rename_chrs is not None:
            mapping = _read_pairs(rename_chrs, "--rename-chrs")
            rows = replace_column_bytes(
                pvar, "CHROM", _remap(pvar.get_column_bytes("CHROM"), mapping)
            )
            comments = _remap_contig_comments(comments, mapping)
            if set_id is not None or fill_info is not None or annotations is not None:
                # later steps see the REMAPPED contig names (bcftools order:
                # rename first, then expressions) — reparse the spliced rows
                pvar = _table_from_rows(pvar, comments, rows)
                rows = None
        if annotations is not None:
            # bcftools annotate -a analog: copy ID/INFO (or single INFO
            # tags) from another fileset, matched on CHROM:POS:REF:ALT
            src_pvar = read_metadata(f"{annotations}.pvar")
            specs = [c.strip() for c in str(columns).split(",") if c.strip()]
            if not specs:
                raise ValueError("--columns: no entries")
            for j, spec in enumerate(specs):
                col, new_vals, comments = _transfer_one(
                    pvar, src_pvar, spec, comments
                )
                rows = replace_column_bytes(pvar, col, new_vals)
                if (
                    j < len(specs) - 1
                    or set_id is not None
                    or fill_info is not None
                ):
                    pvar = _table_from_rows(pvar, comments, rows)
                    rows = None
        if fill_info is not None:
            tags = _parse_fill_tags(fill_info)
            rec = header.record_size
            mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
            records = mm[12 : 12 + header.num_variants * rec].reshape(
                header.num_variants, rec
            )
            new_info, comments = fill_info_column(
                pvar, psam, records, header, tags, sam_query, device
            )
            rows = replace_column_bytes(pvar, "INFO", new_info)
            if set_id is not None:
                # --set-id may reference INFO_* virtual variables: it sees
                # the FILLED tags
                pvar = _table_from_rows(pvar, comments, rows)
                rows = None
        if set_id is not None:
            rows = replace_column_bytes(pvar, "ID", _fstring_column(set_id, pvar))
            if remove is not None:
                pvar = _table_from_rows(pvar, comments, rows)
                rows = None
        if remove is not None:
            # bcftools annotate -x analog: drop annotations LAST (after
            # any --set-id expression saw them)
            specs = [s.strip() for s in str(remove).split(",") if s.strip()]
            if not specs:
                raise ValueError("-x: no entries")
            for j, spec in enumerate(specs):
                col, new_vals, comments = _remove_one(pvar, spec, comments)
                rows = replace_column_bytes(pvar, col, new_vals)
                if j < len(specs) - 1:
                    pvar = _table_from_rows(pvar, comments, rows)
                    rows = None
        with open(f"{out_prefix}.pvar", "wb") as f:
            if rows is None:
                with open(f"{pfile_prefix}.pvar", "rb") as src:
                    shutil.copyfileobj(src, f)
            else:
                f.write(comments.encode("utf-8"))
                f.write(pvar.header_line.encode("utf-8"))
                f.write(b"\n")
                rows.tofile(f)

    with timer.stage("annotate_psam"):
        if rename_samples is None:
            shutil.copyfile(f"{pfile_prefix}.psam", f"{out_prefix}.psam")
        else:
            spec = _read_names_or_pairs(rename_samples, "--rename-samples")
            iid = psam.get_column_bytes("IID")
            if isinstance(spec, dict):
                new_iid = _remap(iid, spec)
            else:
                if len(spec) != len(iid):
                    raise ValueError(
                        f"--rename-samples: {len(spec)} names for "
                        f"{len(iid)} samples"
                    )
                width = max((len(v) for v in spec), default=1)
                new_iid = np.array(spec, dtype=f"S{width}")
            if len(np.unique(new_iid)) != len(new_iid):
                raise ValueError("--rename-samples: duplicate IIDs after rename")
            rows = replace_column_bytes(psam, "IID", new_iid)
            with open(f"{out_prefix}.psam", "wb") as f:
                f.write(psam.comments.encode("utf-8"))
                f.write(psam.header_line.encode("utf-8"))
                f.write(b"\n")
                rows.tofile(f)

    with timer.stage("copy_pgen"):
        shutil.copyfile(f"{pfile_prefix}.pgen", f"{out_prefix}.pgen")
    return AnnotateResult(
        out_prefix, header.num_variants, header.num_samples, timer
    )
