"""`pgen-tpu clump`: LD-aware clumping of association results.

The port of ``pgen_tpu/pipeline/clump.py``, copied whole with a device
where pgen_tpu takes a provider: only the predicates run on it (the port's
``compute_masks``, genotype counts on the device); the clumping itself is
pgen_tpu's host code, as there (``ops/ld.py``'s copy of
``centered_dosage_np`` and the host unpack).

plink `--clump` analog (extension — the reference is a query/filter
tool, pgen-rs/README.md:3-5). Takes an association report (e.g.
a `glm` output: any TSV with an ID column and a P column), picks index
variants (P <= p1) best-first, and assigns every unassigned variant
within `kb` kilobases whose LD r² with the index reaches `r2` to that
index's clump — so a GWAS hit list collapses to independent signals.

r² uses the same mean-imputed centered-dosage correlation as `prune`
(ops/ld.py centered_dosage_np): per clump, one decode of the window's
rows and one (W, S) x (S,) matvec against the index variant — tiny work
per clump, BLAS on host.

Spec pinned here (plink1.9/plink2 implementations differ in detail):
  * index candidates: variants present in BOTH the fileset and the
    report with P <= p1, visited in (P ascending, fileset order) order;
    a variant already assigned to a clump cannot start one.
  * membership: same CHROM, |POS - POS_index| <= kb*1000, r² >= r2,
    not yet assigned (each variant belongs to at most one clump),
    regardless of its P — low-significance neighbors still attach, so
    they can never found their own clump (plink1.9 behavior).
  * bins over members (index excluded): NONSIG P > 0.05;
    S0.05 0.01 < P <= 0.05; S0.01 0.001 < P <= 0.01;
    S0.001 0.0001 < P <= 0.001; S0.0001 P <= 0.0001. TOTAL = their sum.
  * SP2 = comma list of member IDs with P <= p2 ("NONE" when empty —
    plink's convention).
  * variants in the report but absent from the fileset (or with
    unparseable P) are skipped and counted in the log.

Output {out} (default {prefix}.clumps), one row per clump in index
order: #CHROM POS ID P TOTAL NONSIG S0.05 S0.01 S0.001 S0.0001 SP2.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

log = get_logger(__name__)


@dataclass
class ClumpResult:
    num_clumps: int
    num_assigned: int  # variants absorbed into clumps (incl. indexes)
    num_candidates: int  # report rows matched to the fileset
    num_unmatched: int  # report rows with no fileset match / bad P
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def _read_assoc(path: str, id_field: str, p_field: str):
    """(ids list, p list) from a TSV association report with a header."""
    with open(path) as fh:
        header = fh.readline()
        if not header:
            raise ValueError(f"clump: {path} is empty")
        cols = header.lstrip("#").rstrip("\n").split("\t")
        try:
            id_j = cols.index(id_field)
            p_j = cols.index(p_field)
        except ValueError:
            raise ValueError(
                f"clump: {path} header lacks {id_field!r}/{p_field!r} "
                f"columns (has: {', '.join(cols)})"
            ) from None
        ids, ps, bad = [], [], 0
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(id_j, p_j):
                bad += 1
                continue
            try:
                p = float(parts[p_j])
            except ValueError:
                bad += 1  # NA rows are unclumpable
                continue
            if not np.isfinite(p):
                bad += 1
                continue
            ids.append(parts[id_j])
            ps.append(p)
    return ids, np.asarray(ps, dtype=np.float64), bad


def clump_pfile(
    pfile_prefix: str,
    clump_file: str,
    out_file: str | None = None,
    p1: float = 1e-4,
    p2: float = 1e-2,
    r2: float = 0.5,
    kb: float = 250.0,
    id_field: str = "ID",
    p_field: str = "P",
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    write: bool = True,
    out=None,
) -> ClumpResult:
    device = resolve_device(device)
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
            var_query, sam_query, pvar, psam, header, records, device
        )
    sam_idx = np.flatnonzero(sam_mask)
    sample_sel = (
        None if len(sam_idx) == header.num_samples else sam_idx
    )

    with timer.stage("read_report"):
        rep_ids, rep_p, n_bad = _read_assoc(clump_file, id_field, p_field)

    with timer.stage("match"):
        ids_all = pvar.get_column_strs("ID")
        row_of = {}
        for row, vid in enumerate(ids_all):
            if var_mask[row] and vid not in row_of:
                row_of[vid] = row
        rows, ps = [], []
        unmatched = n_bad
        seen = set()
        for vid, p in zip(rep_ids, rep_p):
            row = row_of.get(vid)
            if row is None or row in seen:
                unmatched += 1
                continue
            seen.add(row)
            rows.append(row)
            ps.append(p)
        rows = np.asarray(rows, dtype=np.int64)
        ps = np.asarray(ps, dtype=np.float64)
        try:
            pos = pvar.get_column_bytes("POS")[rows].astype(np.int64)
        except (ValueError, OverflowError) as e:
            raise ValueError(f"clump: non-integer POS: {e}") from None
        chroms = pvar.get_column_bytes("CHROM")[rows]
    if unmatched:
        log.warning(
            "clump: %d report row(s) skipped (no fileset/ID match, "
            "duplicate, or unparseable P)", unmatched,
        )

    # per-chromosome position-sorted views for the kb-window lookups
    by_chrom = {}
    for c in np.unique(chroms) if len(chroms) else []:
        k = np.flatnonzero(chroms == c)
        order = np.argsort(pos[k], kind="stable")
        by_chrom[c] = k[order]

    from pgen_tpu_torch.ops.ld import centered_dosage_np
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    window = int(round(kb * 1000))
    assigned = np.zeros(len(rows), dtype=bool)
    idx_order = np.flatnonzero(ps <= p1)
    idx_order = idx_order[np.lexsort((idx_order, ps[idx_order]))]
    clumps = []
    with timer.stage("clump"):
        for i in idx_order:
            if assigned[i]:
                continue
            sibs = by_chrom[chroms[i]]
            lo = np.searchsorted(pos[sibs], pos[i] - window, side="left")
            hi = np.searchsorted(pos[sibs], pos[i] + window, side="right")
            cand = sibs[lo:hi]
            cand = cand[(cand != i) & ~assigned[cand]]
            members = np.zeros(0, dtype=np.int64)
            if len(cand):
                grp = np.concatenate(([i], cand))
                codes = unpack_codes_numpy(records[rows[grp]], header.num_samples)
                if sample_sel is not None:
                    codes = codes[:, sample_sel]
                c, norm = centered_dosage_np(codes)
                num = c[1:] @ c[0]
                den = norm[1:] * norm[0]
                with np.errstate(divide="ignore", invalid="ignore"):
                    rr = np.where(den > 0, (num / np.maximum(den, 1e-300)) ** 2, 0.0)
                members = cand[rr >= r2]
            assigned[i] = True
            assigned[members] = True
            clumps.append((i, members))

    out_path = out_file or f"{pfile_prefix}.clumps"
    if write:
        chrom_strs = pvar.get_column_strs("CHROM")
        with timer.stage("emit"):
            import contextlib
            import sys

            cm = (
                contextlib.nullcontext(out)
                if out is not None
                else (
                    contextlib.nullcontext(sys.stdout)
                    if out_path == "-"
                    else open(out_path, "w")
                )
            )
            with cm as fh:
                fh.write(
                    "#CHROM\tPOS\tID\tP\tTOTAL\tNONSIG\tS0.05\tS0.01\t"
                    "S0.001\tS0.0001\tSP2\n"
                )
                for i, members in clumps:
                    mp = ps[members]
                    bins = [
                        int((mp > 0.05).sum()),
                        int(((mp > 0.01) & (mp <= 0.05)).sum()),
                        int(((mp > 0.001) & (mp <= 0.01)).sum()),
                        int(((mp > 0.0001) & (mp <= 0.001)).sum()),
                        int((mp <= 0.0001).sum()),
                    ]
                    sp2 = [
                        ids_all[int(rows[m])]
                        for m in members[np.argsort(pos[members], kind="stable")]
                        if ps[m] <= p2
                    ]
                    fh.write(
                        f"{chrom_strs[int(rows[i])]}\t{int(pos[i])}\t"
                        f"{ids_all[int(rows[i])]}\t{ps[i]:.6g}\t"
                        f"{len(members)}\t"
                        + "\t".join(str(b) for b in bins)
                        + "\t" + (",".join(sp2) if sp2 else "NONE") + "\n"
                    )
    return ClumpResult(
        num_clumps=len(clumps),
        num_assigned=int(assigned.sum()),
        num_candidates=len(rows),
        num_unmatched=unmatched,
        out_path=None if out is not None or out_path == "-" else out_path,
        timer=timer,
    )
