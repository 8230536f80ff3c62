"""Sample-major genotype export on one GPU: the port of
``pgen_tpu/pipeline/export_raw.py`` (``export A``, ``AD`` and ``ped``).

The kept variants' records go to the device by blocks: K1
``unpack_codes`` decodes each block, ``index_select`` takes the kept
samples and a transpose makes it sample-major on the device; one
(samples, block) copy a block lands in the host's (samples, variants)
code matrix (1 byte a cell, as in pgen_tpu). pgen_tpu decodes and
transposes on the host with numpy. The predicates are the port's
``compute_masks`` (``pipeline/filter.py``), whose genotype counts run on
the device, as ``filter --provider device``'s do. The emission is
pgen_tpu's: the ``.raw`` token gathers and ``\\t.`` rewrite, the ``.map``
f-strings and the ``.ped`` allele-pair gathers, with the token tables and
sample cells of ``pipeline/export_raw_host.py``; output bytes equal
pgen_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.formats.header import read_pgen_header
from pgen_tpu_torch.formats.metadata import read_metadata
from pgen_tpu_torch.ops.unpack import decode_rows
from pgen_tpu_torch.pipeline.export_raw_host import (
    _TOKENS_A,
    _TOKENS_AD,
    ExportResult,
    _ped_prefixes,
    _sample_prefixes,
)
from pgen_tpu_torch.pipeline.filter import compute_masks
from pgen_tpu_torch.utils.timer import StageTimer


def _sample_major(records, var_idx, sam_idx, num_samples: int, dev, block_variants: int,
                  timer) -> np.ndarray:
    """The (kept samples, kept variants) u8 code matrix on the host: each
    block of kept rows decoded (K1), its kept samples taken and transposed
    on ``dev``, then copied into its columns."""
    ns, nv = len(sam_idx), len(var_idx)
    codes_sm = np.empty((ns, nv), dtype=np.uint8)
    cols = None
    if ns != num_samples:
        cols = torch.from_numpy(sam_idx.astype(np.int64)).to(dev)
    blocks = decode_rows(records, var_idx, num_samples, dev, max(int(block_variants), 1),
                         cols, timer)
    for lo, hi, codes in blocks:
        with timer.stage("transpose", (hi - lo) * ns):
            codes_sm[:, lo:hi] = codes.t().contiguous().cpu().numpy()
    return codes_sm


def export_raw(
    pfile_prefix: str,
    fmt: str = "A",
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    block_variants: int = 1 << 13,
    out=None,
) -> ExportResult:
    if fmt not in ("A", "AD"):
        raise ValueError(f"export format must be A or AD, got {fmt!r}")
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

    codes_sm = _sample_major(records, var_idx, sam_idx, header.num_samples, dev,
                             block_variants, timer)

    ids = pvar.get_column_strs("ID")
    alts = pvar.get_column_strs("ALT")
    heads = []
    for v in var_idx:
        v = int(v)
        heads.append(f"{ids[v]}_{alts[v]}")
        if fmt == "AD":
            heads.append(f"{ids[v]}_HET")
    prefixes = _sample_prefixes(psam, sam_idx)
    tokens = _TOKENS_A if fmt == "A" else _TOKENS_AD

    def emit(fh):
        head = "FID\tIID\tPAT\tMAT\tSEX\tPHENOTYPE"
        if heads:
            head += "\t" + "\t".join(heads)
        fh.write((head + "\n").encode())
        for s in range(ns):
            row = tokens[codes_sm[s]].tobytes().replace(b"\t.", b"\tNA")
            fh.write(prefixes[s].encode() + row + b"\n")

    with timer.stage("emit", ns * nv * (2 if fmt == "A" else 4)):
        if out is not None:
            emit(out)
            out_path = None
        else:
            out_path = out_file or f"{pfile_prefix}.raw"
            with open(out_path, "wb") as fh:
                emit(fh)
    return ExportResult(
        fmt=fmt,
        num_variants=nv,
        num_samples=ns,
        out_path=out_path,
        timer=timer,
    )


def export_ped(
    pfile_prefix: str,
    out_prefix: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    device="cuda",
    block_variants: int = 1 << 13,
) -> ExportResult:
    """plink2 `--export ped` analog: writes {out}.ped / {out}.map.

    .map rows: CHROM ID 0 POS (tab-delimited). .ped rows: the six
    classic leading fields then one `\\tA1\\tA2` allele pair per kept
    variant — code 0 -> REF REF, 1 -> REF ALT, 2 -> ALT ALT,
    3 -> 0 0 (2-bit code semantics per pfile.rs:177-183).

    Emission is vectorized along two paths: when every REF/ALT is a
    single base, each variant's four possible pair-cells are a (V, 4)
    uint32 token table and a sample row is ONE elementwise gather
    (tok32[arange(V), codes_row]); with indel alleles the row is built
    by the standard variable-length segment gather
    (arange(total) + repeat(src_start - out_start, lens)) — both are
    O(V) numpy, no per-cell Python."""
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

    codes_sm = _sample_major(records, var_idx, sam_idx, header.num_samples, dev,
                             block_variants, timer)

    out_prefix = out_prefix or pfile_prefix
    if out_prefix.endswith(".ped"):
        out_prefix = out_prefix[: -len(".ped")]

    chroms = pvar.get_column_strs("CHROM")
    poss = pvar.get_column_strs("POS")
    ids = pvar.get_column_strs("ID")
    refs = pvar.get_column_strs("REF")
    alts = pvar.get_column_strs("ALT")

    with timer.stage("map_emit"), open(f"{out_prefix}.map", "w") as fh:
        for v in var_idx:
            v = int(v)
            fh.write(f"{chroms[v]}\t{ids[v]}\t0\t{poss[v]}\n")

    kept_refs = [refs[int(v)] for v in var_idx]
    kept_alts = [alts[int(v)] for v in var_idx]
    bad = [i for i, a in enumerate(kept_alts) if "," in a]
    if bad:
        raise ValueError(
            f"export ped: {len(bad)} kept variant(s) are multiallelic "
            f"(first: ID {ids[int(var_idx[bad[0]])]} ALT "
            f"{kept_alts[bad[0]]!r}); .ped cells hold one allele pair — "
            "split or filter them first (plink2 --export ped errors too)"
        )
    single = all(len(r) == 1 for r in kept_refs) and all(
        len(a) == 1 for a in kept_alts
    )
    prefixes = _ped_prefixes(psam, sam_idx)

    with timer.stage("ped_emit", ns * nv * 4), open(
        f"{out_prefix}.ped", "wb"
    ) as fh:
        if single and nv:
            r8 = np.frombuffer(
                "".join(kept_refs).encode(), dtype=np.uint8
            )
            a8 = np.frombuffer(
                "".join(kept_alts).encode(), dtype=np.uint8
            )
            tok = np.empty((nv, 4, 4), dtype=np.uint8)
            tok[:, :, 0] = ord("\t")
            tok[:, :, 2] = ord("\t")
            tok[:, 0, 1] = r8
            tok[:, 0, 3] = r8
            tok[:, 1, 1] = r8
            tok[:, 1, 3] = a8
            tok[:, 2, 1] = a8
            tok[:, 2, 3] = a8
            tok[:, 3, 1] = ord("0")
            tok[:, 3, 3] = ord("0")
            tok32 = tok.reshape(nv, 16).view(np.uint32)  # (nv, 4) LE words
            vix = np.arange(nv)
            for s in range(ns):
                row = tok32[vix, codes_sm[s]]
                fh.write(prefixes[s].encode() + row.tobytes() + b"\n")
        else:
            toks = []
            for r, a in zip(kept_refs, kept_alts):
                toks += [f"\t{r}\t{r}", f"\t{r}\t{a}", f"\t{a}\t{a}", "\t0\t0"]
            buf = "".join(toks).encode()
            buf8 = np.frombuffer(buf, dtype=np.uint8)
            lens = np.array([len(t) for t in toks], dtype=np.int64)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            base = 4 * np.arange(nv, dtype=np.int64)
            for s in range(ns):
                tok_idx = base + codes_sm[s]
                ls = lens[tok_idx]
                ends = np.cumsum(ls)
                out_starts = ends - ls
                src = np.repeat(starts[tok_idx] - out_starts, ls) + np.arange(
                    ends[-1] if len(ends) else 0
                )
                fh.write(prefixes[s].encode() + buf8[src].tobytes() + b"\n")

    return ExportResult(
        fmt="ped",
        num_variants=nv,
        num_samples=ns,
        out_path=f"{out_prefix}.ped",
        timer=timer,
    )
