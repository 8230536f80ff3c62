"""bcftools-style region specs desugared into include-expressions.

`--regions "19:200000-300000,20,X:1000-"` restricts `filter`/`query`/
`stats` to the named spans. Rather than adding a second mask plumbing
path, a spec compiles to an expression in the engine's own language and
is AND-ed with any `--include-var` — so regions work identically across
every pipeline (single-process, --workers, --shards, the device mesh)
and stay byte-exact by construction.

Grammar per comma-separated token (1-based, inclusive, as bcftools -r):

  CHROM            the whole contig
  CHROM:POS        exactly that position
  CHROM:BEG-END    the closed span
  CHROM:BEG-       from BEG to the end of the contig

The reference has no region support (its queries are full metadata scans,
pgen-rs/src/pfile.rs:78-102); this rides the vectorized `num()`
comparison path.

Copied from ``pgen_tpu/query/regions.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations


class RegionSpecError(ValueError):
    """A --regions spec could not be parsed."""


def _chrom_literal(chrom: str, spec: str) -> str:
    if not chrom or any(c in chrom for c in '",\\'):
        raise RegionSpecError(f"bad region {spec!r}: invalid contig name {chrom!r}")
    return f'CHROM == "{chrom}"'


def _pos_int(tok: str, spec: str) -> int:
    # NB: no thousands-separator support — a comma inside a position can
    # never reach here (the spec splits on ',' first), so accepting one
    # would only mask misparsed specs
    if not tok.isdigit():
        raise RegionSpecError(f"bad region {spec!r}: position {tok!r} is not a number")
    return int(tok)


def _token_term(tok: str) -> str:
    """One region token (CHROM / CHROM:POS / CHROM:BEG-END / CHROM:BEG-)
    -> one include-expression term."""
    if ":" not in tok:
        return _chrom_literal(tok, tok)
    chrom, _, span = tok.rpartition(":")
    c = _chrom_literal(chrom, tok)
    # contig names may themselves contain ':' (GRCh38 HLA alts like
    # "HLA-DRB1*15:01:01"); bcftools resolves the ambiguity against the
    # header's contig list, which a context-free desugar cannot see —
    # so ALSO match the whole token as an exact contig name (one extra
    # vectorized equality; never matches unless such a contig exists)
    whole = _chrom_literal(tok, tok)
    if "-" in span:
        beg_s, _, end_s = span.partition("-")
        beg = _pos_int(beg_s, tok)
        if end_s:
            end = _pos_int(end_s, tok)
            if end < beg:
                raise RegionSpecError(f"bad region {tok!r}: end < start")
            return f"({whole} || ({c} && num(POS) >= {beg} && num(POS) <= {end}))"
        return f"({whole} || ({c} && num(POS) >= {beg}))"
    pos = _pos_int(span, tok)
    return f"({whole} || ({c} && num(POS) == {pos}))"


def regions_to_expr(spec: str) -> str:
    """Compile a region spec to an include-expression string."""
    terms = []
    for raw in spec.split(","):
        tok = raw.strip()
        if tok:
            terms.append(_token_term(tok))
    if not terms:
        raise RegionSpecError(f"empty region spec {spec!r}")
    return " || ".join(terms)


def regions_file_to_expr(path: str) -> str:
    """Compile a regions FILE (bcftools -R) to one include-expression.

    Formats, per line (blank and `#` lines skipped; `.gz` transparently
    decompressed):
      - `NAME.bed[.gz]`: BED — CHROM, BEG, END tab columns, 0-based
        half-open (extra columns and track/browser lines ignored);
      - otherwise tab-delimited 1-based inclusive positions: `CHROM POS`
        or `CHROM BEG END`; a single-column line is a region *spec* token
        (CHROM or CHROM:BEG-END, same grammar as -r).

    Exact single positions group per contig into ONE vectorized
    `in_list(num(POS), "p1,p2,…")` membership sweep, so a thousand-line
    positions file stays O(few) column passes instead of a
    thousand-deep `||` chain; spans stay explicit range terms.
    """
    base = path[:-3] if path.endswith(".gz") else path
    is_bed = base.endswith(".bed")
    if path.endswith(".gz"):
        import gzip

        fh = gzip.open(path, "rt")
    else:
        fh = open(path)
    span_terms: list = []
    exact: dict = {}  # chrom -> [pos, ...] in first-seen order
    whole: list = []  # whole-contig names, deduped, order kept
    with fh:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            if is_bed and (line.startswith("track") or line.startswith("browser")):
                continue
            fields = line.split("\t")
            if len(fields) == 1:
                fields = line.split()
            where = f"{path}:{lineno}"
            if len(fields) == 1:
                tok = fields[0]
                if is_bed:
                    raise RegionSpecError(f"{where}: malformed BED line {line!r}")
                if ":" in tok:
                    span_terms.append(_token_term(tok))
                elif tok not in whole:
                    _chrom_literal(tok, f"{where}: {tok!r}")  # validate
                    whole.append(tok)
                continue
            chrom = fields[0]
            _chrom_literal(chrom, f"{where}: {line!r}")
            if is_bed or len(fields) >= 3:
                if len(fields) < 3:
                    raise RegionSpecError(f"{where}: BED needs 3 columns, got {len(fields)}")
                beg = _pos_int(fields[1], f"{where}: {line!r}")
                end = _pos_int(fields[2], f"{where}: {line!r}")
                if is_bed:
                    beg += 1  # 0-based half-open -> 1-based inclusive
                if end < beg:
                    if is_bed and end == beg - 1:
                        continue  # empty BED interval matches nothing
                    raise RegionSpecError(f"{where}: end < start in {line!r}")
                if beg == end:
                    exact.setdefault(chrom, []).append(beg)
                else:
                    span_terms.append(
                        f'(CHROM == "{chrom}" && num(POS) >= {beg} && num(POS) <= {end})'
                    )
            else:  # CHROM POS
                exact.setdefault(chrom, []).append(
                    _pos_int(fields[1], f"{where}: {line!r}")
                )
    terms = []
    if whole:
        if len(whole) == 1:
            terms.append(_chrom_literal(whole[0], whole[0]))
        else:
            terms.append(f'in_list(CHROM, "{",".join(whole)}")')
    for chrom, positions in exact.items():
        uniq = list(dict.fromkeys(positions))
        c = _chrom_literal(chrom, chrom)
        if len(uniq) == 1:
            terms.append(f"({c} && num(POS) == {uniq[0]})")
        else:
            lst = ",".join(str(p) for p in uniq)
            terms.append(f'({c} && in_list(num(POS), "{lst}"))')
    terms.extend(span_terms)
    if not terms:
        raise RegionSpecError(f"{path}: no regions found")
    return " || ".join(terms)


def apply_regions(
    var_query: str | None,
    regions: str | None,
    regions_file: str | None = None,
) -> str | None:
    """AND a --regions spec and/or --regions-file into an (optional)
    --include-var expression."""
    if regions and regions_file:
        raise RegionSpecError("pass --regions or --regions-file, not both")
    if regions:
        expr = regions_to_expr(regions)
    elif regions_file:
        expr = regions_file_to_expr(regions_file)
    else:
        return var_query
    if var_query is None:
        return expr
    return f"({expr}) && ({var_query})"
