"""chr22-scale fixture filesets, seeded: the port's copy of
``tools/make_fixtures.py``'s ``ensure_chr22`` and the helpers it calls, so
that ``chip_smoke.py`` makes its filesets with the port alone.

Only two things differ from the source. ``out_dir`` has no default (the
source's is its ``data/`` directory), and the ``.psam`` is always
synthesized (``per{i}\\tNA`` rows): the source copies the reference tool's
own basic1 ``.psam`` instead when that is installed and
``num_samples == 2504``. Without it, the two give the same bytes
(``tests/test_torch_standalone.py``).

Run as a script it writes one fileset and prints its prefix:

    python -m pgen_tpu_torch.formats.fixtures OUT_DIR NUM_VARIANTS [--uniform-bytes]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from pgen_tpu_torch.formats.writer import write_pgen_packed

_GT_PROBS = (0.55, 0.25, 0.17, 0.03)  # hom-ref, het, hom-alt, missing


def _random_packed_bytes(rng, num_variants: int, num_samples: int) -> np.ndarray:
    """Realistic-frequency packed records sampled at BYTE level.

    The distribution of a packed byte is the product of 4 iid 2-bit code
    draws, so sampling bytes from the 256-entry CDF is ~10x faster than
    sampling codes and packing. Tail-byte padding bits carry random codes
    (beyond num_samples, never read)."""
    rec = (2 * num_samples + 7) // 8
    p_code = np.asarray(_GT_PROBS)
    idx = np.arange(256)
    p_byte = np.ones(256)
    for k in range(4):
        p_byte *= p_code[(idx >> (2 * k)) & 3]
    cdf = np.cumsum(p_byte)
    cdf[-1] = 1.0
    packed = np.empty((num_variants, rec), dtype=np.uint8)
    chunk = max(1, (1 << 26) // max(rec, 1))
    for lo in range(0, num_variants, chunk):
        hi = min(lo + chunk, num_variants)
        u = rng.random((hi - lo) * rec)
        packed[lo:hi] = (
            np.searchsorted(cdf, u, side="right")
            .astype(np.uint8)
            .reshape(hi - lo, rec)
        )
    return packed


def _write_pvar(path: Path, num_variants: int, chrom: str, seed: int, info: bool = True):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.integers(10, 500, size=num_variants)) + 10_000
    bases = np.array(list("ACGT"))
    ref = bases[rng.integers(0, 4, num_variants)]
    alt_off = rng.integers(1, 4, num_variants)
    alt = bases[(np.char.find("ACGT", ref.astype("U1")) + alt_off) % 4]
    af = rng.random(num_variants)
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom}>\n")
        f.write('##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        rows = []
        for i in range(num_variants):
            info_col = f"AF={af[i]:.6f}" if info else "."
            rows.append(
                f"{chrom}\t{pos[i]}\tsnp{i}\t{ref[i]}\t{alt[i]}\t100\tPASS\t{info_col}\n"
            )
            if len(rows) >= 100_000:
                f.write("".join(rows))
                rows = []
        f.write("".join(rows))


def _write_psam(path: Path, num_samples: int):
    with open(path, "w") as f:
        f.write("#IID\tSEX\n")
        f.write("".join(f"per{i}\tNA\n" for i in range(num_samples)))


def ensure_chr22(
    out_dir: Path,
    num_variants: int = 1_103_547,
    num_samples: int = 2504,
    seed: int = 22,
    uniform_bytes: bool = False,
) -> Path:
    """chr22-scale fixture (1000 Genomes chr22's shape: 2504 samples,
    1,103,547 variants), written under ``out_dir/chr22/`` and reused while
    its parameters stay the same; returns the prefix.

    uniform_bytes=True draws packed record bytes uniformly (fast generation;
    throughput-equivalent workload) instead of realistic genotype
    frequencies.
    """
    d = out_dir / "chr22"
    d.mkdir(parents=True, exist_ok=True)
    prefix = d / "chr22"
    pvar, psam, pgen = (Path(f"{prefix}.{e}") for e in ("pvar", "psam", "pgen"))
    # invalidate a cached fixture generated with different parameters
    meta = d / "meta.json"
    params = {
        "num_variants": num_variants,
        "num_samples": num_samples,
        "seed": seed,
        "uniform_bytes": uniform_bytes,
    }
    if meta.exists():
        try:
            if json.loads(meta.read_text()) != params:
                for p in (pvar, psam, pgen):
                    p.unlink(missing_ok=True)
        except ValueError:
            pass
    meta.write_text(json.dumps(params))
    if not psam.exists():
        _write_psam(psam, num_samples)
    if not pvar.exists():
        _write_pvar(pvar, num_variants, "22", seed)
    if not pgen.exists():
        rng = np.random.default_rng(seed)
        if uniform_bytes:
            rec = (2 * num_samples + 7) // 8
            packed = rng.integers(0, 256, size=(num_variants, rec), dtype=np.uint8)
        else:
            packed = _random_packed_bytes(rng, num_variants, num_samples)
        write_pgen_packed(pgen, packed, num_samples)
    return prefix


if __name__ == "__main__":
    out, n = Path(sys.argv[1]), int(sys.argv[2])
    print(ensure_chr22(out, num_variants=n, uniform_bytes="--uniform-bytes" in sys.argv[3:]))
