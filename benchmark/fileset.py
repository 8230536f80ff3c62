"""Seeded chr22-shape filesets: a frozen copy of
``pgen_tpu_torch/formats/fixtures.py`` (``ensure_chr22`` with
``uniform_bytes=True``, ``_write_pvar``, ``_write_psam``) and of
``formats/writer.py``'s ``write_pgen_packed``, so that a later change to the
program cannot change the benchmark's inputs.

What differs from the source: the fileset is written once into a fresh
directory (no ``meta.json`` cache); the record bytes are drawn on the card
by a torch.Generator in one call (``make_records``), and the ``.pvar`` rows
are made in bulk (``_text_rows``), both so that set-up stays short; each
use of the seed draws from a stream of its own; and seeded related pairs
can be planted (``make_records``).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

PGEN_MAGIC = b"\x6c\x1b"
FIXED_WIDTH_STORAGE_MODE = 0x02
MODE2_FORMAT_BYTE = 0x40
HEADER_SIZE = 12


def record_size(num_samples: int) -> int:
    """ceil(2 * num_samples / 8) bytes a variant record."""
    return (2 * num_samples + 7) // 8


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named use of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream.encode()])


def _text_rows(fields: list, n: int) -> np.ndarray:
    """n text rows as one uint8 buffer, each the concatenation of
    ``fields``: bytes (the same in every row), a (n,) uint8 array (one byte a
    row), a (n,) non-negative int64 array (decimal) or (array, width) (zero-
    padded to width digits). Each row is laid out in a fixed-width matrix,
    numbers right-aligned in slots of their widest, and the unused slot
    bytes (0) are dropped at the end."""
    cols = []
    for f in fields:
        if isinstance(f, bytes):
            cols.append(np.broadcast_to(np.frombuffer(f, dtype=np.uint8), (n, len(f))))
            continue
        if not isinstance(f, tuple) and f.dtype == np.uint8:
            cols.append(f[:, None])
            continue
        x, pad = f if isinstance(f, tuple) else (f, 1)
        width = max(pad, len(str(int(x.max()))) if n else 1)
        slot = np.zeros((n, width), dtype=np.uint8)
        rest = x.copy()
        for j in range(width):
            keep = (rest > 0) | (j < pad)
            slot[:, width - 1 - j] = np.where(keep, rest % 10 + 48, 0)
            rest //= 10
        cols.append(slot)
    mat = np.concatenate(cols, axis=1)
    return mat[mat != 0]


def _write_pvar(path: Path, num_variants: int, chrom: str, seed):
    """The source's rows, ``{chrom} POS snp{i} REF ALT 100 PASS AF=%.6f``,
    made in bulk: AF is af rounded to six decimals by integer arithmetic."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.integers(10, 500, size=num_variants)) + 10_000
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_i = rng.integers(0, 4, num_variants)
    alt_off = rng.integers(1, 4, num_variants)
    ref, alt = bases[ref_i], bases[(ref_i + alt_off) % 4]
    af = np.rint(rng.random(num_variants) * 1e6).astype(np.int64)
    rows = _text_rows([chrom.encode() + b"\t", pos, b"\tsnp", np.arange(num_variants), b"\t",
                       ref, b"\t", alt, b"\t100\tPASS\tAF=", af // 1_000_000, b".",
                       (af % 1_000_000, 6), b"\n"], num_variants)
    with open(path, "wb") as f:
        f.write(b"##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom}>\n".encode())
        f.write(b'##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n')
        f.write(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.write(memoryview(rows))


def _write_psam(path: Path, num_samples: int):
    with open(path, "w") as f:
        f.write("#IID\tSEX\n")
        f.write("".join(f"per{i}\tNA\n" for i in range(num_samples)))


def write_pgen_packed(path: Path, packed: np.ndarray, num_samples: int) -> None:
    """A mode-0x02 .pgen of already-packed (variants, record size) records."""
    if packed.dtype != np.uint8 or packed.shape[1] != record_size(num_samples):
        raise ValueError(f"records must be uint8 (V, {record_size(num_samples)})")
    with open(path, "wb") as f:
        f.write(PGEN_MAGIC)
        f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
        f.write(struct.pack("<II", packed.shape[0], num_samples))
        f.write(bytes([MODE2_FORMAT_BYTE]))
        f.write(memoryview(np.ascontiguousarray(packed)).cast("B"))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named use of ``seed``, for a torch.Generator."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *stream.encode()])
               .generate_state(1, np.uint64)[0] >> 1)


def make_records(num_variants: int, num_samples: int, seed: int, device,
                 plant_pairs: int = 0, plant_redraw: float = 0.0) -> np.ndarray:
    """(V, record size) uniform record bytes drawn on ``device`` from
    ``seed`` in one call, with ``plant_pairs`` related pairs; on the host.

    Each planted pair (a, b), disjoint seeded samples, makes b's calls a's,
    then a ``plant_redraw`` share of them (seeded rows) uniform codes again,
    so that a kinship table has related pairs to report."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, "pgen"))
    packed = torch.randint(0, 256, (num_variants, record_size(num_samples)), dtype=torch.uint8,
                           device=device, generator=g)
    pairs = rng_for(seed, "relatives").choice(num_samples, size=2 * plant_pairs, replace=False)
    for a, b in pairs.reshape(-1, 2).tolist():
        codes = (packed[:, a >> 2] >> (2 * (a & 3))) & 3
        redo = torch.rand(num_variants, device=device, generator=g) < plant_redraw
        fresh = torch.randint(0, 4, (num_variants,), dtype=torch.uint8, device=device, generator=g)
        codes = torch.where(redo, fresh, codes)
        shift = 2 * (b & 3)
        col = packed[:, b >> 2] & (255 ^ (3 << shift))
        packed[:, b >> 2] = col | (codes << shift)
    return packed.cpu().numpy()


def make_fileset(out_dir: Path, num_variants: int, num_samples: int, seed: int, device,
                 plant_pairs: int = 0, plant_redraw: float = 0.0) -> Path:
    """chr22-shape fileset under ``out_dir``, from ``seed``: ``ensure_chr22``'s
    ``.psam`` and ``.pvar``, uniform record bytes (``make_records``);
    returns the prefix."""
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = out_dir / "chr22"
    _write_psam(Path(f"{prefix}.psam"), num_samples)
    _write_pvar(Path(f"{prefix}.pvar"), num_variants, "22", rng_for(seed, "pvar"))
    packed = make_records(num_variants, num_samples, seed, device, plant_pairs, plant_redraw)
    write_pgen_packed(Path(f"{prefix}.pgen"), packed, num_samples)
    # written back now, in set-up, rather than by the kernel during the window
    for ext in ("psam", "pvar", "pgen"):
        fd = os.open(f"{prefix}.{ext}", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return prefix
