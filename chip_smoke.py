#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pgen_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing its own lines:

  1 device   CUDA present and compute capability 9.0; the card's name and
             power limit as nvidia-smi reports them
  2 build    nvcc build of pgen_tpu_torch/csrc from this checkout
  3 kernels  K1-K7 against their plain PyTorch versions on the card
             (torch.equal) at widths 2504, 2503, 5 and 1 samples (K5 at K = 2,
             1,001 and all samples permuted; K6 at R = 626 and 2 with 65,536
             variants); kernel and plain times at the paths' block shape,
             CUDA events, median of 10
  4 filter   the port's CLI (pgen_tpu_torch.cli.main --device cuda) on
             chr22-scale fixtures made by tools/make_fixtures.py in a
             subprocess: full 1000 Genomes chr22 (1,103,547 variants x 2504
             samples) keep-two and region keep-two, and a 140,001-variant
             keep-all as plain VCF and as .vcf.gz with a tabix index. Each
             output's GT text is checked with numpy against the .pgen bytes
             (the .gz after gunzip, against the plain keep-all), then its
             sha256 (and the .tbi's) against the same CLI with --device cpu,
             whose plain PyTorch text the CPU tests hold byte for byte against
             pgen_tpu's providers. K2 and K3 must have launched.
  5 pgen out the port's CLI filter --out-format pgen --keep FILE (1,001
             samples drawn with the seed) on the full chr22 fixture: the
             .pgen body equal to a numpy re-pack of the fixture's records,
             the .pgen/.pvar/.psam sha256-equal to --device cpu. K5 must have
             launched.
  6 import   the port's CLI import of a keep-all VCF of a 50,001-variant
             fixture, written by the port's own filter: the .pgen body equal
             to the fixture's records (2504 % 4 == 0: no pad bits), the three
             files sha256-equal to --device cpu. K4 must have launched.

The script imports no jax and nothing of pgen_tpu itself; the port uses
pgen_tpu's jax-free host layers, and a last check fails if jax was loaded.

Each path's launch counts are set to 0 just before its cuda run and read
just after. Then one JSON line of the seven kernels (launches summed over
phases 4-6), and as the last line
{"ok": true, "device": {...}}. Nothing is caught: any failed phase exits
non-zero before the result lines, as does a machine without CUDA or a
directory without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2504
BLOCK_ROWS = 1 << 16  # pgen_tpu.pipeline.filter.DEFAULT_BLOCK_VARIANTS
WIDTHS = (2504, 2503, 5, 1)
CHR22_VARIANTS = 1_103_547
RAGGED_VARIANTS = 140_001
IMPORT_VARIANTS = 50_001
KEEP_SAMPLES = 1001  # odd, so the last byte of each re-packed record has pad bits
SOURCE = "pgen_tpu_torch/csrc/genotype.cu"
# each kernel's wrapper -> the Pallas kernel (or XLA code) it replaces
KERNELS = {
    "unpack_codes": "pgen_tpu/ops/unpack.py:62",
    "genotype_text": "pgen_tpu/ops/gt_text.py:45",
    "subset_text_from_packed": "pgen_tpu/ops/gt_text.py:109",
    "pack_codes": "pgen_tpu/ops/pack.py:28",
    "subset_repack": "pgen_tpu/pipeline/pgen_out.py:47",
    "genotype_text_transposed": "tools/fused_text_lab.py:37",
    "genotype_text_from_codes": "pgen_tpu/ops/gt_text.py:45",
    "gt_counts_device": "pgen_tpu/ops/gt_stats.py:65",
    "sample_counts_device": "pgen_tpu/ops/gt_stats.py:216",
}


def _time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn in ms, one CUDA event pair per call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (sm_90a), {name} has {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(
        f"[1 device] {name}, capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:"
    )
    print(smi[0])
    return name


def phase_build() -> float:
    from pgen_tpu_torch import kernels

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    seconds = time.perf_counter() - t0
    print(f"[2 build] {seconds:.3f} s: {so.relative_to(ROOT)} (nvcc {' '.join(kernels.NVCC_FLAGS)})")
    return seconds


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel errors and
    times at the paths' block shapes (2504 samples, 65,536 rows)."""
    import torch

    from pgen_tpu_torch.ops.gt_text import (
        genotype_text,
        genotype_text_from_codes,
        genotype_text_plain,
        genotype_text_transposed,
        genotype_text_transposed_plain,
        subset_text_from_packed,
        subset_text_plain,
        text_from_codes_plain,
    )
    from pgen_tpu_torch.ops.gt_stats import (
        gt_counts_device,
        gt_counts_plain,
        sample_counts_device,
        sample_counts_plain,
    )
    from pgen_tpu_torch.ops.pack import (
        pack_codes,
        pack_codes_plain,
        subset_repack,
        subset_repack_plain,
    )
    from pgen_tpu_torch.ops.unpack import unpack_codes, unpack_codes_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {name: 0 for name in KERNELS}
    for s in WIDTHS:
        rec = (s + 3) // 4
        # 65,536 random rows, then 256 rows that each repeat one byte value,
        # so every byte value sits at every position, pad bits included
        packed = torch.randint(0, 256, (BLOCK_ROWS + 256, rec), dtype=torch.uint8,
                               device=dev, generator=gen)
        packed[BLOCK_ROWS:] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
        # codes of any byte value (the pack masks each to 2 bits), then 256
        # rows in which column j of row r holds (r + j) % 256
        codes = torch.randint(0, 256, (BLOCK_ROWS + 256, s), dtype=torch.uint8,
                              device=dev, generator=gen)
        codes[BLOCK_ROWS:] = ((torch.arange(256, device=dev)[:, None]
                               + torch.arange(s, device=dev)[None, :]) % 256).to(torch.uint8)
        # (R, 65,536) records, transposed; the last 256 columns repeat one byte
        packed_t = packed[256:].T.contiguous()
        pairs = [
            ("unpack_codes", unpack_codes(packed, s), unpack_codes_plain(packed, s)),
            ("genotype_text", genotype_text(packed, s), genotype_text_plain(packed, s)),
            ("pack_codes", pack_codes(codes), pack_codes_plain(codes)),
            ("genotype_text_transposed", genotype_text_transposed(packed_t),
             genotype_text_transposed_plain(packed_t)),
            ("genotype_text_from_codes", genotype_text_from_codes(codes),
             text_from_codes_plain(codes)),
            ("gt_counts_device", gt_counts_device(packed, s), gt_counts_plain(packed, s)),
            ("sample_counts_device", sample_counts_device(packed, s),
             sample_counts_plain(packed, s)),
        ]
        for k in sorted({min(2, s), min(1000, s)}):
            sel = torch.randperm(s, generator=gen, device=dev)[:k].to(torch.int32)
            pairs.append((
                "subset_text_from_packed",
                subset_text_from_packed(packed, sel),
                subset_text_plain(packed, sel),
            ))
        # K = 2, 1,001 and all s in a random order
        for k in sorted({min(2, s), min(KEEP_SAMPLES, s), s}):
            sel = torch.randperm(s, generator=gen, device=dev)[:k].to(torch.int32)
            pairs.append(("subset_repack", subset_repack(packed, sel),
                          subset_repack_plain(packed, sel)))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            e = _max_abs_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version at S={s}: max |err| {e}")
            err[name] = max(err[name], e)
        n_k3 = sum(name == "subset_text_from_packed" for name, _, _ in pairs)
        n_k5 = sum(name == "subset_repack" for name, _, _ in pairs)
        print(f"[3 kernels] S={s} (R={rec}, V={BLOCK_ROWS + 256}; K6 at ({rec}, {BLOCK_ROWS})): "
              f"K1, K2, K3 x{n_k3}, K4, K5 x{n_k5}, K6, K7, K8, K9 equal to their plain versions")

    s = WIDTHS[0]
    rec = (s + 3) // 4
    packed = torch.randint(0, 256, (BLOCK_ROWS, rec), dtype=torch.uint8, device=dev, generator=gen)
    codes = torch.randint(0, 4, (BLOCK_ROWS, s), dtype=torch.uint8, device=dev, generator=gen)
    packed_t = packed.T.contiguous()
    sel2 = torch.randperm(s, generator=gen, device=dev)[:2].to(torch.int32)
    sel1000 = torch.randperm(s, generator=gen, device=dev)[:1000].to(torch.int32)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values.to(torch.int32)
    keep_rec = (KEEP_SAMPLES + 3) // 4
    cases = {
        "unpack_codes": (lambda: unpack_codes(packed, s), lambda: unpack_codes_plain(packed, s),
                         packed.numel() * 5),
        "genotype_text": (lambda: genotype_text(packed, s), lambda: genotype_text_plain(packed, s),
                          packed.numel() + BLOCK_ROWS * 4 * s),
        "subset_text_from_packed": (lambda: subset_text_from_packed(packed, sel2),
                                    lambda: subset_text_plain(packed, sel2),
                                    BLOCK_ROWS * 2 * 5),
        "subset_text_from_packed K=1000": (lambda: subset_text_from_packed(packed, sel1000),
                                           lambda: subset_text_plain(packed, sel1000),
                                           BLOCK_ROWS * 1000 * 5),
        "pack_codes": (lambda: pack_codes(codes), lambda: pack_codes_plain(codes),
                       codes.numel() + packed.numel()),
        "subset_repack": (lambda: subset_repack(packed, keep),
                          lambda: subset_repack_plain(packed, keep),
                          BLOCK_ROWS * (KEEP_SAMPLES + keep_rec)),
        "subset_repack K=2": (lambda: subset_repack(packed, sel2),
                              lambda: subset_repack_plain(packed, sel2), BLOCK_ROWS * 3),
        "genotype_text_transposed": (lambda: genotype_text_transposed(packed_t),
                                     lambda: genotype_text_transposed_plain(packed_t),
                                     packed.numel() * 17),
        "genotype_text_from_codes": (lambda: genotype_text_from_codes(codes),
                                     lambda: text_from_codes_plain(codes), codes.numel() * 5),
        "gt_counts_device": (lambda: gt_counts_device(packed, s),
                             lambda: gt_counts_plain(packed, s), packed.numel() + BLOCK_ROWS * 16),
        "sample_counts_device": (lambda: sample_counts_device(packed, s),
                                 lambda: sample_counts_plain(packed, s), packed.numel() + s * 16),
    }
    times = {}
    for name, (kernel, plain, nbytes) in cases.items():
        # alternate plain, kernel, kernel, plain so drift hits both alike
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
        times[name] = (ms, plain_ms)
        shape = f"({rec}, {BLOCK_ROWS})" if name == "genotype_text_transposed" else f"({BLOCK_ROWS}, {rec})"
        print(f"[3 kernels] {name} at {shape} S={s}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB moved), "
              f"plain {plain_ms:.4f} ms")
    return {"err": err, "times": times}


def _check_gt_text(vcf: Path, packed, rows, sample_idx) -> None:
    """Independent check of a plain VCF output against the .pgen bytes: one
    body row per kept variant, and each row's last 4K bytes are the GT text
    of the kept samples, decoded here with numpy (LSB-first 2-bit codes;
    0 -> \\t0/0, 1 -> \\t0/1, 2 -> \\t1/1, 3 -> \\t./.), sharing no code with
    the port."""
    import numpy as np

    buf = np.fromfile(vcf, dtype=np.uint8)
    head = bytes(buf[: 1 << 20])
    body_at = head.index(b"\n#CHROM")
    body_at = head.index(b"\n", body_at + 1) + 1
    ends = np.flatnonzero(buf[body_at:] == ord("\n")) + body_at
    if len(ends) != len(rows):
        raise AssertionError(f"{vcf.name}: {len(ends)} body rows, expected {len(rows)}")
    table = np.frombuffer(b"\t0/0\t0/1\t1/1\t./.", dtype=np.uint8).reshape(4, 4)
    gt_len = 4 * len(sample_idx)
    step = max(1, (1 << 24) // gt_len)
    byte_of, shift = sample_idx >> 2, (2 * (sample_idx & 3)).astype(np.uint8)
    for lo in range(0, len(rows), step):
        hi = min(lo + step, len(rows))
        codes = (packed[rows[lo:hi, None], byte_of] >> shift) & 3
        want = table[codes].reshape(hi - lo, gt_len)
        got = buf[ends[lo:hi, None] - gt_len + np.arange(gt_len)]
        if not np.array_equal(got, want):
            bad = lo + int(np.flatnonzero((got != want).any(axis=1))[0])
            raise AssertionError(f"{vcf.name}: GT text of body row {bad} differs from the .pgen")


def _port_cli(args: list, out: Path, device: str) -> tuple:
    """One run of the port's CLI (``args`` is the subcommand and its input,
    then its flags) with ``-o out``; returns its wall seconds and its stderr
    (the --stats report), which it prints for the cuda run."""
    from pgen_tpu_torch.cli import main as port_main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = port_main([*map(str, args), "-o", str(out), "--device", device, "--stats"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"port CLI {args[0]} on {device} returned {rc}\n{err.getvalue()}")
    if device == "cuda":
        for line in err.getvalue().strip().splitlines():
            print(f"    {line}")
    return seconds, err.getvalue()


def _port_filter(prefix, argv, out: Path, device: str) -> float:
    """Wall seconds of one port filter."""
    return _port_cli(["filter", prefix, *argv], out, device)[0]


def _gunzip_sha256(path: Path) -> str:
    import gzip

    h = hashlib.sha256()
    with gzip.open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def _read_fileset(prefix: Path):
    """IIDs, POS, ALT and the packed records of a mode-0x02 fileset, read
    with numpy alone (the .pgen header is 12 bytes)."""
    import numpy as np

    lines = Path(f"{prefix}.psam").read_text().splitlines()
    col = [c.lstrip("#") for c in lines[0].split("\t")].index("IID")
    iids = [line.split("\t")[col] for line in lines[1:] if line]
    body = [ln for ln in Path(f"{prefix}.pvar").read_bytes().split(b"\n")
            if ln and not ln.startswith(b"#")]
    fields = [ln.split(b"\t", 5) for ln in body]
    pos = np.array([int(f[1]) for f in fields], dtype=np.int64)
    alt = np.array([f[4] for f in fields])
    rec = (2 * len(iids) + 7) // 8
    packed = np.memmap(f"{prefix}.pgen", dtype=np.uint8, mode="r", offset=12,
                       shape=(len(pos), rec))
    return iids, pos, alt, packed


def _wrappers() -> dict:
    """Each kernel's wrapper by name; its ``launches`` counts its kernel's
    launches."""
    from pgen_tpu_torch.ops import gt_stats, gt_text, pack, unpack

    mods = (unpack, gt_text, pack, gt_stats)
    return {name: next(getattr(m, name) for m in mods if hasattr(m, name)) for name in KERNELS}


def _reset_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def make_fixtures(tmp: Path) -> dict:
    """The chr22-scale filesets, made by tools/make_fixtures.py in a
    subprocess: full, ragged (phase 4) and import (phase 6)."""
    t0 = time.perf_counter()
    make = (
        "import sys; from pathlib import Path; sys.path.insert(0, 'tools')\n"
        "from make_fixtures import ensure_chr22\n"
        "for sub, n in zip(('full', 'ragged', 'import'), sys.argv[2:]):\n"
        "    print(ensure_chr22(out_dir=Path(sys.argv[1]) / sub, num_variants=int(n),"
        " uniform_bytes=True))\n"
    )
    made = subprocess.run(
        [sys.executable, "-c", make, str(tmp), str(CHR22_VARIANTS), str(RAGGED_VARIANTS),
         str(IMPORT_VARIANTS)],
        cwd=ROOT, capture_output=True, text=True, check=True,
    ).stdout.split()
    full, ragged, imp = (Path(m) for m in made)
    print(f"[4 filter] fixtures in {time.perf_counter() - t0:.1f} s: "
          f"{CHR22_VARIANTS}, {RAGGED_VARIANTS} and {IMPORT_VARIANTS} variants x 2504 samples, "
          f"{Path(f'{full}.pgen').stat().st_size} B .pgen")
    return {"full": full, "ragged": ragged, "import": imp}


def phase_filter(tmp: Path, full: Path, ragged: Path) -> dict:
    """The port's CLI on cuda for each configuration (launch counts read
    around these runs only), each output checked with numpy against the
    .pgen; then the same CLI on cpu, whose plain PyTorch text the CPU tests
    hold byte for byte against pgen_tpu, as the sha256 reference."""
    import numpy as np

    iids, pos, _, packed = _read_fileset(full)
    _, _, _, ragged_packed = _read_fileset(ragged)
    two = np.array([7, 2000])
    region_lo, region_hi = pos[len(pos) // 4], pos[3 * len(pos) // 4]
    in_region = np.flatnonzero((pos >= region_lo) & (pos <= region_hi))
    names = f"{iids[two[0]]},{iids[two[1]]}"
    every = np.arange(len(iids))
    runs = [
        # label, fileset, argv, output name, (packed, kept rows, kept samples)
        ("chr22 keep-two", full, ["--samples", names], "k2.vcf",
         (packed, np.arange(len(pos)), two)),
        (f"chr22 keep-two -r 22:{region_lo}-{region_hi}", full,
         ["--samples", names, "-r", f"22:{region_lo}-{region_hi}"], "r2.vcf",
         (packed, in_region, two)),
        (f"{RAGGED_VARIANTS}-variant keep-all", ragged, [], "ka.vcf",
         (ragged_packed, np.arange(RAGGED_VARIANTS), every)),
        (f"{RAGGED_VARIANTS}-variant keep-all .vcf.gz --index", ragged, ["--index"],
         "ka.vcf.gz", None),
    ]

    # untimed: the first filter of a process builds pgen_tpu's C++ host
    # runtime (cached by source hash), which is no part of a filter's wall
    t0 = time.perf_counter()
    _port_filter(ragged, ["-r", "22:1-1"], tmp / "warm.vcf", "cpu")
    print(f"[4 filter] warm-up filter (builds the host runtime): "
          f"{time.perf_counter() - t0:.3f} s")

    results = []
    walls = []
    # every launch counted from here to the read below is the main path's
    _reset_launches()
    for label, prefix, argv, name, expect in runs:
        out = tmp / f"cuda.{name}"
        print(f"[4 filter] {label} on cuda:")
        walls.append(_port_filter(prefix, argv, out, "cuda"))
        files = [out] + ([Path(f"{out}.tbi")] if "--index" in argv else [])
        results.append(([_sha256(f) for f in files], out.stat().st_size))
        if expect is not None:
            _check_gt_text(out, *expect)
        elif _gunzip_sha256(out) != results[2][0][0]:
            # BGZF must hold the plain keep-all output, byte for byte
            raise AssertionError(f"{name} does not decompress to the plain keep-all VCF")
        for f in files:
            f.unlink()
    launches = _read_launches()

    for (label, prefix, argv, name, _), (hashes, size), cuda_s in zip(runs, results, walls):
        out = tmp / f"cpu.{name}"
        cpu_s = _port_filter(prefix, argv, out, "cpu")
        files = [out] + ([Path(f"{out}.tbi")] if "--index" in argv else [])
        for f, want in zip(files, hashes):
            if _sha256(f) != want:
                raise AssertionError(f"{label}: the cuda run's {f.suffix} differs from the cpu run's")
            f.unlink()
        print(f"[4 filter] {label}: {size} B, sha256 equal on cuda and cpu"
              f"{' (+ .tbi)' if len(files) > 1 else ''}, GT text equal to numpy's "
              f"decode of the .pgen{' after gunzip' if '--index' in argv else ''}; "
              f"wall cuda {cuda_s:.3f} s, cpu {cpu_s:.3f} s")
    print(f"[4 filter] main-path launches: {launches}")
    for name in ("genotype_text", "subset_text_from_packed"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


def _check_fileset_header(pgen: Path, n_var: int, n_samples: int) -> None:
    import struct

    with open(pgen, "rb") as f:
        head = f.read(12)
    if head[:3] != b"\x6c\x1b\x02" or struct.unpack("<II", head[3:11]) != (n_var, n_samples):
        raise AssertionError(f"{pgen.name}: header {head.hex()} is not mode 0x02 "
                             f"with {n_var} variants x {n_samples} samples")


def _repack_numpy(packed, keep):
    """Records of the kept samples, re-packed with numpy (LSB-first 2-bit
    codes, pad bits zero), sharing no code with the port."""
    import numpy as np

    codes = (packed[:, keep >> 2] >> (2 * (keep & 3)).astype(np.uint8)) & 3
    out_rec = (len(keep) + 3) // 4
    quads = np.zeros((len(packed), 4 * out_rec), dtype=np.uint8)
    quads[:, : len(keep)] = codes
    q = quads.reshape(len(packed), out_rec, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def _fileset_sha256(prefix: Path) -> list:
    return [_sha256(Path(f"{prefix}{suf}")) for suf in (".pgen", ".pvar", ".psam")]


def phase_pgen_out(tmp: Path, full: Path) -> dict:
    """filter --out-format pgen --keep (1,001 samples drawn with the seed) on
    the full chr22 fixture through the port's CLI on cuda (launch counts read
    around that run only). The .pgen body must equal a numpy re-pack of the
    fixture's records at the kept samples; the three files must be
    sha256-equal to the same CLI with --device cpu."""
    import numpy as np

    iids, pos, _, packed = _read_fileset(full)
    keep = np.sort(np.random.default_rng(SEED).choice(len(iids), KEEP_SAMPLES, replace=False))
    keep_file = tmp / "keep.txt"
    keep_file.write_text("".join(f"{iids[i]}\n" for i in keep))
    argv = ["--out-format", "pgen", "--keep", str(keep_file)]

    print(f"[5 pgen out] chr22 --keep {KEEP_SAMPLES} samples --out-format pgen on cuda:")
    _reset_launches()
    cuda_s = _port_filter(full, argv, tmp / "cuda_keep", "cuda")
    launches = _read_launches()

    out = tmp / "cuda_keep"
    _check_fileset_header(Path(f"{out}.pgen"), len(pos), KEEP_SAMPLES)
    out_rec = (KEEP_SAMPLES + 3) // 4
    body = np.memmap(f"{out}.pgen", dtype=np.uint8, mode="r", offset=12,
                     shape=(len(pos), out_rec))
    for lo in range(0, len(pos), BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, len(pos))
        if not np.array_equal(body[lo:hi], _repack_numpy(packed[lo:hi], keep)):
            raise AssertionError(f"{out.name}.pgen: records [{lo}, {hi}) differ from numpy's re-pack")
    del body
    if Path(f"{out}.psam").read_text().count("\n") != KEEP_SAMPLES + 1:
        raise AssertionError(f"{out.name}.psam does not hold the {KEEP_SAMPLES} kept samples")
    hashes = _fileset_sha256(out)
    size = Path(f"{out}.pgen").stat().st_size

    cpu_s = _port_filter(full, argv, tmp / "cpu_keep", "cpu")
    if _fileset_sha256(tmp / "cpu_keep") != hashes:
        raise AssertionError("pgen output: the cuda run's fileset differs from the cpu run's")
    for prefix in (out, tmp / "cpu_keep"):
        for suf in (".pgen", ".pvar", ".psam"):
            Path(f"{prefix}{suf}").unlink()
    print(f"[5 pgen out] chr22 --keep {KEEP_SAMPLES}: {size} B .pgen, records equal to numpy's "
          f"re-pack, .pgen/.pvar/.psam sha256 equal on cuda and cpu; "
          f"wall cuda {cuda_s:.3f} s, cpu {cpu_s:.3f} s")
    print(f"[5 pgen out] path launches: {launches}")
    if launches["subset_repack"] <= 0:
        raise AssertionError("subset_repack never launched on the pgen output path")
    return launches


def phase_import(tmp: Path, fixture: Path) -> dict:
    """The keep-all VCF of a 50,001-variant fixture, written by the port's
    own VCF filter, imported through the port's CLI on cuda (launch counts
    read around the import only). 2504 % 4 == 0, so the records have no pad
    bits and the imported .pgen body must equal the fixture's records; the
    three files must be sha256-equal to the same import with --device cpu."""
    import numpy as np

    iids, pos, _, packed = _read_fileset(fixture)
    vcf = tmp / "import.vcf"
    t0 = time.perf_counter()
    _port_filter(fixture, [], vcf, "cuda")
    print(f"[6 import] keep-all VCF of {len(pos)} variants written by the port's filter in "
          f"{time.perf_counter() - t0:.3f} s: {vcf.stat().st_size} B")

    print("[6 import] import of that VCF on cuda:")
    _reset_launches()
    cuda_s = _port_cli(["import", vcf], tmp / "cuda_imp", "cuda")[0]
    launches = _read_launches()

    out = tmp / "cuda_imp"
    _check_fileset_header(Path(f"{out}.pgen"), len(pos), len(iids))
    body = np.memmap(f"{out}.pgen", dtype=np.uint8, mode="r", offset=12, shape=packed.shape)
    if not np.array_equal(body, packed):
        bad = int(np.flatnonzero((body != packed).any(axis=1))[0])
        raise AssertionError(f"{out.name}.pgen: record {bad} differs from the fixture's")
    del body
    hashes = _fileset_sha256(out)

    cpu_s = _port_cli(["import", vcf], tmp / "cpu_imp", "cpu")[0]
    if _fileset_sha256(tmp / "cpu_imp") != hashes:
        raise AssertionError("import: the cuda run's fileset differs from the cpu run's")
    for prefix in (out, tmp / "cpu_imp"):
        for suf in (".pgen", ".pvar", ".psam"):
            Path(f"{prefix}{suf}").unlink()
    vcf.unlink()
    print(f"[6 import] {len(pos)} variants x {len(iids)} samples: records equal to the "
          f"fixture's, .pgen/.pvar/.psam sha256 equal on cuda and cpu; "
          f"wall cuda {cuda_s:.3f} s, cpu {cpu_s:.3f} s")
    print(f"[6 import] path launches: {launches}")
    if launches["pack_codes"] <= 0:
        raise AssertionError("pack_codes never launched on the import path")
    return launches

REGION_VARIANTS = 5000  # variants of the -r region of phase 7 (b) and (d)


def _variant_counts_numpy(packed, rows):
    """(len(rows), 4) code counts of the given records over all 4R slots
    (2504 samples: no pad slots), with a 256 x 4 table of per-byte counts."""
    import numpy as np

    b = np.arange(256)
    lut = np.zeros((256, 4), dtype=np.int64)
    for k in range(4):
        np.add.at(lut, (b, (b >> (2 * k)) & 3), 1)
    return lut[packed[rows]].sum(axis=1)


def _sample_missing_numpy(packed):
    """Per-slot count of code 3 (./.) over every record, block by block."""
    import numpy as np

    missing = np.zeros(4 * packed.shape[1], dtype=np.int64)
    for lo in range(0, len(packed), BLOCK_ROWS):
        blk = np.asarray(packed[lo : lo + BLOCK_ROWS])
        both = blk & (blk >> 1)  # bit 2k set where slot k holds code 3
        for k in range(4):
            missing[k::4] += ((both >> (2 * k)) & 1).sum(axis=0, dtype=np.int64)
    return missing


def _trace_shares(path: Path, wall_s: float) -> str:
    """Kernel and copy busy time against the span of a torch.profiler
    Chrome trace and against the traced run's wall, and the largest
    kernels by time."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - t0

    def busy(cat):
        total, end = 0.0, float("-inf")
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == cat):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    kern, copy = busy("kernel"), busy("gpu_memcpy")
    return (f"traced span {span / 1e3:.3f} ms: kernels busy {kern / 1e3:.3f} ms "
            f"({100 * kern / span:.2f}% of the span, {kern / 1e4 / wall_s:.3f}% of the wall), "
            f"copies {copy / 1e3:.3f} ms ({100 * copy / span:.2f}% of the span); "
            f"largest kernels (ms): "
            + ", ".join(f"{name[:48]} {dur / 1e3:.3f}" for name, dur in top))


def _route(stderr: str) -> str:
    for line in stderr.splitlines():
        if line.startswith("predicate route: "):
            return line[len("predicate route: "):]
    raise AssertionError("the --stats report names no predicate route")


def _argv_a(iids):
    return ["--include-var", 'ALT == "G"', "--samples", f"{iids[7]},{iids[2000]}"]


def phase_device_provider(tmp: Path, full: Path, ragged: Path) -> tuple:
    """filter --provider device through the port's CLI on cuda, on a real
    one-rank NCCL group (launch counts read around these runs only):
    (a) full chr22 ALT == "G" keep-two, a device-lowered predicate then K3;
    (b) full chr22 --maf and --mind over a region, thresholds at the median
    so that about half pass, their counts K8 and K9; (c) 140,001-variant
    keep-all ALT == "G" as .vcf and .vcf.gz --index, K2; (d) a region
    keep-two, the host mask after a DeviceFallback. Each output is checked
    with numpy against the .pgen, then by sha256 against the same CLI with
    --device cpu and (uncompressed) against the single-GPU filter. One more
    run of (a) takes a torch.profiler trace. Returns the launch counts and
    (a)'s sha256."""
    import numpy as np

    from pgen_tpu_torch.pipeline.mesh_filter import ROUTE_DEVICE, ROUTE_FALLBACK, ROUTE_HOST

    iids, pos, alt, packed = _read_fileset(full)
    _, _, ragged_alt, ragged_packed = _read_fileset(ragged)
    two, every = np.array([7, 2000]), np.arange(len(iids))
    first = len(pos) // 2
    lo_pos, hi_pos = pos[first], pos[first + REGION_VARIANTS - 1]
    region = f"22:{lo_pos}-{hi_pos}"
    in_region = np.flatnonzero((pos >= lo_pos) & (pos <= hi_pos))

    c = _variant_counts_numpy(packed, in_region)
    ac, nobs = c[:, 1] + 2 * c[:, 2], len(iids) - c[:, 3]
    af = np.where(nobs > 0, ac / np.maximum(2 * nobs, 1), 0.0)
    maf = np.minimum(af, 1.0 - af)
    maf_thr = float(f"{np.median(maf):.6f}")
    maf_rows = in_region[maf >= maf_thr]
    missing_rate = _sample_missing_numpy(packed)[: len(iids)] / len(pos)
    mind_thr = float(f"{np.median(missing_rate):.8f}")
    mind_samples = np.flatnonzero(missing_rate <= mind_thr)
    print(f"[7 device provider] --maf {maf_thr} keeps {len(maf_rows)} of the region's "
          f"{len(in_region)} variants; --mind {mind_thr} keeps {len(mind_samples)} of "
          f"{len(iids)} samples (numpy's counts of the .pgen)")
    for flag, kept, of in (("--maf", len(maf_rows), len(in_region)),
                           ("--mind", len(mind_samples), len(iids))):
        if not 0.1 * of <= kept <= 0.9 * of:
            raise AssertionError(f"{flag} keeps {kept} of {of}, outside 10-90%")

    argv_a = _argv_a(iids)
    runs = [
        # label, fileset, argv, output name, route, (packed, kept rows, kept samples)
        ("(a) chr22 ALT == G keep-two", full, argv_a, "a.vcf", ROUTE_DEVICE,
         (packed, np.flatnonzero(alt == b"G"), two)),
        (f"(b) chr22 --maf {maf_thr} -r {region}", full, ["--maf", str(maf_thr), "-r", region],
         "b_maf.vcf", ROUTE_HOST, (packed, maf_rows, every)),
        (f"(b) chr22 --mind {mind_thr} -r {region}", full, ["--mind", str(mind_thr), "-r", region],
         "b_mind.vcf", ROUTE_HOST, (packed, in_region, mind_samples)),
        (f"(c) {RAGGED_VARIANTS}-variant keep-all ALT == G", ragged, ["--include-var", 'ALT == "G"'],
         "c.vcf", ROUTE_DEVICE, (ragged_packed, np.flatnonzero(ragged_alt == b"G"), every)),
        (f"(c) {RAGGED_VARIANTS}-variant keep-all ALT == G .vcf.gz --index", ragged,
         ["--include-var", 'ALT == "G"', "--index"], "c.vcf.gz", ROUTE_DEVICE, None),
        (f"(d) chr22 -r {region} keep-two", full, ["-r", region, "--samples", argv_a[3]],
         "d.vcf", ROUTE_FALLBACK, (packed, in_region, two)),
    ]

    def device_run(prefix, argv, out, device):
        return _port_cli(["filter", prefix, *argv, "--provider", "device"], out, device)

    results, walls = [], []
    _reset_launches()
    for label, prefix, argv, name, route, expect in runs:
        out = tmp / f"cuda.{name}"
        print(f"[7 device provider] {label} on cuda:")
        seconds, err = device_run(prefix, argv, out, "cuda")
        walls.append(seconds)
        if _route(err) != route:
            raise AssertionError(f"{label}: route {_route(err)!r}, expected {route!r}")
        files = [out] + ([Path(f"{out}.tbi")] if "--index" in argv else [])
        results.append(([_sha256(f) for f in files], out.stat().st_size))
        if expect is not None:
            _check_gt_text(out, *expect)
        elif _gunzip_sha256(out) != results[3][0][0]:
            raise AssertionError(f"{name} does not decompress to the plain (c) output")
        for f in files:
            f.unlink()
    prof = tmp / "profile"
    prof_s, _ = device_run(full, [*argv_a, "--profile", str(prof)], tmp / "cuda.prof.vcf", "cuda")
    print(f"[7 device provider] (a) once more under --profile, wall {prof_s:.3f} s: "
          f"{_trace_shares(prof / 'rank0.trace.json', prof_s)}")
    launches = _read_launches()

    for (label, prefix, argv, name, route, expect), (hashes, size), cuda_s in zip(runs, results, walls):
        out = tmp / f"cpu.{name}"
        cpu_s, _ = device_run(prefix, argv, out, "cpu")
        files = [out] + ([Path(f"{out}.tbi")] if "--index" in argv else [])
        for f, want in zip(files, hashes):
            if _sha256(f) != want:
                raise AssertionError(f"{label}: the cuda run's {f.suffix} differs from the cpu run's")
            f.unlink()
        single = ""
        if expect is not None:
            out = tmp / f"single.{name}"
            single_s = _port_filter(prefix, argv, out, "cuda")
            if _sha256(out) != hashes[0]:
                raise AssertionError(f"{label}: differs from the single-GPU filter's output")
            out.unlink()
            single = f", single-GPU filter {single_s:.3f} s"
        print(f"[7 device provider] {label}: {size} B, route {route}, sha256 equal on cuda and "
              f"cpu{' (+ .tbi)' if len(files) > 1 else ''}"
              f"{' and to the single-GPU filter' if expect is not None else ''}, GT text equal "
              f"to numpy's decode of the .pgen{' after gunzip' if expect is None else ''}; "
              f"wall cuda {cuda_s:.3f} s, cpu {cpu_s:.3f} s{single}")
    print(f"[7 device provider] path launches: {launches}")
    for name in ("genotype_text", "subset_text_from_packed", "gt_counts_device",
                 "sample_counts_device"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the device provider's path")
    return launches, results[0][0][0]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_ranks(tmp: Path, full: Path, want_sha: str) -> None:
    """(a) again as 2 ranks (and 4, where four cards are visible, with
    LOCAL_RANK reversed: rank r on card 3 - r), each rank a torchrun-style
    process of the port's CLI; the output must be sha256-equal to the
    one-rank run's."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[7 device provider] (a) on 2 and 4 ranks: skipped, {n} card visible "
              "(one process per card needs two or more)")
        return
    iids, _, _, _ = _read_fileset(full)
    for world in (2, 4) if n >= 4 else (2,):
        out = tmp / f"ranks{world}.vcf"
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(world)}
        cmd = [sys.executable, "-m", "pgen_tpu_torch.cli", "filter", str(full), *_argv_a(iids),
               "--provider", "device", "--device", "cuda", "--stats", "-o", str(out)]
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(world):
                local = world - 1 - r if world == 4 else r
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(local)},
                ))
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        seconds = time.perf_counter() - t0
        for r, (p, err) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {world} exited {p.returncode}\n{err[-3000:]}")
        if _sha256(out) != want_sha:
            raise AssertionError(f"(a) on {world} ranks differs from the one-rank run")
        print(f"[7 device provider] (a) on {world} ranks{' (LOCAL_RANK reversed)' if world == 4 else ''}: "
              f"sha256 equal to the one-rank run; wall {seconds:.3f} s (process start included); "
              "rank 0's report:")
        for line in errs[0].strip().splitlines():
            print(f"    {line}")
        out.unlink()


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    name = phase_device()
    phase_build()
    if argv == ["--ranks"]:
        # the device provider across cards, and what it is compared with
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            tmp = Path(tmp)
            full = make_fixtures(tmp)["full"]
            iids, _, _, _ = _read_fileset(full)
            print("[7 device provider] (a) on one rank:")
            _port_cli(["filter", full, *_argv_a(iids), "--provider", "device"], tmp / "a.vcf", "cuda")
            phase_ranks(tmp, full, _sha256(tmp / "a.vcf"))
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}; takes none, or --ranks", file=sys.stderr)
        return 2
    else:
        measured = phase_kernels()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            tmp = Path(tmp)
            fixtures = make_fixtures(tmp)
            per_path = [
                phase_filter(tmp, fixtures["full"], fixtures["ragged"]),
                phase_pgen_out(tmp, fixtures["full"]),
                phase_import(tmp, fixtures["import"]),
            ]
            launches, sha_a = phase_device_provider(tmp, fixtures["full"], fixtures["ragged"])
            per_path.append(launches)
            phase_ranks(tmp, fixtures["full"], sha_a)
    if "jax" in sys.modules:
        raise AssertionError("the port's run loaded jax")

    if not argv:
        rows = []
        for kname, where in KERNELS.items():
            ms, plain_ms = measured["times"][kname]
            rows.append({
                "name": kname, "route": "cuda", "source": SOURCE, "replaces": where,
                "launches": sum(launches[kname] for launches in per_path),
                "max_abs_err": measured["err"][kname], "ms": ms, "plain_ms": plain_ms,
            })
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
