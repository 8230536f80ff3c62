#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port (pgen_tpu_torch) on one NVIDIA H100,
beside chip_smoke.py, whose fixtures, timer and oracles they use.

    python3 chip_diag.py --ab DIR      # K4, K5, K8-K11, K14 against the kernels of the checkout
                                       # at DIR; K14's wrapper against that checkout's; K12, K15
                                       # and K13's pass against that checkout's chains
    python3 chip_diag.py --precision   # X1-X3 with f32, split-column and f64 products
    python3 chip_diag.py --trace       # the --ab cases' device time per launch, no host time,
                                       # and K12, K13, their products, K15 and K13's pass
    python3 chip_diag.py --forms       # K5's staged and direct forms at each K, and its threshold
    python3 chip_diag.py --phase-times DIR # DIR's chip_smoke.py, each of its phases timed
    python3 chip_diag.py --rates       # popcount and .b1 mma.sync rates of the card
    python3 chip_diag.py --ld-cpu DIR... # full-chr22 ld and prune --device cpu, this checkout
                                       # and those at DIR...
    python3 chip_diag.py --eigh        # exact pca's 2504 x 2504 f64 eigh on the card and host

--ab builds the kernel sources of another checkout (the parent commit's,
unpacked with git archive) beside this one's and times both in one process
on the same tensors; it then imports the other checkout's package beside
this one's and times both K14 wrappers, host time included, then K12, K15
and K13's --approx pass against the other checkout's chains for the same
work (its K12 int8 planes and four or five torch._int_mm Grams; its K15 c,
tile Grams and r² ops; its K13 z and two products), through both packages,
each side's device operations traced, and each package's king and genome
scans' peak device memory. --trace runs this
checkout's launchers of the same cases under torch.profiler and prints each
device operation's time per launch (kernels and memsets), which CUDA events
around a launch cannot separate from the host's enqueue time; it also
traces K12's bits and Grams, K13 and the library products beside them (one
torch._int_mm Gram of the CPU scan's int8 planes, one fp32 z'z and an
--approx pass's two products before its kernels), K15 at bands 9, 49 and
420 and K13's pass. --precision shows
which part of an f32 moment product costs each GWAS design its accuracy
against pgen_tpu's tolerances. --forms builds this checkout's kernels twice
more, K5's launcher held to its direct form in one and to its staged form
(wherever a row tile fits) in the other, and times both on the same records
at a range of K: the readings its threshold (kRepackDenseRatio) is fixed
from. --phase-times runs the chip_smoke.py of another checkout (one whose
smoke does not time its own phases, as this one's does) from that
checkout's root, each of its phase functions timed. --rates times the two instructions a per-mask count can rest on: a
popcount on the CUDA cores and K14's .b1 AND-POPC product on the tensor
cores. --ld-cpu times the CPU's ld (band 9) and prune --indep-pairwise 50 5
0.2 (band 49) over every variant of the chr22 fixture, each checkout's CLI
a process of its own (--device cpu: K15's plain version), and prints each
run's wall, its r2_band stage and the sha256 of its outputs. --eigh times
the eigendecomposition of exact pca's GRM on the card against LAPACK on
the host, and builds no kernel. All import no
jax and nothing of pgen_tpu, and exit non-zero without CUDA.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BLOCK_ROWS,
    BURST,
    CHR22_VARIANTS,
    COHORT,
    COHORTS,
    KEEP_SAMPLES,
    POPULATIONS,
    GLM_ROWS,
    GWAS_REGION,
    REL_ROWS,
    SEED,
    WIDE,
    WIDE_GLM_ROWS,
    WIDE_PACK_ROWS,
    WIDTHS,
    _gwas_tables,
    _keep_masks,
    _read_fileset,
    _time_ms,
    _worst,
    make_fixtures,
    phase_build,
    phase_device,
)


def _scan_products(packed, n_samples, lut, products, modes) -> tuple:
    """K10's planes of every 16,384-row block on the card, then each
    planes[p] @ cols of ``products`` in each of ``modes``: "f32" (the
    port's full-fp32 product with f32 columns), "split" (the columns as
    hi + lo f32 halves, two fp32 products summed in f64: exact columns, f32
    accumulation) and "f64" (an f64 product). Returns the (V, 4) code counts
    and {mode: [(V, cols) f64 per product]}."""
    import numpy as np
    import torch

    from pgen_tpu_torch import kernels
    from pgen_tpu_torch.device import full_fp32, matmul_fp32
    from pgen_tpu_torch.ops import glm
    from pgen_tpu_torch.ops.gt_stats import stage_blocks

    dev = torch.device("cuda", 0)
    lut_t = torch.tensor(lut, dtype=torch.float32, device=dev)
    c64 = [torch.from_numpy(np.ascontiguousarray(c, dtype=np.float64)).to(dev) for _, c in products]
    hi = [c.float() for c in c64]
    lo = [(c - h.double()).float() for c, h in zip(c64, hi)]
    wide = torch.empty(glm.F64_CHUNK_ROWS * n_samples, dtype=torch.float64, device=dev)
    hist = np.empty((packed.shape[0], 4), dtype=np.int64)
    outs = {m: [np.empty((packed.shape[0], c.shape[1])) for c in c64] for m in modes}
    for a, b, block in stage_blocks(packed, dev, GLM_ROWS):
        planes, h = glm.glm_planes(block, n_samples, lut_t)
        hist[a:b] = h.cpu().numpy()
        for i, (p, _) in enumerate(products):
            for m in modes:
                if m == "f32":
                    prod = matmul_fp32(planes[p], hi[i]).double()
                elif m == "split":
                    prod = (matmul_fp32(planes[p], hi[i]).double()
                            + matmul_fp32(planes[p], lo[i]).double())
                else:
                    prod = glm._matmul_fp64(planes[p], c64[i], wide)
                outs[m][i][a:b] = prod.cpu().numpy()
    return hist, outs


def phase_precision(tmp: Path, full: Path) -> None:
    """Which part of an f32 moment product costs the GWAS designs their
    accuracy on the card, with phase 8's seeded QT0, C1 and C2 (C2 near 50):
    each design's moments with f32, split-column and f64 products, solved by
    the port's f64 solves, BETA and SE held against the f64 products'. X3
    (the interaction design) over phase 8 (b)'s 50,000-variant region at
    pgen_tpu's rtol 2e-4 atol 1e-6; X1 (linear) and X2 (genotypic) over
    every chr22 variant at their rtol 1e-3 atol 1e-5."""
    import numpy as np

    from pgen_tpu_torch.ops import glm

    iids, pos, _, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    values = _gwas_tables(tmp, iids, packed)["values"]
    y = values["QT0"]
    covars = np.column_stack([values["C1"], values["C2"]])
    k = covars.shape[1]
    yc, cc = glm._centered(y, covars)
    pcols = glm._moment_columns(yc, cc)

    def report(design, rows, got, want, rtol, atol):
        for what, g, w in (("BETA", got.beta, want.beta), ("SE", got.se, want.se)):
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                raise AssertionError(f"{design}: NA cells differ")
            print(f"[precision] {design}, {rows} variants: worst {what} {_worst(g, w, rtol, atol):.4g} "
                  f"of rtol {rtol} atol {atol} on the value alone, against the f64 products")

    first = n_var // 2 - GWAS_REGION // 2
    region = packed[first : first + GWAS_REGION]
    t0 = time.perf_counter()
    hist, outs = _scan_products(region, n, glm.LUT_INT, [(0, pcols), (1, pcols), (2, pcols)],
                                ("f32", "split", "f64"))
    solved = {m: glm.glm_solve_interaction(
        glm.GlmIntMoments(glm._row_sums(hist)[0], *outs[m]), k, covar_means=covars.mean(axis=0))
        for m in outs}
    for m in ("f32", "split"):
        report(f"X3 interaction, {m} products", GWAS_REGION, solved[m], solved["f64"], 2e-4, 1e-6)
    print(f"[precision] X3 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    q = np.concatenate([yc[:, None], cc], axis=1)
    hist, outs = _scan_products(packed, n, glm.LUT_MOMENTS, [(0, pcols), (1, q)], ("f32", "f64"))
    nn, sg, sg2 = glm._row_sums(hist)
    solved = {m: glm.glm_solve(glm.GlmMoments(nn, *outs[m], sg, sg2), k) for m in outs}
    report("X1 linear, f32 products", n_var, solved["f32"], solved["f64"], 1e-3, 1e-5)
    print(f"[precision] X1 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gcols, q2 = glm._geno_moment_inputs(y, covars)
    hist, outs = _scan_products(packed, n, glm.LUT_GENO, [(0, gcols), (1, q2), (2, q2)],
                                ("f32", "f64"))
    solved = {m: glm.glm_solve_modifier(glm.GlmGenoMoments(glm._row_sums(hist)[0], *outs[m]), k,
                                        "genotypic") for m in outs}
    report("X2 genotypic, f32 products", n_var, solved["f32"], solved["f64"], 1e-3, 1e-5)
    print(f"[precision] X2 took {time.perf_counter() - t0:.1f} s")


def _build_other(csrc: Path, defines: tuple = ()) -> Path:
    """nvcc build of another checkout's kernel sources with this checkout's
    flags (and ``defines``, each a -D), into this checkout's build directory
    under a name of its own."""
    from pgen_tpu_torch import kernels

    flags = [*kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode())
    for name in kernels.SOURCES:
        h.update((csrc / name).read_bytes())
    so = kernels.BUILD_DIR / f"libpgen_kernels_other_{h.hexdigest()[:16]}.so"
    if not so.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                           / "bin" / "nvcc")
        r = subprocess.run([nvcc, *flags, "-o", str(so), str(csrc / "genotype.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {r.returncode}:\n{r.stderr}")
    return so


def _masked_sets(n_samples: int) -> tuple:
    """K14's sample sets at n_samples: COHORTS sorted cohorts (KEEP_SAMPLES
    of 2504, the same share at other widths) and a seeded partition into
    POPULATIONS labels."""
    import numpy as np

    rng = np.random.default_rng(SEED + 14)
    size = n_samples * KEEP_SAMPLES // WIDTHS[0]
    cohorts = [np.sort(rng.choice(n_samples, size, replace=False)) for _ in range(COHORTS)]
    labels = rng.integers(0, POPULATIONS, n_samples)
    return cohorts, [np.flatnonzero(labels == p) for p in range(POPULATIONS)]


def _kernel_cases(other) -> dict:
    """The launcher cases of --ab and --trace: {name: (outputs, call(lib))}
    at the paths' block shapes, on tensors made from SEED. ``other`` is the
    other checkout's library (None for --trace)."""
    import torch

    from pgen_tpu_torch.ops.glm import LUT_GENO, LUT_MOMENTS
    from pgen_tpu_torch.ops.gt_stats import kept_counts, mask_words

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = WIDTHS[0]
    rec = (s + 3) // 4
    codes = torch.randint(0, 4, (BLOCK_ROWS, s), dtype=torch.uint8, device=dev, generator=gen)
    codes_odd = codes[:, : s - 1].contiguous()
    codes_wide = torch.randint(0, 4, (WIDE_PACK_ROWS, WIDE), dtype=torch.uint8, device=dev,
                               generator=gen)
    ops = torch.randint(0, 256, (GLM_ROWS, rec), dtype=torch.uint8, device=dev, generator=gen)
    ops_wide = torch.randint(0, 256, (WIDE_GLM_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                             device=dev, generator=gen)
    cohort = torch.randperm(s, generator=gen, device=dev)[:COHORT].sort().values.to(torch.int32)
    sel_wide = torch.randperm(WIDE, generator=gen, device=dev)[: WIDE - 3].sort().values
    sel_wide = sel_wide.to(torch.int32)
    flip = torch.randint(0, 2, (GLM_ROWS,), dtype=torch.uint8, device=dev, generator=gen)
    flip_wide = torch.randint(0, 2, (WIDE_GLM_ROWS,), dtype=torch.uint8, device=dev, generator=gen)
    records = torch.randint(0, 256, (BLOCK_ROWS, rec), dtype=torch.uint8, device=dev, generator=gen)
    records_wide = torch.randint(0, 256, (WIDE_PACK_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                                 device=dev, generator=gen)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values
    keep = keep.to(torch.int32)
    keep2 = torch.randperm(s, generator=gen, device=dev)[:2].to(torch.int32)
    # K14 at S = WIDE on the count paths' block (655 MB)
    records_wide_block = torch.randint(0, 256, (BLOCK_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                                       device=dev, generator=gen)
    lut2, lut3 = (torch.tensor(t, dtype=torch.float32, device=dev) for t in (LUT_MOMENTS, LUT_GENO))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def pack_case(c):
        out = torch.empty((c.shape[0], (c.shape[1] + 3) // 4), dtype=torch.uint8, device=dev)
        return [out], lambda lib: lib.pgen_pack_codes(c.data_ptr(), out.data_ptr(), c.shape[0],
                                                      c.shape[1], stream)

    def planes_case(records, n_samples, lut, sel):
        n_var, n_rec = records.shape
        kept = n_samples if sel is None else sel.shape[0]
        planes = torch.empty((lut.shape[0], n_var, kept), dtype=torch.float32, device=dev)
        hist = torch.zeros((n_var, 4), dtype=torch.int32, device=dev)
        return [planes, hist], lambda lib: lib.pgen_glm_planes(
            records.data_ptr(), None if sel is None else sel.data_ptr(), lut.data_ptr(),
            planes.data_ptr(), hist.data_ptr(), n_var, n_rec, n_samples, kept, lut.shape[0],
            stream)

    def score_case(records, n_samples, flips, sel, offset=0):
        """K11 into dosages ``offset`` bytes past a 16-B boundary (4: the
        tiled form where the flat one would run)."""
        n_var, n_rec = records.shape
        kept = n_samples if sel is None else sel.shape[0]
        buf = torch.empty(n_var * kept + 4, dtype=torch.float32, device=dev)
        db = buf[offset // 4 : offset // 4 + n_var * kept]
        called = torch.zeros(2 * n_var, dtype=torch.int32, device=dev)
        return [db, called[:n_var]], lambda lib: lib.pgen_score_dosage(
            records.data_ptr(), None if sel is None else sel.data_ptr(), flips.data_ptr(),
            db.data_ptr(), called.data_ptr(), n_var, n_rec, n_samples, kept, 1, stream)

    def repack_case(records, sel):
        n_var, n_rec = records.shape
        out = torch.empty((n_var, (sel.shape[0] + 3) // 4), dtype=torch.uint8, device=dev)
        return [out], lambda lib: lib.pgen_subset_repack(
            records.data_ptr(), sel.data_ptr(), out.data_ptr(), n_var, n_rec, sel.shape[0], stream)

    def gt_counts_case(records, n_samples):
        counts = torch.empty((records.shape[0], 4), dtype=torch.int32, device=dev)
        return [counts], lambda lib: lib.pgen_gt_counts(
            records.data_ptr(), counts.data_ptr(), records.shape[0], records.shape[1], n_samples,
            stream)

    def counts_case(records):
        counts = torch.empty((4 * rec, 4), dtype=torch.int32, device=dev)
        return [counts], lambda lib: lib.pgen_sample_counts(
            records.data_ptr(), counts.data_ptr(), records.shape[0], rec, stream)

    def masked_case(records, n_samples, sets):
        """K14: both launchers take the masks' E words and kept counts (the
        tensor-core form's operand, in every checkout since it)."""
        masks = _keep_masks(n_samples, sets, dev)
        words, kept = mask_words(masks), kept_counts(masks)
        (n_var, n_rec), n_masks = records.shape, masks.shape[0]
        counts = torch.empty((n_var, n_masks, 4), dtype=torch.int32, device=dev)
        return [counts], lambda lib: lib.pgen_gt_counts_masked(
            records.data_ptr(), words.data_ptr(), kept.data_ptr(), counts.data_ptr(), n_var,
            n_rec, n_masks, stream)

    cohorts, partition = _masked_sets(s)
    wide_cohorts, wide_partition = _masked_sets(WIDE)

    cases = {
        "K4 pack_codes S=2504": pack_case(codes),
        "K4 pack_codes S=2503": pack_case(codes_odd),
        f"K4 pack_codes S={WIDE} V={WIDE_PACK_ROWS}": pack_case(codes_wide),
        "K10 glm_planes P=2 K=2454 sel": planes_case(ops, s, lut2, cohort),
        "K10 glm_planes P=3 K=2504": planes_case(ops, s, lut3, None),
        f"K10 glm_planes P=2 K={WIDE - 3} sel of S={WIDE} V={WIDE_GLM_ROWS}":
            planes_case(ops_wide, WIDE, lut2, sel_wide),
        f"K5 subset_repack K={KEEP_SAMPLES} sorted": repack_case(records, keep),
        "K5 subset_repack K=2": repack_case(records, keep2),
        f"K5 subset_repack K={WIDE - 3} sorted of S={WIDE} V={WIDE_PACK_ROWS} (column tiles)":
            repack_case(records_wide, sel_wide),
        f"K8 gt_counts V={BLOCK_ROWS}": gt_counts_case(records, s),
        f"K9 sample_counts V={BLOCK_ROWS}": counts_case(records),
        f"K9 sample_counts V={GLM_ROWS}": counts_case(records[:GLM_ROWS]),
        f"K14 gt_counts_masked V={BLOCK_ROWS} P=1 K={KEEP_SAMPLES}":
            masked_case(records, s, cohorts[:1]),
        f"K14 gt_counts_masked V={BLOCK_ROWS} P={COHORTS} K={KEEP_SAMPLES}":
            masked_case(records, s, cohorts),
        f"K14 gt_counts_masked V={BLOCK_ROWS} P={POPULATIONS} (a partition)":
            masked_case(records, s, partition),
        f"K14 gt_counts_masked S={WIDE} V={WIDE_PACK_ROWS} P=1 K={len(wide_cohorts[0])} (rows in "
        "chunks)": masked_case(records_wide, WIDE, wide_cohorts[:1]),
        f"K14 gt_counts_masked S={WIDE} V={WIDE_PACK_ROWS} P={POPULATIONS} (a partition, rows "
        "in chunks)": masked_case(records_wide, WIDE, wide_partition),
        f"K14 gt_counts_masked S={WIDE} V={BLOCK_ROWS} P=1 K={len(wide_cohorts[0])} (rows in "
        "chunks)": masked_case(records_wide_block, WIDE, wide_cohorts[:1]),
        f"K14 gt_counts_masked S={WIDE} V={BLOCK_ROWS} P={POPULATIONS} (a partition, rows in "
        "chunks)": masked_case(records_wide_block, WIDE, wide_partition),
        "K11 score_dosage K=2504": score_case(ops, s, flip, None),
        "K11 score_dosage K=2504, output 4 B past 16 (tiled)": score_case(ops, s, flip, None, 4),
        "K11 score_dosage K=2454 sel": score_case(ops, s, flip, cohort),
        f"K11 score_dosage K={WIDE - 3} sel of S={WIDE} V={WIDE_GLM_ROWS}":
            score_case(ops_wide, WIDE, flip_wide, sel_wide),
    }
    return cases


def _relatedness_cases() -> dict:
    """K12, K13 and K15 launchers and the products beside them, at the
    paths' block shapes, for --trace only: {name: call(lib)}. K12's bits at
    32,768 rows of 2504 samples and of a sorted 1,001 re-packed by K5 (K5
    too), its Gram kernel from each with king's and genome's sets; K13 at
    16,384 rows, all or the 1,001; one torch._int_mm Gram of the CPU scan's
    int8 planes (made by relatedness_planes_plain), one z'z in f64 (the exact
    GRM's) and in full fp32 (pgen_tpu's), and the two products of an
    --approx pass before K13's pass kernels, z'(z q), q of 18 columns; K15
    at 16,384 output rows of 2504 samples at bands 9, 49 and 420 and of a
    sorted 1,001 re-packed by K5 at band 9; K13's pass on the same two
    record sets."""
    import numpy as np
    import torch

    from pgen_tpu_torch.device import matmul_fp32
    from pgen_tpu_torch.ops.pack import subset_repack
    from pgen_tpu_torch.ops.pca import add_gram_fp64, approx_scratch
    from pgen_tpu_torch.ops.relatedness import (
        GRAM_SETS,
        relatedness_bits,
        relatedness_planes_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    s = WIDTHS[0]
    rec = (s + 3) // 4
    records = torch.randint(0, 256, (REL_ROWS, rec), dtype=torch.uint8, device=dev, generator=gen)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values
    keep = keep.to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bits_case(rows, kept):
        n_var, n_rec = rows.shape
        bits = relatedness_bits(rows, kept)
        return bits, lambda lib: lib.pgen_relatedness_bits(
            rows.data_ptr(), bits.data_ptr(), n_var, n_rec, kept, bits.shape[1], bits.shape[2],
            stream)

    def gram_case(bits, set_):
        s_pad = 16 * bits.shape[1]
        grams = torch.zeros((len(GRAM_SETS[set_]), s_pad, s_pad), dtype=torch.int32, device=dev)
        return lambda lib: lib.pgen_relatedness_gram(bits.data_ptr(), grams.data_ptr(),
                                                     bits.shape[1], bits.shape[2], set_, stream)

    def repack_case(rows, sel):
        out = torch.empty((rows.shape[0], (sel.shape[0] + 3) // 4), dtype=torch.uint8,
                          device=dev)
        return lambda lib: lib.pgen_subset_repack(rows.data_ptr(), sel.data_ptr(),
                                                  out.data_ptr(), rows.shape[0], rows.shape[1],
                                                  sel.shape[0], stream)

    def z_case(rows, sel):
        n_var, n_rec = rows.shape
        kept = s if sel is None else sel.shape[0]
        z = torch.empty((n_var, kept), dtype=torch.float32, device=dev)
        out = torch.empty((3, n_var), dtype=torch.int32, device=dev)
        return z, lambda lib: lib.pgen_grm_z(rows.data_ptr(), None if sel is None else sel.data_ptr(),
                                             z.data_ptr(), out.data_ptr(), n_var, n_rec, s, kept,
                                             stream)

    def band_case(rows, kept, band):
        out = torch.empty((GLM_ROWS, band), dtype=torch.float64, device=dev)
        return lambda lib: lib.pgen_ld_r2_band(rows.data_ptr(), out.data_ptr(), rows.shape[0],
                                               GLM_ROWS, rows.shape[1], kept, band, stream)

    def pass_case(rows, kept):
        q = torch.randn((kept, 18), device=dev, generator=gen)
        y = torch.zeros((kept, 18), device=dev)
        used = torch.zeros((), dtype=torch.int64, device=dev)
        scratch = approx_scratch(rows.shape[0], kept, dev)
        return lambda lib: lib.pgen_pca_approx_pass(
            rows.data_ptr(), q.data_ptr(), y.data_ptr(), used.data_ptr(),
            scratch.data_ptr(), rows.shape[0], rows.shape[1], kept, 18, scratch.numel(), stream)

    records_keep = subset_repack(records, keep)
    bits, k12_bits = bits_case(records, s)
    keep_bits, k12_bits_keep = bits_case(records_keep, KEEP_SAMPLES)
    planes = relatedness_planes_plain(records, s)
    z, k13 = z_case(records[:GLM_ROWS], None)
    _, k13_sel = z_case(records[:GLM_ROWS], keep)
    q = torch.randn((s, 18), device=dev, generator=gen)
    acc = torch.zeros((s, s), dtype=torch.float64, device=dev)
    ld_rows = records[: GLM_ROWS + 420]
    ld_keep = subset_repack(ld_rows, keep)

    def product(fn):
        def call(lib):
            fn()
            return 0
        return call

    return {
        f"K5 subset_repack V={REL_ROWS} K={KEEP_SAMPLES} sorted": repack_case(records, keep),
        f"K12 relatedness_bits V={REL_ROWS} K=2504": k12_bits,
        f"K12 relatedness_bits V={REL_ROWS} K={KEEP_SAMPLES} (re-packed)": k12_bits_keep,
        **{f"K12 relatedness_gram {label} V={REL_ROWS} K={kept}": gram_case(b, set_)
           for b, kept in ((bits, s), (keep_bits, KEEP_SAMPLES))
           for set_, label in enumerate(("king", "genome"))},
        f"K13 grm_z V={GLM_ROWS} K=2504": k13,
        f"K13 grm_z V={GLM_ROWS} K={KEEP_SAMPLES} sel": k13_sel,
        f"torch._int_mm Gram of int8 planes ({planes.shape[1]} x {planes.shape[2]} by its "
        "transpose)":
            product(lambda: torch._int_mm(planes[0], planes[3].t())),
        f"z'z f64 ({GLM_ROWS} x {s}, cast in chunks)": product(lambda: add_gram_fp64(acc, z)),
        f"z'z fp32 ({GLM_ROWS} x {s})": product(lambda: matmul_fp32(z.T, z)),
        f"z'(z q) fp32 ({GLM_ROWS} x {s}, q {s} x 18)":
            product(lambda: matmul_fp32(z.T, matmul_fp32(z, q))),
        **{f"K15 ld_r2_band V={GLM_ROWS} K=2504 band {band}": band_case(ld_rows, s, band)
           for band in (9, 49, 420)},
        f"K15 ld_r2_band V={GLM_ROWS} K={KEEP_SAMPLES} (re-packed) band 9":
            band_case(ld_keep, KEEP_SAMPLES, 9),
        f"K13 pca_approx_pass V={GLM_ROWS} K=2504 L=18": pass_case(records[:GLM_ROWS], s),
        f"K13 pca_approx_pass V={GLM_ROWS} K={KEEP_SAMPLES} (re-packed) L=18":
            pass_case(subset_repack(records[:GLM_ROWS], keep), KEEP_SAMPLES),
    }


def phase_trace() -> None:
    """This checkout's launcher of each --ab case, 10 launches under
    torch.profiler after one untimed: each device operation's time per
    launch (kernels by name, and the memsets a launcher issues), without
    the host's enqueue time that CUDA events around a launch hold."""
    from pgen_tpu_torch import kernels

    this = kernels.load()
    calls = {name: call for name, (_, call) in _kernel_cases(None).items()}
    for name, call in {**calls, **_relatedness_cases()}.items():
        def run(call=call, name=name):
            if call(this) != 0:
                raise AssertionError(f"{name}: launch failed")

        ops = _device_ops(run)
        shown = "; ".join(f"{k} {ms:.4f} ms" for k, ms in ops.items()) or "no events"
        print(f"[trace] {name}: device {sum(ops.values()):.4f} ms a launch ({shown})")


# Micro-timing kernels of --rates: each thread (each warp for the product)
# runs independent chains of one instruction.
_RATES_CU = r"""
#include <cstdint>
extern "C" __global__ void popc_rate(const uint32_t* in, uint32_t* out, int iters) {
  uint32_t x[8], acc[8];
  for (int k = 0; k < 8; ++k) { x[k] = in[(threadIdx.x + 7 * k) & 255]; acc[k] = 0; }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] += __popc(x[k] ^ acc[k]);
      acc[k] += __popc(x[k] + acc[k]);
    }
  }
  uint32_t s = 0;
  for (int k = 0; k < 8; ++k) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" __global__ void mma_b1_rate(const uint32_t* in, uint32_t* out, int iters) {
  uint32_t a[4], b[2];
  for (int k = 0; k < 4; ++k) a[k] = in[(threadIdx.x + k) & 255];
  for (int k = 0; k < 2; ++k) b[k] = in[(threadIdx.x + 5 + k) & 255];
  int c[4][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  int s = 0;
  for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<uint32_t>(s);
}

#define RATE_LAUNCHER(name)                                                              \
  extern "C" int run_##name(const void* in, void* out, int iters, int blocks, int threads, \
                            void* stream) {                                              \
    name<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(                      \
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), iters);            \
    return static_cast<int>(cudaGetLastError());                                         \
  }
RATE_LAUNCHER(popc_rate)
RATE_LAUNCHER(mma_b1_rate)
"""


def phase_rates() -> None:
    """The card's rate of 32-bit population counts and of mma.sync
    m16n8k256 .b1 AND-POPC (as 2 M N K operations): the grid's operations
    over the kernel's time (CUDA events, median of 10 launches), eight
    blocks an SM."""
    import ctypes

    import torch

    from pgen_tpu_torch import kernels

    src = kernels.BUILD_DIR / "rates.cu"
    so = kernels.BUILD_DIR / "librates.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(_RATES_CU)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {r.returncode}:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    words = torch.randint(0, 1 << 31, (256,), dtype=torch.int64, device=dev).to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters = 4096
    cases = (
        # name, kernel, threads, operations a loop iteration a thread
        ("popcounts", "popc_rate", 256, 16),
        ("mma.sync b1 m16n8k256 operations", "mma_b1_rate", 128, 4 * 2 * 16 * 8 * 256 / 32),
    )
    for name, fn, threads, ops in cases:
        blocks = 8 * sms
        out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
        run = getattr(lib, f"run_{fn}")
        run.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]

        def launch(run=run, out=out, blocks=blocks, threads=threads, name=name):
            if run(words.data_ptr(), out.data_ptr(), iters, blocks, threads, stream) != 0:
                raise AssertionError(f"{name}: launch failed")

        ms = _time_ms(launch)
        total = ops * threads * blocks * iters
        print(f"[rates] {name}: {total / ms / 1e9:.3f} T a second ({ms:.4f} ms for {total:.4g}, "
              f"{blocks} blocks of {threads} on {sms} SMs)")


EIGH_SAMPLES, EIGH_K = 2504, 10  # exact pca's GRM on the chr22 fixture, -k 10


def _grm_like(n: int, seed: int = SEED):
    """An (n, n) f64 SPD matrix on the card shaped like a GRM: a Gram of
    standard normal rows over their count, plus ten planted components
    with eigenvalues 40 down to 4, so that the top of the spectrum stands
    apart as population structure does."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((4 * n, n), dtype=torch.float64, device="cuda", generator=gen)
    u = torch.linalg.qr(torch.randn((n, EIGH_K), dtype=torch.float64, device="cuda",
                                    generator=gen))[0]
    lam = torch.linspace(40.0, 4.0, EIGH_K, dtype=torch.float64, device="cuda")
    return x.T @ x / x.shape[0] + (u * lam) @ u.T


def phase_eigh() -> None:
    """The full symmetric eigendecomposition of exact pca's GRM, 2504 x 2504
    f64, on the card (``torch.linalg.eigh``: CUDA events, and the host's
    wall around the call and a synchronise) and on the host
    (``np.linalg.eigh`` on the same matrix copied back), median of 10 after
    a warm-up call; then ``pca_from_grm`` (k = 10) on the tensor against the
    same call on the numpy array, each by host wall, and their top pairs'
    largest differences."""
    import numpy as np
    import torch

    from pgen_tpu_torch.ops.pca import pca_from_grm

    g = _grm_like(EIGH_SAMPLES)
    host = g.cpu().numpy()
    torch.cuda.synchronize()

    def wall_ms(fn, reps: int = 10) -> float:
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    print(f"[eigh] {EIGH_SAMPLES} x {EIGH_SAMPLES} f64, {os.cpu_count()} host cores; "
          f"torch {torch.__version__}, numpy {np.__version__}")
    events = _time_ms(lambda: torch.linalg.eigh(g))
    card = wall_ms(lambda: torch.linalg.eigh(g))
    lapack = wall_ms(lambda: np.linalg.eigh(host))
    print(f"[eigh] torch.linalg.eigh on the card: {events:.1f} ms by CUDA events, {card:.1f} ms "
          f"host wall; np.linalg.eigh on the host: {lapack:.1f} ms host wall "
          f"({lapack / card:.1f}x the card's wall)")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.linalg.eigh(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[eigh] the card's eigh at its peak: {peak / 1e6:.1f} MB over the matrix's "
          f"{g.numel() * 8 / 1e6:.1f} MB")
    m_used = 1000
    want = pca_from_grm(host * m_used, m_used, EIGH_K)
    got = pca_from_grm(g * m_used, m_used, EIGH_K)
    tensor_ms = wall_ms(lambda: pca_from_grm(g * m_used, m_used, EIGH_K))
    array_ms = wall_ms(lambda: pca_from_grm(host * m_used, m_used, EIGH_K))
    print(f"[eigh] pca_from_grm k={EIGH_K}: tensor on the card {tensor_ms:.1f} ms, numpy "
          f"array {array_ms:.1f} ms; eigenvalues' largest relative difference "
          f"{np.max(np.abs(got[0] - want[0]) / np.abs(want[0])):.3g}, sign-fixed vectors' "
          f"{np.max(np.abs(got[1] - want[1])):.3g}")


def phase_ab(other_root: Path) -> None:
    """K4, K5, K8-K11 of this checkout against the same launchers built
    from another checkout's sources (the parent commit's, unpacked at
    ``other_root``), in one process on one card: each case timed other,
    this, this, other on the same tensors at the paths' block shapes, the
    launchers alone (no wrapper), CUDA events, median of 10 pairs, once with
    one launch and once with 4 launches in each pair; outputs held
    torch.equal. The C signatures below are those of both checkouts'
    launchers: a launcher whose signature differs between the two needs
    its own (in both, K9's clears its counts itself, K11's takes 2V
    called ints and K14's the masks' E words and kept counts). Each case's
    host time a call follows; then K14's wrappers (_wrapper_ab) and K15's
    and K13's pass's chains (_chain_ab)."""
    import ctypes

    import torch

    from pgen_tpu_torch import kernels

    this = kernels.load()
    other = ctypes.CDLL(str(_build_other(other_root / "pgen_tpu_torch" / "csrc")))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    other.pgen_pack_codes.argtypes = [ptr, ptr, i64, i64, ptr]
    other.pgen_glm_planes.argtypes = [ptr] * 5 + [i64] * 5 + [ptr]
    other.pgen_score_dosage.argtypes = [ptr] * 5 + [i64] * 5 + [ptr]
    other.pgen_sample_counts.argtypes = [ptr, ptr, i64, i64, ptr]
    other.pgen_subset_repack.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    other.pgen_gt_counts.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    other.pgen_gt_counts_masked.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    print("[ab] K13's z is left out (--trace times it); K12, K15 and K13's pass against the "
          "other checkout's chains follow (_chain_ab)")
    for name, (outs, call) in _kernel_cases(other).items():
        def run(lib):
            status = call(lib)
            if status != 0:
                raise AssertionError(f"{name}: launch failed with CUDA error {status}")

        run(other)
        torch.cuda.synchronize()
        want = [o.clone() for o in outs]
        for o in outs:
            o.fill_(0)
        run(this)
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise AssertionError(f"{name}: this checkout's kernel differs from the other's")
        _print_ab("[ab]", name, lambda: run(other), lambda: run(this))
    _wrapper_ab(other_root)
    _chain_ab(other_root)
    _k12_chain_ab(other_root)


def _host_us(fn, calls: int = 50, reps: int = 5) -> float:
    """Median host time of one call of fn in us: perf_counter around
    ``calls`` calls queued with no synchronisation between them (the card
    runs behind), synchronised after each of ``reps`` sets."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _print_ab(tag: str, name: str, other_fn, this_fn) -> None:
    """Times other_fn and this_fn other, this, this, other: CUDA events
    with one call and with BURST calls in each pair, then host time a call."""
    for burst in (1, BURST):
        o1 = _time_ms(other_fn, burst=burst)
        t1 = _time_ms(this_fn, burst=burst)
        t2 = _time_ms(this_fn, burst=burst)
        o2 = _time_ms(other_fn, burst=burst)
        print(f"{tag} {name}, {burst} launch(es) per event pair: other {o1:.4f} / {o2:.4f} ms, "
              f"this {t1:.4f} / {t2:.4f} ms (other, this, this, other; outputs equal): "
              f"{statistics.median([o1, o2]) / statistics.median([t1, t2]):.2f}x")
    o1, t1, t2, o2 = (_host_us(f) for f in (other_fn, this_fn, this_fn, other_fn))
    print(f"{tag} {name}, host time a call: other {o1:.1f} / {o2:.1f} us, this {t1:.1f} / "
          f"{t2:.1f} us")


def _other_module(root: Path, name: str = "pgen_tpu_torch.ops.gt_stats"):
    """The module ``name`` of the checkout at ``root``, imported beside this
    checkout's: while it loads, its pgen_tpu_torch modules stand in
    sys.modules in place of this checkout's, which are put back after. Its
    functions keep their own modules (and kernel library) as globals."""
    import importlib

    def ours():
        return [k for k in sys.modules if k == "pgen_tpu_torch" or k.startswith("pgen_tpu_torch.")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)


def _device_ops(fn, calls: int = 10) -> dict:
    """Each device operation's time a call of fn in ms (kernels by name, and
    memsets), from torch.profiler over ``calls`` calls after one untimed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us > 0:
            kernel = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = kernel.strip() or e.key[:40]
            ops[name] = ops.get(name, 0.0) + us / calls / 1000
    return ops


def _print_device_ops(name: str, sides: dict) -> None:
    for side, fn in sides.items():
        ops = _device_ops(fn)
        shown = "; ".join(f"{k} {ms:.4f} ms" for k, ms in ops.items())
        print(f"[ab chain] {name}, {side}: device {sum(ops.values()):.4f} ms a call ({shown})")


def _chain_ab(other_root: Path) -> None:
    """K15 and K13's pass of this checkout against the other checkout's
    chains for the same work, each through its own package (the other's
    imported beside this one's): LD at 16,384 output rows (rounded down to
    whole tiles of the band, as the other's banded_r2 takes them) of 2504
    samples at bands 9 and 49 and of a sorted 1,001 at band 9, the other's
    K15 c, fp32 tile Grams and f64 r² against this K15 (after K5 for the
    cohort), bands within rtol 1e-4 atol 1e-6; --approx at 16,384 rows, q
    of 18 columns, the other's K13 z and two fp32 products against this
    pass (after K5), y within 2 (K + V) u of the f32 sums' absolute terms.
    Each timed as the launchers are (host time included), then each side's
    device operations from a trace: the other chain's tile Grams and its r²
    ops by kernel. A line says so where the other checkout has no such
    chain."""
    import torch

    from pgen_tpu_torch.device import matmul_fp32
    from pgen_tpu_torch.ops import ld, pca
    from pgen_tpu_torch.ops.pack import subset_repack

    other_ld = _other_module(other_root, "pgen_tpu_torch.ops.ld")
    other_pca = _other_module(other_root, "pgen_tpu_torch.ops.pca")
    if not hasattr(other_ld, "ld_centered") or not hasattr(other_pca, "grm_z"):
        # a checkout that holds these redesigns already has no chain to run
        print("[ab chain] K15 and K13's pass: the other checkout has no K15 ld_centered or K13 "
              "grm_z chain to run beside them")
        return
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    s = WIDTHS[0]
    rec = (s + 3) // 4
    records = torch.randint(0, 256, (GLM_ROWS + 64, rec), dtype=torch.uint8, device=dev,
                            generator=gen)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values
    keep = keep.to(torch.int32)
    c_scratch = torch.empty((GLM_ROWS + 64) * s, dtype=torch.float32, device=dev)
    r2_out = torch.empty(GLM_ROWS * 49, dtype=torch.float64, device=dev)

    def other_band(block, sel, band, n_out):
        c, norm2 = other_ld.ld_centered(block, s, sel, out=c_scratch)
        norm = torch.sqrt(norm2)
        n_tiles = n_out // band
        r2 = torch.empty((n_tiles, band, band), dtype=torch.float64, device=dev)
        group = max(1, other_ld.GRAM_ENTRIES // (2 * band * band))
        for t in range(0, n_tiles, group):
            k = min(group, n_tiles - t)
            r2[t : t + k] = other_ld._tile_r2(c, norm, t, k, band)
        return r2.view(n_tiles * band, band)

    def this_band(block, sel, band, n_out):
        kept = s if sel is None else sel.shape[0]
        rows = block if sel is None else subset_repack(block, sel)
        return ld.ld_r2_band(rows, kept, band, n_out, r2_out)

    for band, sel in ((9, None), (49, None), (9, keep)):
        n_out = GLM_ROWS // band * band
        block = records[: n_out + band]
        name = f"LD band {band} V={n_out} K={s if sel is None else KEEP_SAMPLES}"
        got, want = this_band(block, sel, band, n_out), other_band(block, sel, band, n_out)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)

        def other_fn(block=block, sel=sel, band=band, n_out=n_out):
            return other_band(block, sel, band, n_out)

        def this_fn(block=block, sel=sel, band=band, n_out=n_out):
            return this_band(block, sel, band, n_out)

        _print_ab("[ab chain]", name, other_fn, this_fn)
        _print_device_ops(name, {"other": other_fn, "this": this_fn})

    q = torch.randn((s, 18), device=dev, generator=gen)
    block = records[:GLM_ROWS]
    scratch = pca.approx_scratch(GLM_ROWS, s, dev)
    z_scratch = torch.empty(GLM_ROWS * s, dtype=torch.float32, device=dev)

    def other_pass(sel, qq, y, used):
        z, flags = other_pca.grm_z(block, s, sel, out=z_scratch)
        y += matmul_fp32(z.T, matmul_fp32(z, qq))
        used += flags.sum()

    def this_pass(sel, qq, y, used):
        kept = s if sel is None else sel.shape[0]
        rows = block if sel is None else subset_repack(block, sel)
        pca.pca_approx_pass(rows, kept, qq, y, used, scratch)

    for sel in (None, keep):
        kept = s if sel is None else KEEP_SAMPLES
        qq = q[:kept].contiguous()
        name = f"--approx pass V={GLM_ROWS} K={kept} L=18"
        y = [torch.zeros((kept, 18), device=dev) for _ in range(2)]
        used = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
        this_pass(sel, qq, y[0], used[0])
        other_pass(sel, qq, y[1], used[1])
        rows = block if sel is None else subset_repack(block, sel)
        z = pca.grm_z_plain(rows, kept)[0].double().abs()
        bound = 2 * (kept + GLM_ROWS) * 2.0 ** -24 * (z.T @ (z @ qq.double().abs()))
        if int(used[0]) != int(used[1]) or bool(((y[0] - y[1]).double().abs() > bound).any()):
            raise AssertionError(f"{name}: this pass differs from the other chain")

        def other_fn(sel=sel, qq=qq, y=y, used=used):
            other_pass(sel, qq, y[1], used[1])

        def this_fn(sel=sel, qq=qq, y=y, used=used):
            this_pass(sel, qq, y[0], used[0])

        _print_ab("[ab chain]", name, other_fn, this_fn)
        _print_device_ops(name, {"other": other_fn, "this": this_fn})


def _k12_chain_ab(other_root: Path) -> None:
    """K12's bits and Gram kernel of this checkout against the other
    checkout's K12 chain for the same work, each through its own package: at
    32,768 rows of 2504 samples and of a sorted 1,001, king's four Grams and
    genome's five; the other's K12 int8 planes (the ids taken by K12) and a
    torch._int_mm a Gram against this side's K5 re-pack (for the cohort),
    bits and one Gram launch, the Grams held equal. Each timed as the
    launchers are (host time included), then each side's device operations
    from a trace. Last each package's king_counts_device and
    ibd_counts_device over three such blocks of all samples: the Grams
    equal, and each scan's peak device memory above what was allocated
    before it."""
    import numpy as np
    import torch

    from pgen_tpu_torch.ops import ibd, king
    from pgen_tpu_torch.ops import relatedness as rel
    from pgen_tpu_torch.ops.pack import subset_repack

    other_rel = _other_module(other_root, "pgen_tpu_torch.ops.relatedness")
    if not hasattr(other_rel, "relatedness_planes"):
        raise AssertionError("the other checkout has no K12 relatedness_planes")
    other_king = _other_module(other_root, "pgen_tpu_torch.ops.king")
    other_ibd = _other_module(other_root, "pgen_tpu_torch.ops.ibd")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    s = WIDTHS[0]
    records = torch.randint(0, 256, (REL_ROWS, (s + 3) // 4), dtype=torch.uint8, device=dev,
                            generator=gen)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values
    keep = keep.to(torch.int32)
    bits_out = torch.empty(int(np.prod(rel.bits_shape(REL_ROWS, s))), dtype=torch.int32,
                           device=dev)
    repacked = torch.empty(REL_ROWS * ((KEEP_SAMPLES + 3) // 4), dtype=torch.uint8, device=dev)
    for set_, pairs in enumerate(rel.GRAM_SETS):
        for sel in (None, keep):
            kept = s if sel is None else KEEP_SAMPLES
            o_pad, t_pad = other_rel.plane_shape(0, kept)[0], rel.gram_pad(kept)
            other_grams = [torch.zeros((o_pad, o_pad), dtype=torch.int32, device=dev)
                           for _ in pairs]
            this_grams = torch.zeros((len(pairs), t_pad, t_pad), dtype=torch.int32, device=dev)

            def other_fn(sel=sel, pairs=pairs, grams=other_grams):
                planes = other_rel.relatedness_planes(records, s, sel)
                for gram, (x, y) in zip(grams, pairs):
                    gram += torch._int_mm(planes[x], planes[y].t())

            def this_fn(sel=sel, kept=kept, pairs=pairs, grams=this_grams):
                rows = records if sel is None else subset_repack(records, sel, out=repacked)
                rel.relatedness_gram(rel.relatedness_bits(rows, kept, bits_out), pairs, grams)

            other_fn()
            this_fn()
            torch.cuda.synchronize()
            if not all(torch.equal(o[:kept, :kept], t[:kept, :kept])
                       for o, t in zip(other_grams, rel.mirror_symmetric(this_grams.clone(), pairs))):
                raise AssertionError(f"K12: this checkout's Grams differ from the other's at K={kept}")
            name = f"K12 {('king', 'genome')[set_]} V={REL_ROWS} K={kept}"
            _print_ab("[ab chain]", name, other_fn, this_fn)
            _print_device_ops(name, {"other": other_fn, "this": this_fn})
    host = np.concatenate([records.cpu().numpy()] * 3)
    for label, fns in (("king_counts_device", (other_king.king_counts_device,
                                               king.king_counts_device)),
                       ("ibd_counts_device", (other_ibd.ibd_counts_device,
                                              ibd.ibd_counts_device))):
        peaks, outs = [], []
        for fn in fns:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            outs.append(fn(host, s, "cuda"))
            peaks.append(torch.cuda.max_memory_allocated() - before)
        if not all(np.array_equal(o, t) for o, t in zip(*outs)):
            raise AssertionError(f"{label}: this checkout's Grams differ from the other's")
        print(f"[ab chain] {label} over {host.shape[0]} rows of {s} samples (Grams equal): peak "
              f"device memory other {peaks[0] / 1e6:.1f} MB, this {peaks[1] / 1e6:.1f} MB")


def _wrapper_ab(other_root: Path) -> None:
    """K14's wrapper gt_counts_masked of this checkout against the other's,
    as the callers run it (the operand made once and passed in), on the
    --ab cases' records and masks: 65,536 rows of 2504 samples at P = 1, 5
    and 26, 4,096 and 65,536 rows of 40,003 at P = 1 and 26; outputs held
    torch.equal, each timed as the launchers are, host time included."""
    import torch

    from pgen_tpu_torch.ops import gt_stats

    other = _other_module(other_root)
    if Path(other.__file__).resolve().parent == Path(gt_stats.__file__).resolve().parent:
        raise AssertionError("the other checkout's gt_stats is this one's")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    cases = {}
    for n_samples, rows in ((WIDTHS[0], BLOCK_ROWS), (WIDE, WIDE_PACK_ROWS), (WIDE, BLOCK_ROWS)):
        records = torch.randint(0, 256, (rows, (n_samples + 3) // 4), dtype=torch.uint8,
                                device=dev, generator=gen)
        cohorts, partition = _masked_sets(n_samples)
        sets = {"P=1": cohorts[:1], f"P={POPULATIONS} (a partition)": partition}
        if n_samples == WIDTHS[0]:
            sets[f"P={COHORTS}"] = cohorts
        for what, ids in sets.items():
            cases[f"S={n_samples} V={rows} {what}"] = (records, _keep_masks(n_samples, ids, dev))
    for name, (records, masks) in cases.items():
        other_words, other_kept = other.mask_words(masks), other.kept_counts(masks)
        words, kept = gt_stats.mask_words(masks), gt_stats.kept_counts(masks)

        def other_fn(records=records, masks=masks, w=other_words, k=other_kept):
            return other.gt_counts_masked(records, masks, w, k)

        def this_fn(records=records, masks=masks, words=words, kept=kept):
            return gt_stats.gt_counts_masked(records, masks, words, kept)

        if not torch.equal(other_fn(), this_fn()):
            raise AssertionError(f"K14 wrapper {name}: this checkout's counts differ from the "
                                 "other's")
        _print_ab("[ab wrapper]", f"K14 gt_counts_masked {name}", other_fn, this_fn)


def phase_forms() -> None:
    """K5's two forms on the same records: this checkout's sources built with
    kRepackDenseRatio 0 (the direct form at every K) and with a ratio no K
    reaches (the staged form wherever a row tile fits), each launcher alone
    timed direct, staged, staged, direct (CUDA events, median of 10 pairs of
    one launch, then of 4), outputs held torch.equal; 65,536 rows of 2504
    samples at K sorted ids from 2 to all."""
    import ctypes

    import torch

    csrc = ROOT / "pgen_tpu_torch" / "csrc"
    libs = {}
    for form, ratio in (("direct", 0), ("staged", 1 << 40)):
        libs[form] = ctypes.CDLL(str(_build_other(csrc, (f"PGEN_REPACK_DENSE_RATIO={ratio}",))))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        libs[form].pgen_subset_repack.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = WIDTHS[0]
    records = torch.randint(0, 256, (BLOCK_ROWS, (s + 3) // 4), dtype=torch.uint8, device=dev,
                            generator=gen)
    for k in (2, 8, 32, 128, 256, 384, 512, 640, 768, KEEP_SAMPLES, s):
        sel = torch.randperm(s, generator=gen, device=dev)[:k].sort().values
        sel = sel.to(torch.int32)
        n_var, n_rec = records.shape
        outs = {f: torch.empty((n_var, (k + 3) // 4), dtype=torch.uint8, device=dev) for f in libs}

        def run(form):
            status = libs[form].pgen_subset_repack(records.data_ptr(), sel.data_ptr(),
                                                   outs[form].data_ptr(), n_var, n_rec, k, stream)
            if status != 0:
                raise AssertionError(f"K5 {form} at K={k}: launch failed with CUDA error {status}")

        run("direct")
        run("staged")
        torch.cuda.synchronize()
        if not torch.equal(outs["direct"], outs["staged"]):
            raise AssertionError(f"K5 at K={k}: the two forms differ")
        for burst in (1, BURST):
            d1 = _time_ms(lambda: run("direct"), burst=burst)
            s1 = _time_ms(lambda: run("staged"), burst=burst)
            s2 = _time_ms(lambda: run("staged"), burst=burst)
            d2 = _time_ms(lambda: run("direct"), burst=burst)
            print(f"[forms] K5 at ({n_var}, {n_rec}) S={s}, K={k} sorted, {burst} "
                  f"launch(es) per event pair: direct {d1:.4f} / {d2:.4f} ms, staged {s1:.4f} / "
                  f"{s2:.4f} ms (outputs equal): staged "
                  f"{statistics.median([d1, d2]) / statistics.median([s1, s2]):.2f}x the direct")


# Run in a fresh interpreter from another checkout's root (so that its
# chip_smoke and its pgen_tpu_torch are the ones imported): each phase
# function of its chip_smoke.py, and make_fixtures, prints its seconds.
_PHASE_TIMER = """
import sys, time
import chip_smoke

def timed(name, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"[phase-times] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return call

for name, fn in list(vars(chip_smoke).items()):
    if name.startswith("phase_") or name == "make_fixtures":
        setattr(chip_smoke, name, timed(name, fn))
sys.exit(chip_smoke.main([]))
"""


def phase_times(root: Path) -> int:
    """The chip_smoke.py of the checkout at ``root``, run as a process of its
    own from that root with each of its phases timed (``_PHASE_TIMER``):
    the seconds by phase of a smoke that does not print them itself, such
    as the parent commit's. Returns its exit code."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _PHASE_TIMER], cwd=root)
    print(f"[phase-times] {root}: rc {r.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return r.returncode


def phase_ld_cpu(others: list) -> None:
    """Full-chr22 ld and prune 50 5 0.2 on --device cpu through the CLI of
    each checkout at ``others`` and then of this one, each run a process of
    its own from its checkout's root; prints the wall, the r2_band stage of
    --stats and the outputs' sha256, and whether they equal this
    checkout's."""
    from pgen_tpu_torch.formats.fixtures import ensure_chr22

    with tempfile.TemporaryDirectory(prefix="chip_diag_ld_") as tmp:
        tmp = Path(tmp)
        full = ensure_chr22(tmp / "full", num_variants=CHR22_VARIANTS, uniform_bytes=True)
        for label, argv, suffixes in (
                ("ld (band 9)", ["ld", full], [""]),
                ("prune 50 5 0.2 (band 49)", ["prune", full, "--indep-pairwise", "50", "5",
                                              "0.2"], [".prune.in", ".prune.out"])):
            shas = {}
            for root in [*others, ROOT]:
                out = tmp / f"out{len(shas)}"
                env = {**os.environ, "PYTHONPATH": str(root)}
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, "-m", "pgen_tpu_torch.cli", *map(str, argv),
                                    "-o", str(out), "--stats", "--device", "cpu"],
                                   cwd=root, env=env, capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if r.returncode != 0:
                    raise AssertionError(f"{label} in {root} returned {r.returncode}\n{r.stderr}")
                shas[root] = [hashlib.sha256(Path(f"{out}{x}").read_bytes()).hexdigest()
                              for x in suffixes]
                stage = [ln.strip() for ln in r.stderr.splitlines() if "r2_band" in ln or "banded_r2" in ln]
                print(f"[ld-cpu] {label}, {root}: {seconds:.3f} s wall; {stage}; sha256 "
                      f"{[h[:16] for h in shas[root]]}")
            for root in others:
                print(f"[ld-cpu] {label}: {root} "
                      f"{'equals' if shas[root] == shas[ROOT] else 'differs from'} this checkout")


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--phase-times":
        return phase_times(Path(argv[1]).resolve())
    phase_device()
    if argv == ["--eigh"]:  # no kernel of the checkout runs
        phase_eigh()
        return 0
    phase_build()
    if argv == ["--precision"]:
        with tempfile.TemporaryDirectory(prefix="chip_diag_") as tmp:
            tmp = Path(tmp)
            phase_precision(tmp, make_fixtures(tmp)["full"])
    elif len(argv) == 2 and argv[0] == "--ab":
        phase_ab(Path(argv[1]).resolve())
    elif argv == ["--trace"]:
        phase_trace()
    elif argv == ["--forms"]:
        phase_forms()
    elif argv == ["--rates"]:
        phase_rates()
    elif len(argv) >= 1 and argv[0] == "--ld-cpu":
        phase_ld_cpu([Path(a).resolve() for a in argv[1:]])
    else:
        print(f"chip_diag: unknown arguments {argv}; takes --ab OTHER_CHECKOUT, --trace, "
              "--forms, --precision, --rates, --eigh, --ld-cpu [OTHER_CHECKOUT ...] or "
              "--phase-times OTHER_CHECKOUT",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
