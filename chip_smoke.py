#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pgen_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing its own lines:

  1 device   CUDA present and compute capability 9.0; the card's name and
             power limit as nvidia-smi reports them
  2 build    nvcc build of pgen_tpu_torch/csrc from this checkout
  3 kernels  K1-K15 (K12 as its two kernels, relatedness_bits and
             relatedness_gram) and K13's --approx pass against their plain
             PyTorch versions on the card
             (torch.equal) at widths 2504, 2503, 5 and 1 samples (K2 also into
             an output 4 B past a 16-B boundary; K3 at K = 2, 1000 and 20,000
             ids, reversed and repeated, each also 4 B past; K5 at K = 2,
             1,001 and all samples permuted; K6 at R = 626 and 2 with 65,536
             variants; K10 at P = 2 and 3 and K11 with and without mean
             imputation, each with and without a sample selection holding a
             gap and a duplicate, on 16,640 rows; K4 also at S = 2502 and 2501
             and with its codes 1, 4 and 8 B past a 16-B boundary; K10 also
             with sel of 2,454 and 2,456 ids sorted, reversed and repeated;
             K4 and K10 also at 40,003 samples, past their 16,384- and
             8,192-column tiles, where they are timed too; K9 also at
             16,384 rows and at R % 4 = 1, 3 and 0; K11 also in its tiled
             form without sel (its output 4 B past a 16-B boundary), with
             sel of 2,454 and 2,456 ids sorted, reversed and repeated, at
             40,003 samples in column chunks, flip random, none and all;
             K5 and K8 also on records 1-15 B past a 16-B boundary, K5
             with reversed, repeated and unsorted ids, past the 4,096 ids a
             staged block holds and at 40,003 samples; K13 on the 16,640
             rows of K10/K11, with and without that sample selection; K12's
             bits on the same rows (the selection's records re-packed by K5
             first) and its Gram kernel from them, king's and genome's
             sets added into random Grams; K15 (ld_r2_band) on the same
             rows, the selection's
             records re-packed by K5 first, at bands 9, 49 and 420 and at
             MAX_BAND on 300 output rows, bit for bit, and K13's pass
             (pca_approx_pass, q of 18 columns) from a y0 at the scale of
             y within approx_pass_tolerance of the plain pass (8 sigma of
             the probabilistic rounding model), a second pass equal bit
             for bit, and at 2504 and 2503 samples four planted faults
             (half the rows or a 256-row chunk dropped, y0 lost, a column
             shifted) outside that tolerance;
             K14 at every width with P = 1 and 5 keep masks
             (a cohort of 1,001, all, none, gaps and a duplicate,
             unsorted), at 2504 and 2503 also on records 1-15 B past a
             16-B boundary);
             kernel and plain times at
             the paths' block shapes (65,536 rows; K5 at K = 1,001 (its
             staged form) and 2 (its direct form), and 4,096 rows at 40,000
             of 40,003; K9 also at score's 16,384;
             K10/K11 16,384 rows at K = 2504 and at a selection of 2,454;
             K11 also tiled and at 40,000 of 40,003; K12's bits and Grams
             (king's and genome's) at 32,768 rows and K13 at 16,384, each at
             K = 2504 and a sorted 1,001 (re-packed by K5 for K12); K15 at
             16,384 output rows at bands 9, 49 and 420 and at K = 1,001
             (band 9), and K13's pass at 16,384 rows, each beside the
             parent's chain for the same work where this checkout holds it
             (K13's z and two fp32 products); K14 at
             65,536 rows with P = 1 and 5 cohorts of 1,001), CUDA
             events, median of 10
             pairs around one launch each, two alternated sets (the wrapper's
             host time lies inside; beside it burst_ms, 4 launches queued in
             each pair), each beside its bound (the bytes it must move at
             3.35 TB/s; for K12's Grams, K15 and K13's pass the larger of
             that and its operations at the card's .b1 or fp32 rate) and,
             for K1, K2 and K7, one PyTorch call of the same function (a
             table gather, held torch.equal to the kernel); then the library
             products beside K12 and K13 (one torch._int_mm Gram of the
             plain int8 planes, as the CPU's scan makes it, z'z in
             f64 and fp32, an --approx pass's two products before K13's
             pass kernels) against the card's dense peaks
  4 filter   the port's CLI (pgen_tpu_torch.cli.main --device cuda) on
             chr22-scale fixtures made by the port's copy of
             tools/make_fixtures.py: full 1000 Genomes chr22 (1,103,547 variants x 2504
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
  7 device   filter --provider device as a lone process, which makes no
             process group (its process_group stage is printed): (a) chr22
    provider ALT == "G" keep-two (device predicate, K3), (b) --maf / --mind
             at median thresholds over a 5,000-variant region (K8 / K9),
             (c) 140,001-variant ALT == "G" keep-all .vcf and .vcf.gz --index
             (K2), (d) a region keep-two (host mask after DeviceFallback);
             each checked with numpy, then by sha256 against --device cpu and
             the single-GPU filter; (a) once more under --profile; (a) on 2
             (and 4) ranks where the cards exist. K2, K3, K8, K9 must have
             launched.
  8 GWAS     glm and score through the port's CLI on the full chr22 fixture,
             with a seeded --pheno table (QT: effects planted on 10 variants,
             2% NA; QT0: no NA; CC: 1/2 case/control, 2% NA) and a --covar
             table (C1, C2): (a) linear QT ~ C1 + C2 over all variants against
             a numpy f64 least-squares oracle on 2,000 seeded variants, the
             planted variants the 10 smallest P; (b) --modifier genotypic and
             --interaction with QT0 over a 50,000-variant region and (c)
             logistic CC over a 20,000-variant region, each against
             --device cpu, BETA and SE within rtol 2e-4 atol 1e-6 of the
             value alone (logistic 2e-3 / 2e-5), --interaction (its products
             f64) also against a numpy f64 oracle on 1,500 variants at that
             bound; (d) score with three weight columns on every 10th
             variant, half the effect alleles REF, with and without
             --no-mean-imputation, against a numpy f64 oracle. K10 and K11
             must have launched.
  9 related- king, genome and pca through the port's CLI on the full chr22
    ness     fixture: (a) king over every variant (3,133,756 pairs), the
             NSNP/HETHET/IBS0/KINSHIP text of 64 seeded pairs equal to a
             numpy f64 oracle's; a 20,000-variant region with --samples-file
             of 1,001 seeded IIDs, with all samples over --min-kinship at
             that cohort's 99.9th-percentile kinship, and the cohort's
             --cutoff there, each output sha256-equal to --device cpu; (b)
             genome the same way (--min-pi-hat), IBS0/1/2 of the 64 pairs
             equal to the oracle's; (c) pca -k 10 --make-rel bin, .rel.bin x
             m_used on 64 seeded samples within 1e-6 max|GRM| of the
             oracle's f64 GRM and m_used its polymorphic count, the region's
             GRM within that bound of --device cpu's and its eigenvalues at
             rtol 1e-3; (d) pca -k 10 --approx, orthonormal eigenvectors
             (1e-6), eigenvalues at most (1 + 1e-3) x (c)'s and descending,
             the region's at rtol 1e-3 of --device cpu's. K12's two kernels,
             K13 and its pass must have launched; the peak device memory of
             (a) and (b) is printed.
 10 counts   query, the reports, stats and fst through the port's CLI on
             the full chr22 fixture: (a) a metadata-only query launches no
             kernel; (b) a query binding GT_AF/GT_MISSING at median
             thresholds (K8) and one under -s binding GT_NOBS (K9); (c)
             freq, gcount, hardy, missing, het and stats --per-sample over
             every variant, all samples (K8, K9, K1) and a --samples-file of
             1,001 seeded IIDs (K14); (d) fst hudson and wc over a seeded
             --pheno POP column of five labels with 2% NA (K14 at P = 5).
             Held against a numpy oracle: 2,000 seeded variants' masked
             counts (the .gcount, .afreq, .hardy and .vmiss rows, the
             query's GT_AC), every sample's missing count (.smiss, stats'
             MISSING, het's OBS_CT, the -s query's GT_NOBS) and the f64 fst
             of those variants (-R, --report-variants); then every output
             of (b)-(d) on a 20,000-variant region sha256-equal to --device
             cpu's (het's E(HOM) and F at rtol 1e-12).
 11 ld       ld, prune --indep-pairwise and clump through the port's CLI on
             a copy of the full chr22 fixture with LD planted (seeded groups
             of 2-5 rows sharing all but 5%, 41% or 75% of their samples'
             codes: r² about 0.90, 0.35, 0.06): (a) ld at the defaults over
             every variant, the pairs of a seeded 20,000-variant region
             exactly those of the port's banded_r2_numpy (f64) and their R2
             within rtol 1e-4 atol 1e-6, then ld at the defaults on that
             region sha256-equal to --device cpu; (b) ld --ld-window 50
             --ld-window-r2 0 --samples-file of 1,001 IIDs on the region
             sha256-equal to --device cpu; (c) prune 50 5 0.2 over every variant, no
             two kept variants of 2,000 seeded windows of its walk over 0.2
             by the f64 oracle, then 50 5 0.2 and 100kb 1 0.5 with the cohort
             on the region, each equal to greedy_prune on the oracle's band
             and sha256-equal to --device cpu; (d) clump of the region with a
             seeded P table, sha256-equal to --device cpu. Every oracle r²
             lies at least 1e-3 from the thresholds used; each full-chr22
             run's peak device memory is printed and held under 4 GB. K15
             (and K5 for the cohort, K8, K14 for prune's MAF) must have
             launched.
 12 mesh     glm, score, king, genome and pca over variant shards, one
             process per card, where two or more cards are visible (else
             one line says it was skipped): each rank a process of the
             port's CLI with RANK, WORLD_SIZE, LOCAL_RANK and MASTER_* set
             (LOCAL_RANK reversed at 4 ranks: rank r on card 3 - r), each
             run against the same run as one lone process, on the full
             chr22 fixture with phase 8's tables: (a) linear glm QT ~ C1 +
             C2 over every variant, (b) --modifier genotypic over phase 8's
             50,000-variant region (BETA/SE rtol 1e-3 atol 1e-5, OBS_CT
             exact), (c) score of every 10th variant with and without
             --no-mean-imputation (ALLELE_CT exact, |d| <= 1e-4 max|value|),
             (d) king --min-kinship and --cutoff at the 99.9th percentile of
             every pair's kinship and (e) genome --min-pi-hat at that of
             PI_HAT (sha256-equal), (f) pca -k 10 --make-rel bin and (g)
             --approx (m_used exact, eigenvalues at rtol 1e-3, GRM x m_used
             within 1e-6 max|GRM|). Each run prints its wall (process start
             and NCCL set-up inside), rank 0's --stats report (the
             process_group and collective stages, one line a rank naming
             its card and rows) and each rank's launches of its kernels,
             which must not be 0; a rank other than 0 must print nothing of
             the port's. (h) times the collectives alone (NCCL, CUDA
             events) beside their bytes over NVLink's 450 GB/s. The default
             run takes 2 ranks; --ranks 2 and 4.
 13 host     the twelve fileset subcommands through the port's CLI on the
             full chr22 fixture, every sample: (a) merge of the first and
             the last 1,252 samples (each written by filter --keep
             --out-format pgen, K5) gives back the .pgen, sha256-equal (K1,
             K4); (b) split --parts 4 then concat gives back the .pgen,
             .pvar and .psam; (c) sort of a seeded shuffle of the rows gives
             back the .pgen and .pvar, and isec with a 20,000-variant
             region fileset gives that region; (d) index of the region's
             .vcf.gz writes filter --index's .tbi byte for byte, view -r
             prints a 100-variant span's rows, describe the fixture's
             header; (e) diff against a copy with code changes planted in
             64 seeded records reports exactly those cells, its
             --per-sample counts equal to numpy's (K1); (f) annotate
             --fill-info over every sample (K8) and a --samples-file of
             1,001 (K14), 2,000 seeded variants' INFO equal to numpy's
             counts, then --fill-info all on the region against --device
             cpu; (g) export A, AD and ped of the region and (h) roh of the
             region with homozygous runs planted in 8 seeded samples (each
             called) against --device cpu by sha256 (K1). Each cut in
             variants is printed; the phase prints its launches of K1, K4,
             K8 and K14, each of which must be above zero, and its time.
 14 files    the rest of filter and import through the port's CLI on the
    and      full chr22 fixture (keep-all VCF text on the 140,001-variant
    workers  one), against phase 4's keep-two and plain keep-all outputs and
             phase 5's --keep .pgen: (a) filter --out-format bed keep-all
             (no kernel; the body numpy's code LUT of the records) and with
             phase 5's --keep of 1,001 (K5, 17 launches; 2,000 seeded rows
             equal to numpy's unpack, take, re-pack, LUT and pad mask), each
             .bed/.bim/.fam sha256-equal to --device cpu, then import of
             each .bed gives back the fixture's .pgen and phase 5's; (b)
             --workers 2 and 4 on keep-two (K3) and the keep-all .vcf.gz
             --index (K2): keep-two sha256-equal to phase 4's, the .gz
             gunzipped equal to phase 4's keep-all and, with its .tbi,
             sha256-equal to --shards N in one process (its BGZF members
             follow the shards' blocks); keep-two again as a process of
             the CLI under PGEN_TPU_MP_CONTEXT=fork (the default is
             forkserver); each worker's launches (from --stats) above
             0, its start against its work and its peak pinned and device
             bytes printed; (c) --shards 3 in one process, then
             --shard-index 0, 1 and 2 as three processes at once into one
             shared .vcf, each sha256-equal to keep-two's; (d) --workers 3
             with PGEN_TPU_TEST_FAIL_SHARD=1 exits 1, its manifest marking
             shard 1 failed, and --resume runs shard 1 alone to keep-two's
             bytes; (e) --threads 1, 2 and 4 on keep-two and the plain
             keep-all, sha256-equal to phase 4's, exactly 17 and 3 launches,
             the emit stage, the pinned bytes the threads' buffers ask for
             and the peak device bytes printed.
             Launches of K2, K3 and K5 must be above 0 (the worker and
             shard processes' own counts added).
 15 surface  the last of pgen_tpu's surface on the full chr22 fixture: (a)
             --provider device's GT_* counts under --shards 2 in this
             process: GT_MAF over every sample (K8), GT_MISSING_RATE over
             the samples (K9), GT_MAF over a --samples-file of 1,001 (K14),
             --rm-dup list with GT_MAF on a copy whose region holds
             duplicated IDs (K8 for the report, then for the shards), and
             --workers 2 with GT_MAF; thresholds at the median of numpy's
             counts, each run writing a 5,000-variant region's rows and
             counting every row: the K8/K9/K14 deltas exactly 17 launches
             a mask computation (each worker's --stats line 17); each VCF's
             GT text against numpy's decode of numpy's kept rows and
             samples, the .rmdup.list against numpy's, then sha256 against
             the lone --provider device filter; each case again on a
             fileset of the 20,000 rows around the region on the card and
             on --device cpu, sha256-equal (each cpu case a process of its
             own, the four beside the card's runs); --workers against
             --shards; (b)
             run_distributed_filter as two processes at once (PGEN_TPU_COORDINATOR, _NUM_PROCS, _PROC_ID) on the
             visible card(s), keep-two with shared_fs and then without, in
             the same processes (a gloo group of its own a call): the
             shared file and the parts concatenated sha256-equal to phase
             4's keep-two, each process's K3 launches above 0, its wall and
             its time from start to the group printed.

The script imports no jax and nothing of pgen_tpu, and neither does the
port, which keeps its own copies of the jax-free host layers it runs; a
last check fails if jax or pgen_tpu was loaded.

Each path's launch counts are set to 0 just before its cuda runs and read
just after. Each phase prints its seconds as it ends, and all of them in one
line ("[smoke] seconds by phase") after the last. Then the products' line, one JSON line of the seventeen kernels
(launches summed over phases 4-11 and 13-15), and as the last line
{"ok": true, "device": {...}}. Nothing is caught: any failed phase exits
non-zero before the result lines, as does a machine without CUDA or a
directory without the rest of the repository.

The run stops every process it starts before it exits, failed or not: it
adopts the orphans of its subprocesses (PR_SET_CHILD_SUBREAPER), stops the
forkserver and resource tracker that its in-process --workers runs start
(they would outlive it by the time an interpreter holding torch takes to
finish), and stops and reaps any other child left, printing each.

    python3 chip_smoke.py --ranks   # on 2 or 4 cards: phase 7 (a) and phase 12 on
                                    # 1, 2 and 4 ranks only

chip_diag.py beside this script compares the kernels with another checkout's
in one process (--ab DIR), traces their device time (--trace), times K5's two
forms (--forms) and the GWAS products' precisions (--precision), and times
another checkout's smoke by phase (--phase-times DIR).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2504
BLOCK_ROWS = 1 << 16  # pgen_tpu_torch.pipeline.filter_host.DEFAULT_BLOCK_VARIANTS
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
    "glm_planes": "pgen_tpu/ops/glm.py:168",
    "score_dosage": "pgen_tpu/ops/score.py:133",
    "relatedness_bits": "pgen_tpu/ops/king.py:148",
    "relatedness_gram": "pgen_tpu/ops/king.py:134",
    "grm_z": "pgen_tpu/ops/pca.py:109",
    "gt_counts_masked": "pgen_tpu/ops/gt_stats.py:90",
    "ld_r2_band": "pgen_tpu/ops/ld.py:128",
    "pca_approx_pass": "pgen_tpu/ops/pca.py:412",
}
# kernels whose registers and spills phase 2 prints from ptxas' report
PTXAS_KERNELS = ("pack_codes_flat_kernel", "pack_codes_staged_kernel",
                 "subset_repack_staged_kernel", "subset_repack_direct_kernel", "gt_counts_kernel",
                 "sample_counts_kernel", "glm_planes_kernel", "dosage_flat_kernel",
                 "dosage_kernel", "dosage_counts_kernel", "relatedness_bits_kernel",
                 "relatedness_gram_kernel",
                 "gt_counts_masked_kernel", "ld_r2_band_kernel", "pca_zq_kernel",
                 "pca_zty_kernel", "pca_sum_kernel")
PACK_WIDTHS = (2502, 2501)  # K4 beside WIDTHS: with them every S % 4 at chr22's width
GLM_ROWS = 1 << 14  # pgen_tpu_torch.ops.glm.DEFAULT_BLOCK_VARIANTS
COHORT = 2454  # the samples of phase 8's QT: 2% of 2504 missing
BIG_K = 20_000  # K3's kept samples past one tile (2^14)
WIDE = 40_003  # samples past K4's 16,384- and K10's 8,192-column tiles
WIDE_PACK_ROWS = 4096  # 164 MB of codes, as a 65,536 x 2504 block holds
WIDE_GLM_ROWS = 1024  # P = 2: 328 MB of planes, as a 16,384 x 2,454 block holds
COUNT_WIDTHS = (2497, 2505, 2509)  # K9 at R % 4 = 1, 3, 0 (WIDTHS give 2 and 1)
REL_ROWS = 1 << 15  # pgen_tpu_torch.ops.king's block: K12's rows per launch
COHORTS = 5  # K14's keep masks in phase 3's P = 5 cases and phase 10's fst
POPULATIONS = 26  # K14's keep masks in phase 3's P = 26 cases: 1000 Genomes' populations
# the card's dense peaks (NVIDIA's H100 SXM data sheet): int8 tensor-core
# ops, f32 FLOP outside the tensor cores and f64 tensor-core FLOP, per ms
INT8_OPS_PER_MS = 1979e12 / 1e3
# K12's Grams' and K15's .b1 AND-POPC operations (2 M N K a product): no
# peak is published; chip_diag.py --rates measured 10.08 P a second of
# mma.sync m16n8k256 .b1 on an NVIDIA H100 80GB HBM3 at 700 W, 5.1x the int8
# peak, so the bound takes that rate
B1_OPS_PER_MS = 10.08e15 / 1e3
FP32_FLOP_PER_MS = 67e12 / 1e3
FP64_FLOP_PER_MS = 67e12 / 1e3
# H100 SXM HBM3 at 3.35 TB/s (NVIDIA's data sheet), in bytes per ms: it
# bounds every kernel here but K12's Grams, K15 and K13's pass, whose bound
# is the larger of their bytes' time and their operations' at the rates
# above
HBM_BYTES_PER_MS = 3.35e9
LD_BANDS = (9, 49, 420)  # phase 11's ld, prune 50 5 and (about) prune 100kb
LD_MAX_ROWS = 300  # K15's output rows at MAX_BAND
APPROX_COLS = 18  # the columns of pca -k 10 --approx's q: k and 8 more
BURST = 4  # launches queued back to back inside each event pair of burst_ms


def _time_ms(fn, reps: int = 10, burst: int = 1) -> float:
    """Median device time of fn in ms, one CUDA event pair per call: the
    kernels' ``ms``, ``plain_ms`` and ``library_ms``. With ``burst`` > 1 each
    pair is around that many calls queued back to back and the time is per
    call (``burst_ms``): with one call per pair the card is idle while the
    wrapper's host work runs, and that time lies between the events too; a
    burst keeps the card busy where a launch costs the host less than it
    does the card."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def _max_abs_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def _subset_bytes(rows: int, sel) -> int:
    """Bytes a kernel over kept samples must read: in each of ``rows``
    records the bytes that hold a kept sample, and the ids themselves."""
    import torch

    return rows * int(torch.unique(sel.to(torch.int64) >> 2).numel()) + 4 * sel.numel()


def _kept_bytes(rows: int, masks) -> int:
    """Bytes K14 must read: in each of ``rows`` records the bytes that hold a
    sample some mask keeps, and the masks themselves."""
    return rows * int((masks != 0).any(0).sum()) + masks.numel()


def _launch_at_offset(wrapper, symbol, packed, sel, width, offset):
    """Run ``wrapper``'s launcher with its (V, width) u8 output starting
    ``offset`` bytes into a buffer (the wrappers allocate 16-B aligned
    outputs themselves); returns that output."""
    import torch

    from pgen_tpu_torch import kernels

    n_var, rec = packed.shape
    buf = torch.zeros(n_var * width + offset + 16, dtype=torch.uint8, device=packed.device)
    out = buf[offset : offset + n_var * width].view(n_var, width)
    if sel is None:
        kernels.launch(wrapper, symbol, packed, packed.data_ptr(), out.data_ptr(), n_var, rec,
                       width // 4)
    else:
        kernels.launch(wrapper, symbol, packed, packed.data_ptr(), sel.data_ptr(), out.data_ptr(),
                       n_var, rec, sel.shape[0])
    return out


def _score_at_offset(packed, n_samples, flip, offset, mean_impute=True):
    """K11's launcher, without sel, into dosages that start ``offset`` bytes
    past a 16-B boundary (its tiled form where the flat form would run);
    returns (a call that launches it, the dosages, the called counts)."""
    import torch

    from pgen_tpu_torch import kernels
    from pgen_tpu_torch.ops.score import score_dosage

    n_var, rec = packed.shape
    buf = torch.zeros(n_var * n_samples + 8, dtype=torch.float32, device=packed.device)
    db = buf[offset // 4 : offset // 4 + n_var * n_samples].view(n_var, n_samples)
    called = torch.zeros((2, n_var), dtype=torch.int32, device=packed.device)

    def run():
        kernels.launch(score_dosage, "pgen_score_dosage", packed, packed.data_ptr(), None,
                       flip.data_ptr(), db.data_ptr(), called.data_ptr(), n_var, rec, n_samples,
                       n_samples, int(mean_impute))

    return run, db, called[0]


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
    log = so.with_suffix(".log")
    if log.exists():  # written by the build; absent when the library was cached
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(k in line for k in PTXAS_KERNELS):
                name = next(k for k in PTXAS_KERNELS if k in line)
                # a template's int arguments, or K11's and K13's row policy
                instance = re.search(r"I((?:Li\d+E)+)E|(ScoreRows|GrmRows)", line)
                if instance:
                    ints = ",".join(re.findall(r"Li(\d+)E", instance.group(1) or ""))
                    name = f"{name}<{ints or instance.group(2)}>"
                print(f"[2 build] ptxas {name}: {lines[i + 2].strip()}; "
                      f"{lines[i + 3].split(':', 1)[1].strip()}")
    return seconds


def _equal_or_raise(name: str, what: str, got, want):
    import torch

    e = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at {what}: max |err| {e}")
    return e


def _pack_cases(dev, gen):
    """K4 beyond the WIDTHS loop: S = 2502 and 2501 (with 2504 and 2503
    every S % 4, so every row-end shape of its staged form), and its codes
    starting 1, 4 and 8 B past a 16-B boundary at S = 2504, 2503 and 5 (a
    view into a larger buffer: the staged form's lead bytes), 65,792 rows;
    then 301 rows wider than a tile. Codes of any byte value. Returns the
    largest |err| (0)."""
    import torch

    from pgen_tpu_torch import kernels
    from pgen_tpu_torch.ops.pack import pack_codes, pack_codes_plain

    worst = 0
    rows = BLOCK_ROWS + 256
    for s in PACK_WIDTHS:
        codes = torch.randint(0, 256, (rows, s), dtype=torch.uint8, device=dev, generator=gen)
        worst = max(worst, _equal_or_raise("pack_codes", f"S={s}", pack_codes(codes),
                                           pack_codes_plain(codes)))
    for s in (2504, 2503, 5):
        rec = (s + 3) // 4
        for offset in (1, 4, 8):
            buf = torch.randint(0, 256, (rows * s + 32,), dtype=torch.uint8, device=dev,
                                generator=gen)
            codes = buf[offset : offset + rows * s].view(rows, s)
            if codes.data_ptr() % 16 != offset:
                raise AssertionError("the offset view does not start where it should")
            out = torch.empty((rows, rec), dtype=torch.uint8, device=dev)
            kernels.launch(pack_codes, "pgen_pack_codes", codes, codes.data_ptr(), out.data_ptr(),
                           rows, s)
            worst = max(worst, _equal_or_raise("pack_codes", f"S={s}, codes {offset} B past a "
                                               "16-B boundary", out, pack_codes_plain(codes)))
    # rows wider than a tile, in column tiles: S % 4 == 3 and (4 B past a
    # 16-B boundary, where the flat form does not apply) S % 4 == 0
    for s, offset in ((WIDE, 0), (WIDE + 1, 4)):
        buf = torch.randint(0, 256, (301 * s + 32,), dtype=torch.uint8, device=dev, generator=gen)
        codes = buf[offset : offset + 301 * s].view(301, s)
        worst = max(worst, _equal_or_raise("pack_codes", f"S={s}, codes {offset} B past",
                                           pack_codes(codes), pack_codes_plain(codes)))
    torch.cuda.synchronize()
    print(f"[3 kernels] K4 also at S={PACK_WIDTHS[0]} and {PACK_WIDTHS[1]}, with its codes 1, "
          f"4 and 8 B past a 16-B boundary at S=2504, 2503 and 5 (V={rows}), and at S={WIDE} and "
          f"{WIDE + 1} (V=301, column tiles): equal to its plain version")
    return worst


def _plane_cases(dev, gen, luts):
    """K10 beyond the WIDTHS loop, on 16,640 rows of 2504 samples, P = 2 and
    3: ``sel`` of K = 2,454 and 2,456 ids (K % 4 = 2 and 0, so a tile's
    span of floats starts on and off a 16-B boundary) sorted, reversed and
    with repeats. Returns the largest |err| (0)."""
    import torch

    from pgen_tpu_torch.ops.glm import glm_planes, glm_planes_plain

    s = WIDTHS[0]
    packed = torch.randint(0, 256, (GLM_ROWS + 256, (s + 3) // 4), dtype=torch.uint8, device=dev,
                           generator=gen)
    packed[GLM_ROWS:] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
    worst = 0
    for k in (COHORT, COHORT + 2):
        ascending = torch.randperm(s, generator=gen, device=dev)[:k].sort().values
        orders = {"sorted": ascending, "reversed": ascending.flip(0),
                  "repeated": torch.randint(0, s, (k,), generator=gen, device=dev)}
        for order, ids in orders.items():
            sel = ids.to(torch.int32).contiguous()
            for lut in luts:
                got, want = glm_planes(packed, s, lut, sel), glm_planes_plain(packed, s, lut, sel)
                for g, w in zip(got, want):
                    worst = max(worst, _equal_or_raise(
                        "glm_planes", f"K={k} {order} ids, P={lut.shape[0]}", g, w))
    # K past one block's 8,192 columns: column chunks, counts by atomic adds
    wide = torch.randint(0, 256, (301, (WIDE + 3) // 4), dtype=torch.uint8, device=dev,
                         generator=gen)
    ids = torch.randint(0, WIDE, (WIDE - 5,), generator=gen, device=dev).to(torch.int32)
    for sel in (None, ids):
        for lut in luts:
            got, want = glm_planes(wide, WIDE, lut, sel), glm_planes_plain(wide, WIDE, lut, sel)
            for g, w in zip(got, want):
                worst = max(worst, _equal_or_raise(
                    "glm_planes", f"S={WIDE}, sel {sel is not None}, P={lut.shape[0]}", g, w))
    torch.cuda.synchronize()
    print(f"[3 kernels] K10 also with sel of K={COHORT} and {COHORT + 2} sorted, reversed and "
          f"repeated ids, P = 2 and 3 (V={packed.shape[0]}), and at S={WIDE} with all and with "
          f"{WIDE - 5} repeated ids (V=301, column chunks): planes and counts equal to its plain "
          "version")
    return worst


def _score_cases(dev, gen):
    """K11 beyond the WIDTHS loop, on 16,640 rows of 2504 samples (the last
    256 repeat one byte value; 0xFF is a row with no called sample), flip
    random, none and all, with and without mean imputation: ``sel`` of K =
    2,454 and 2,456 ids sorted, reversed and repeated (the tiled form), and
    at 40,003 samples all and 40,000 repeated ids (column chunks after a
    count pass). Returns the largest |err| (0)."""
    import torch

    from pgen_tpu_torch.ops.score import score_dosage, score_dosage_plain

    s = WIDTHS[0]
    packed = torch.randint(0, 256, (GLM_ROWS + 256, (s + 3) // 4), dtype=torch.uint8, device=dev,
                           generator=gen)
    packed[GLM_ROWS:] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
    wide = torch.randint(0, 256, (301, (WIDE + 3) // 4), dtype=torch.uint8, device=dev,
                         generator=gen)
    wide[-256:] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
    worst = 0

    def hold(what, records, n_samples, sel):
        nonlocal worst
        n = records.shape[0]
        flips = {"random": torch.randint(0, 2, (n,), dtype=torch.uint8, device=dev, generator=gen),
                 "none": torch.zeros(n, dtype=torch.uint8, device=dev),
                 "all": torch.ones(n, dtype=torch.uint8, device=dev)}
        for fname, flip in flips.items():
            for mean_impute in (True, False):
                got = score_dosage(records, n_samples, flip, mean_impute, sel)
                want = score_dosage_plain(records, n_samples, flip, mean_impute, sel)
                for g, w in zip(got, want):
                    worst = max(worst, _equal_or_raise(
                        "score_dosage", f"{what}, flip {fname}, mean_impute {mean_impute}", g, w))

    for k in (COHORT, COHORT + 2):
        ascending = torch.randperm(s, generator=gen, device=dev)[:k].sort().values
        orders = {"sorted": ascending, "reversed": ascending.flip(0),
                  "repeated": torch.randint(0, s, (k,), generator=gen, device=dev)}
        for order, ids in orders.items():
            hold(f"K={k} {order} ids", packed, s, ids.to(torch.int32).contiguous())
    ids = torch.randint(0, WIDE, (WIDE - 3,), generator=gen, device=dev).to(torch.int32)
    for sel in (None, ids):
        hold(f"S={WIDE}, sel {sel is not None}", wide, WIDE, sel)
    torch.cuda.synchronize()
    print(f"[3 kernels] K11 also with sel of K={COHORT} and {COHORT + 2} sorted, reversed and "
          f"repeated ids (V={packed.shape[0]}), and at S={WIDE} with all and with {WIDE - 3} "
          "repeated ids (V=301, column chunks), each with flip random, none and all and both "
          "mean-imputation modes: dosages and called counts equal to its plain version")
    return worst


def _count_cases(dev, gen):
    """K9 beyond the WIDTHS loop: R % 4 = 1, 3 and 0 (COUNT_WIDTHS) on
    65,792 rows, the last 256 repeating one byte value, and one row.
    Returns the largest |err| (0)."""
    import torch

    from pgen_tpu_torch.ops.gt_stats import sample_counts_device, sample_counts_plain

    worst = 0
    for s in COUNT_WIDTHS:
        packed = torch.randint(0, 256, (BLOCK_ROWS + 256, (s + 3) // 4), dtype=torch.uint8,
                               device=dev, generator=gen)
        packed[BLOCK_ROWS:] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
        for rows in (packed, packed[-1:]):
            worst = max(worst, _equal_or_raise(
                "sample_counts_device", f"S={s}, V={rows.shape[0]}",
                sample_counts_device(rows, s), sample_counts_plain(rows, s)))
    torch.cuda.synchronize()
    print(f"[3 kernels] K9 also at S={', '.join(map(str, COUNT_WIDTHS))} (R % 4 = 1, 3, 0) on "
          f"V={BLOCK_ROWS + 256} and V=1: equal to its plain version")
    return worst


def _repack_cases(dev, gen):
    """K5 and K8 beyond the WIDTHS loop. Records viewed at every byte offset
    1-15 past a 16-B boundary, S = 2504 and 2503 on 65,792 rows: K5 at K =
    1,001 sorted (staged form) and 2 (direct form), K8. K5 with ids reversed,
    repeated and unsorted at K = 1,001 (staged), and 4,100 repeated ids
    (past the 4,096 a staged block holds: the direct form's column tiles),
    and at 40,003 samples with 40,000 sorted and repeated ids on 301 rows.
    Returns the largest |err| of K5 and of K8 (0, 0)."""
    import torch

    from pgen_tpu_torch.ops.gt_stats import gt_counts_device, gt_counts_plain
    from pgen_tpu_torch.ops.pack import subset_repack, subset_repack_plain

    worst = {"subset_repack": 0, "gt_counts_device": 0}

    def hold(name, what, got, want):
        worst[name] = max(worst[name], _equal_or_raise(name, what, got, want))

    rows = BLOCK_ROWS + 256
    for s in WIDTHS[:2]:
        rec = (s + 3) // 4
        buf = torch.randint(0, 256, (rows * rec + 32,), dtype=torch.uint8, device=dev,
                            generator=gen)
        keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values
        sels = (keep.to(torch.int32), keep[:2].flip(0).to(torch.int32).contiguous())
        for offset in range(1, 16):
            packed = buf[offset : offset + rows * rec].view(rows, rec)
            for sel in sels:
                hold("subset_repack", f"S={s}, K={sel.shape[0]}, records {offset} B past",
                     subset_repack(packed, sel), subset_repack_plain(packed, sel))
            hold("gt_counts_device", f"S={s}, records {offset} B past",
                 gt_counts_device(packed, s), gt_counts_plain(packed, s))
        for k in (KEEP_SAMPLES, 4100):
            ascending = torch.randperm(s, generator=gen, device=dev)[: min(k, s)].sort().values
            orders = {"reversed": ascending.flip(0),
                      "repeated": torch.randint(0, s, (k,), generator=gen, device=dev),
                      "unsorted": torch.randperm(s, generator=gen, device=dev)[: min(k, s)]}
            packed = buf[: rows * rec].view(rows, rec)
            for order, ids in orders.items():
                sel = ids.to(torch.int32).contiguous()
                hold("subset_repack", f"S={s}, K={sel.shape[0]} {order}",
                     subset_repack(packed, sel), subset_repack_plain(packed, sel))
    wide = torch.randint(0, 256, (301, (WIDE + 3) // 4), dtype=torch.uint8, device=dev,
                         generator=gen)
    for sel in (torch.randperm(WIDE, generator=gen, device=dev)[: WIDE - 3].sort().values,
                torch.randint(0, WIDE, (WIDE - 3,), generator=gen, device=dev)):
        sel = sel.to(torch.int32)
        hold("subset_repack", f"S={WIDE}, K={WIDE - 3}", subset_repack(wide, sel),
             subset_repack_plain(wide, sel))
    torch.cuda.synchronize()
    print(f"[3 kernels] K5 and K8 also on records 1-15 B past a 16-B boundary (S=2504 and 2503, "
          f"V={rows}; K5 at K={KEEP_SAMPLES} staged and K=2 direct); K5 with reversed, repeated "
          f"and unsorted ids at K={KEEP_SAMPLES}, 4100 repeated ids (direct, column tiles), and "
          f"at S={WIDE} with {WIDE - 3} sorted and repeated ids (V=301): equal to their plain "
          "versions")
    return worst["subset_repack"], worst["gt_counts_device"]


def _keep_masks(n_samples: int, sets, dev):
    """(P, R) u8 keep masks of the id sets (4 bits a record byte, bit k
    keeping slot k), built with numpy as pgen_tpu's sample_byte_masks builds
    them, on dev."""
    import numpy as np
    import torch

    masks = np.zeros((len(sets), (n_samples + 3) // 4), dtype=np.uint8)
    for p, ids in enumerate(sets):
        ids = np.asarray(ids, dtype=np.int64)
        np.bitwise_or.at(masks[p], ids >> 2, (1 << (ids & 3)).astype(np.uint8))
    return torch.from_numpy(masks).to(dev)


def _partition(n_samples: int, rng) -> list:
    """A seeded partition of the samples into POPULATIONS labels (1000
    Genomes' populations, fst's everyday cohorts; some empty at S < 26)."""
    import numpy as np

    labels = rng.integers(0, POPULATIONS, n_samples)
    return [np.flatnonzero(labels == p) for p in range(POPULATIONS)]


def _cohort_sets(n_samples: int, rng) -> dict:
    """K14's mask sets: P = 1 (a sorted cohort of 1,001), P = 5 (that
    cohort, every sample, none, a cohort with gaps and a duplicate, and an
    unsorted one) and P = 26 (a partition)."""
    keep = rng.choice(n_samples, min(KEEP_SAMPLES, n_samples), replace=False)
    gaps = [s for s in range(n_samples) if s % 5 != 2] + [0]
    return {1: [sorted(keep)],
            COHORTS: [sorted(keep), range(n_samples), [], gaps, rng.permutation(n_samples)[::2]],
            POPULATIONS: _partition(n_samples, rng)}


def _masked_cases(dev, gen):
    """K14 against its plain version (torch.equal): at every width of WIDTHS
    on 65,792 rows (random records, then rows of every byte value), P = 1,
    5 and 26, each mask's slots past S empty; at K8's offsets, records 1-15
    B past a 16-B boundary at S = 2504 and 2503; and at S = WIDE on
    WIDE_PACK_ROWS rows (rows counted in chunks, split over items that add
    their counts), P = 1 and 26. Returns the largest |err| (0)."""
    import numpy as np
    import torch

    from pgen_tpu_torch.ops.gt_stats import gt_counts_masked, gt_counts_masked_plain

    rng = np.random.default_rng(SEED + 14)
    worst = 0
    rows = BLOCK_ROWS + 256
    for s in WIDTHS:
        rec = (s + 3) // 4
        buf = torch.randint(0, 256, (rows * rec + 32,), dtype=torch.uint8, device=dev,
                            generator=gen)
        buf[: 256 * rec] = torch.arange(256, dtype=torch.uint8, device=dev).repeat_interleave(rec)
        for n_masks, sets in _cohort_sets(s, rng).items():
            masks = _keep_masks(s, sets, dev)
            for offset in range(16) if s in WIDTHS[:2] else (0,):
                packed = buf[offset : offset + rows * rec].view(rows, rec)
                worst = max(worst, _equal_or_raise(
                    "gt_counts_masked", f"S={s}, P={n_masks}, records {offset} B past",
                    gt_counts_masked(packed, masks), gt_counts_masked_plain(packed, masks)))
    packed = torch.randint(0, 256, (WIDE_PACK_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                           device=dev, generator=gen)
    for sets in (_cohort_sets(WIDE, rng)[1], _partition(WIDE, rng)):
        masks = _keep_masks(WIDE, sets, dev)
        worst = max(worst, _equal_or_raise(
            "gt_counts_masked", f"S={WIDE}, V={WIDE_PACK_ROWS}, P={len(sets)}",
            gt_counts_masked(packed, masks), gt_counts_masked_plain(packed, masks)))
    torch.cuda.synchronize()
    print(f"[3 kernels] K14 at S={', '.join(map(str, WIDTHS))} (V={rows}, P = 1, {COHORTS} (a "
          f"cohort of {KEEP_SAMPLES}, all, none, gaps with a duplicate, unsorted) and "
          f"{POPULATIONS} (a partition)), at S=2504 and 2503 also on records 1-15 B past a 16-B "
          f"boundary, and at S={WIDE} on {WIDE_PACK_ROWS} rows (P = 1 and {POPULATIONS}): equal "
          "to its plain version")
    return worst


def _approx_case(packed, n_samples: int, gen, plant: bool) -> float:
    """K13's pass against its plain version on the card from the same y0 at
    the scale of y (the plain pass's y from 0 times N(0, 1)), q of
    APPROX_COLS columns: the used count exact, y within
    approx_pass_tolerance of the plain y, and a second pass equal to the
    first bit for bit. With plant, passes with a planted fault (half the
    rows dropped, a 256-row chunk dropped, y0 lost, a column shifted) must
    each lie outside that tolerance, so that the check would see them.
    Returns the largest |error|."""
    import torch

    from pgen_tpu_torch.ops.pca import (
        approx_pass_tolerance,
        pca_approx_pass,
        pca_approx_pass_plain,
    )

    dev = packed.device
    q = torch.randn((n_samples, APPROX_COLS), device=dev, generator=gen)

    def plain(rows, y0):
        y = y0.clone()
        pca_approx_pass_plain(rows, n_samples, q, y, torch.zeros((), dtype=torch.int64,
                                                                 device=dev))
        return y

    zero = torch.zeros((n_samples, APPROX_COLS), device=dev)
    scale = max(float(plain(packed, zero).std()), 1.0)
    y0 = torch.randn(zero.shape, device=dev, generator=gen) * scale
    y = [y0.clone() for _ in range(3)]
    used = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3)]
    pca_approx_pass(packed, n_samples, q, y[0], used[0])
    pca_approx_pass(packed, n_samples, q, y[1], used[1])
    pca_approx_pass_plain(packed, n_samples, q, y[2], used[2])
    tol = approx_pass_tolerance(packed, n_samples, q, y0)
    diff = (y[0].double() - y[2].double()).abs()
    if not torch.equal(y[0], y[1]):
        raise AssertionError(f"pca_approx_pass at S={n_samples}: two passes differ")
    if int(used[0]) != int(used[2]) or bool((diff > tol).any()):
        raise AssertionError(f"pca_approx_pass at S={n_samples}: used {int(used[0])} against "
                             f"{int(used[2])}, y off the plain y by up to "
                             f"{float((diff / tol.clamp(min=1e-300)).max()):.3g} of its tolerance")
    if plant:
        v = packed.shape[0]
        faults = {"half the rows dropped": plain(packed[: v // 2], y0),
                  "a 256-row chunk dropped": plain(torch.cat([packed[:256], packed[512:]]), y0),
                  "y0 lost": plain(packed, zero),
                  "a column shifted": y[0].roll(1, 1)}
        for fault, bad in faults.items():
            if not bool(((bad.double() - y[2].double()).abs() > tol).any()):
                raise AssertionError(f"pca_approx_pass at S={n_samples}: a pass with {fault} "
                                     "lies within the tolerance")
        print(f"[3 kernels] pca_approx_pass at S={n_samples}, V={v}: |error| "
              f"{float(diff.max()):.4g} against a tolerance of {float(tol.min()):.4g} to "
              f"{float(tol.max()):.4g} (median |y| {float(y[2].abs().median()):.4g}); planted "
              f"faults ({', '.join(faults)}) all outside it")
    return float(diff.max())


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel errors and
    times at the paths' block shapes (2504 samples, 65,536 rows)."""
    import numpy as np
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
        gt_counts_masked,
        gt_counts_masked_plain,
        gt_counts_plain,
        kept_counts,
        mask_words,
        sample_counts_device,
        sample_counts_plain,
    )
    from pgen_tpu_torch.ops.pack import (
        pack_codes,
        pack_codes_plain,
        subset_repack,
        subset_repack_plain,
    )
    from pgen_tpu_torch.ops.glm import LUT_GENO, LUT_MOMENTS, glm_planes, glm_planes_plain
    from pgen_tpu_torch.ops.ld import ld_r2_band, ld_r2_band_plain
    from pgen_tpu_torch.ops.pca import (
        approx_scratch,
        grm_z,
        grm_z_plain,
        pca_approx_pass,
        pca_approx_pass_plain,
    )
    from pgen_tpu_torch.pipeline.prune import MAX_BAND
    from pgen_tpu_torch.ops.relatedness import (
        GRAM_SETS,
        gram_pad,
        relatedness_bits,
        relatedness_bits_plain,
        relatedness_gram,
        relatedness_gram_plain,
    )
    from pgen_tpu_torch.ops.score import score_dosage, score_dosage_plain
    from pgen_tpu_torch.ops.unpack import unpack_codes, unpack_codes_plain

    dev = torch.device("cuda", 0)
    luts = [torch.tensor(t, dtype=torch.float32, device=dev) for t in (LUT_MOMENTS, LUT_GENO)]
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
            ("sample_counts_device", sample_counts_device(packed[:GLM_ROWS], s),
             sample_counts_plain(packed[:GLM_ROWS], s)),
        ]
        # K2 also into an output 4 bytes past a 16-B boundary (its word form)
        pairs.append(("genotype_text", _launch_at_offset(genotype_text, "pgen_genotype_text",
                                                         packed, None, 4 * s, 4),
                      genotype_text_plain(packed, s)))
        # K3 at K = 2 and 1000 (random ids), and K = 20,000, past one tile:
        # every id in reversed order, then random repeats (on the last 4,096
        # rows, the byte-value rows among them: 80 KB of text a row)
        big = torch.cat([torch.arange(s - 1, -1, -1, device=dev),
                         torch.randint(0, s, (BIG_K,), generator=gen, device=dev)])[:BIG_K]
        for rows, sel in [(packed, torch.randperm(s, generator=gen, device=dev)[:k])
                          for k in sorted({min(2, s), min(1000, s)})] + [(packed[-4096:], big)]:
            sel = sel.to(torch.int32)
            want = subset_text_plain(rows, sel)
            pairs.append(("subset_text_from_packed", subset_text_from_packed(rows, sel), want))
            pairs.append(("subset_text_from_packed",
                          _launch_at_offset(subset_text_from_packed, "pgen_subset_text", rows,
                                            sel, 4 * sel.shape[0], 4), want))
        # K = 2, 1,001 and all s in a random order
        for k in sorted({min(2, s), min(KEEP_SAMPLES, s), s}):
            sel = torch.randperm(s, generator=gen, device=dev)[:k].to(torch.int32)
            pairs.append(("subset_repack", subset_repack(packed, sel),
                          subset_repack_plain(packed, sel)))
        # K10 and K11 on the last 16,640 rows (the byte-value rows included),
        # without a selection and with one that drops 2% of the samples,
        # repeats the first id and so leaves a gap
        ops = packed[BLOCK_ROWS - GLM_ROWS:]
        flip = torch.randint(0, 2, (ops.shape[0],), dtype=torch.uint8, device=dev, generator=gen)
        perm = torch.randperm(s, generator=gen, device=dev)[: max(1, s - s // 50)]
        for sel in (None, torch.cat([perm, perm[:1]]).to(torch.int32)):
            for lut in luts:
                got, want = glm_planes(ops, s, lut, sel), glm_planes_plain(ops, s, lut, sel)
                pairs += [("glm_planes", got[0], want[0]), ("glm_planes", got[1], want[1])]
            for mean_impute in (True, False):
                got = score_dosage(ops, s, flip, mean_impute, sel)
                want = score_dosage_plain(ops, s, flip, mean_impute, sel)
                pairs += [("score_dosage", got[0], want[0]), ("score_dosage", got[1], want[1])]
                if sel is None:  # the tiled form where the flat one would run
                    run, db, called = _score_at_offset(ops, s, flip, 4, mean_impute)
                    run()
                    pairs += [("score_dosage", db, want[0]), ("score_dosage", called, want[1])]
            # K13 on the same rows: 0xFF rows all missing, pad slots of
            # random codes never read
            got, want = grm_z(ops, s, sel), grm_z_plain(ops, s, sel)
            pairs += [("grm_z", got[0], want[0]), ("grm_z", got[1], want[1])]
            # K12, K15 and K13's pass on the records of the samples of sel
            # (K5), as the paths run them; K15 at MAX_BAND on 300 output rows
            rows, kept = (ops, s) if sel is None else (subset_repack(ops, sel), sel.shape[0])
            pairs += _relatedness_pairs(rows, kept, gen)
            for band in LD_BANDS:
                pairs.append(("ld_r2_band", ld_r2_band(rows, kept, band),
                              ld_r2_band_plain(rows, kept, band)))
            pairs.append(("ld_r2_band", ld_r2_band(rows, kept, MAX_BAND, LD_MAX_ROWS),
                          ld_r2_band_plain(rows, kept, MAX_BAND, LD_MAX_ROWS)))
            err["pca_approx_pass"] = max(err["pca_approx_pass"],
                                         _approx_case(rows, kept, gen, s in WIDTHS[:2]))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            e = _max_abs_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version at S={s}: max |err| {e}")
            err[name] = max(err[name], e)
        n_k3 = sum(name == "subset_text_from_packed" for name, _, _ in pairs)
        n_k5 = sum(name == "subset_repack" for name, _, _ in pairs)
        print(f"[3 kernels] S={s} (R={rec}, V={BLOCK_ROWS + 256}; K6 at ({rec}, {BLOCK_ROWS}); "
              f"K10, K11 at V={ops.shape[0]}): K1, K2 x2 (its output 16-B aligned and 4 B "
              f"past), K3 x{n_k3} (K = 2, 1000, {BIG_K} with repeats; each also 4 B past), K4, "
              f"K5 x{n_k5}, K6, K7, K8, K9 x2 (also at {GLM_ROWS} rows), K10 x4 (P = 2, 3), "
              "K11 x6 (also tiled, its output 4 B past), K12's bits x2 and Grams x4 (king's "
              "and genome's into random Grams), K13 x2 and K15 x8 (bands "
              f"{LD_BANDS} and {MAX_BAND} on {LD_MAX_ROWS} rows; each with and without sel, "
              "K5 first) equal to their plain versions; K13's pass x2 within its tolerance")

    err["pack_codes"] = max(err["pack_codes"], _pack_cases(dev, gen))
    err["glm_planes"] = max(err["glm_planes"], _plane_cases(dev, gen, luts))
    err["score_dosage"] = max(err["score_dosage"], _score_cases(dev, gen))
    err["sample_counts_device"] = max(err["sample_counts_device"], _count_cases(dev, gen))
    k5_err, k8_err = _repack_cases(dev, gen)
    err["subset_repack"] = max(err["subset_repack"], k5_err)
    err["gt_counts_device"] = max(err["gt_counts_device"], k8_err)
    err["gt_counts_masked"] = _masked_cases(dev, gen)

    s = WIDTHS[0]
    rec = (s + 3) // 4
    packed = torch.randint(0, 256, (BLOCK_ROWS, rec), dtype=torch.uint8, device=dev, generator=gen)
    codes = torch.randint(0, 4, (BLOCK_ROWS, s), dtype=torch.uint8, device=dev, generator=gen)
    packed_t = packed.T.contiguous()
    sel2 = torch.randperm(s, generator=gen, device=dev)[:2].to(torch.int32)
    sel1000 = torch.randperm(s, generator=gen, device=dev)[:1000].to(torch.int32)
    keep = torch.randperm(s, generator=gen, device=dev)[:KEEP_SAMPLES].sort().values.to(torch.int32)
    keep_rec = (KEEP_SAMPLES + 3) // 4
    # K10/K11 at the GWAS paths' block: 16,384 rows, all 2504 samples or a
    # sorted cohort of 2,454 (phase 8's QT)
    ops = packed[:GLM_ROWS]
    cohort = torch.randperm(s, generator=gen, device=dev)[:COHORT].sort().values.to(torch.int32)
    flip = torch.randint(0, 2, (GLM_ROWS,), dtype=torch.uint8, device=dev, generator=gen)
    lut2, lut3 = luts
    # one PyTorch call for the same function, where there is one: a gather
    # of a byte-value table (K1, K2) or a code table (K7), cast included
    word_lut = unpack_codes_plain(torch.arange(256, dtype=torch.uint8, device=dev)[:, None], 4)
    word_lut = word_lut.contiguous().view(torch.int32).reshape(256)
    text_lut = genotype_text_plain(torch.arange(256, dtype=torch.uint8, device=dev)[:, None], 4)
    text_lut = text_lut.contiguous().view(torch.int64)  # (256, 2)
    code_lut = text_from_codes_plain(torch.arange(4, dtype=torch.uint8, device=dev)[None, :])
    code_lut = code_lut.view(torch.int32).reshape(4)

    def library_unpack():
        words = torch.index_select(word_lut, 0, packed.view(-1).to(torch.int64))
        return words.view(torch.uint8).view(BLOCK_ROWS, 4 * rec)[:, :s]

    def library_text():
        quads = torch.index_select(text_lut, 0, packed.view(-1).to(torch.int64))
        return quads.view(torch.uint8).view(BLOCK_ROWS, 16 * rec)

    def library_text_from_codes():
        words = torch.index_select(code_lut, 0, codes.view(-1).to(torch.int64))
        return words.view(torch.uint8).view(BLOCK_ROWS, 4 * s)

    s_odd = s - 1  # 2503: K2's word form on the same records, K4's staged form
    codes_odd = codes[:, :s_odd].contiguous()
    # K4 and K10 on rows wider than their tiles, the bytes of a path's block
    codes_wide = torch.randint(0, 4, (WIDE_PACK_ROWS, WIDE), dtype=torch.uint8, device=dev,
                               generator=gen)
    ops_wide = torch.randint(0, 256, (WIDE_GLM_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                             device=dev, generator=gen)
    sel_wide = torch.randperm(WIDE, generator=gen, device=dev)[: WIDE - 3].sort().values
    sel_wide = sel_wide.to(torch.int32)
    flip_wide = torch.randint(0, 2, (WIDE_GLM_ROWS,), dtype=torch.uint8, device=dev, generator=gen)
    # K5 at 40,000 of 40,003 samples: the records of a path's block
    packed_wide = torch.randint(0, 256, (WIDE_PACK_ROWS, (WIDE + 3) // 4), dtype=torch.uint8,
                                device=dev, generator=gen)
    score_tiled, _, _ = _score_at_offset(ops, s, flip, 4)
    # K12 at the relatedness block: 32,768 rows, all samples or a sorted
    # cohort of 1,001 (phase 9's --samples-file) re-packed by K5, as the
    # scan runs them; each kernel held to its plain version there first
    rel = packed[:REL_ROWS]
    rel_keep = subset_repack(rel, keep)
    for rows, kept in ((rel, s), (rel_keep, KEEP_SAMPLES)):
        for name, got, want in _relatedness_pairs(rows, kept, gen):
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version at {REL_ROWS} rows "
                                     f"of {kept} samples")
    rel_bits, keep_bits = relatedness_bits(rel, s), relatedness_bits(rel_keep, KEEP_SAMPLES)
    bits_out = torch.empty_like(rel_bits)
    king, genome = GRAM_SETS
    rel_grams = {(n, k): torch.zeros((len(pairs), gram_pad(k), gram_pad(k)), dtype=torch.int32,
                                     device=dev)
                 for n, pairs, k in (("king", king, s), ("genome", genome, s),
                                     ("king", king, KEEP_SAMPLES))}
    # K14 at the count paths' block: P = 1 (a cohort of 1,001), P = 5
    # cohorts of 1,001 and P = 26 (a partition), their E words and kept
    # counts made once as the paths make them
    rng = np.random.default_rng(SEED + 3)
    cohort_sets = [sorted(rng.choice(s, KEEP_SAMPLES, replace=False)) for _ in range(COHORTS)]
    masks1, masks5 = (_keep_masks(s, cohort_sets[:p], dev) for p in (1, COHORTS))
    masks26 = _keep_masks(s, _partition(s, rng), dev)
    ops1, ops5, ops26 = ((mask_words(m), kept_counts(m)) for m in (masks1, masks5, masks26))
    # K15 at the ld and prune paths' block: 16,384 output rows and the band's
    # rows after them, all 2504 samples or a sorted 1,001 re-packed by K5;
    # K13's pass at 16,384 rows, q of 18 columns, the same two cohorts
    ld_rows = packed[: GLM_ROWS + LD_BANDS[-1]]
    ld_keep = subset_repack(ld_rows, keep)
    ld_out = torch.empty(GLM_ROWS * LD_BANDS[-1], dtype=torch.float64, device=dev)
    ops_keep = subset_repack(ops, keep)
    q18 = torch.randn((s, APPROX_COLS), device=dev, generator=gen)
    q18_keep = q18[:KEEP_SAMPLES].contiguous()
    y18 = torch.zeros((s, APPROX_COLS), device=dev)
    used18 = torch.zeros((), dtype=torch.int64, device=dev)
    scratch18 = approx_scratch(GLM_ROWS, s, dev)
    shapes = {
        "genotype_text_transposed": f"({rec}, {BLOCK_ROWS}) S={s}",
        "genotype_text S=2503": f"({BLOCK_ROWS}, {rec}) S={s - 1}",
        "pack_codes S=2503": f"({BLOCK_ROWS}, {rec}) S={s - 1}",
        f"pack_codes S={WIDE}": f"({WIDE_PACK_ROWS}, {(WIDE + 3) // 4}) S={WIDE}",
        f"subset_repack K={WIDE - 3} of S={WIDE}": f"({WIDE_PACK_ROWS}, {(WIDE + 3) // 4}) "
                                                   f"S={WIDE}",
        f"glm_planes K={WIDE - 3} of S={WIDE}":
            f"({WIDE_GLM_ROWS}, {(WIDE + 3) // 4}) S={WIDE}",
        f"sample_counts_device V={GLM_ROWS}": f"({GLM_ROWS}, {rec}) S={s}",
        f"score_dosage K={WIDE - 3} of S={WIDE}": f"({WIDE_GLM_ROWS}, {(WIDE + 3) // 4}) S={WIDE}",
        "relatedness_bits": f"({REL_ROWS}, {rec}) S={s}",
        f"relatedness_bits K={KEEP_SAMPLES}": f"({REL_ROWS}, {keep_rec}) S={KEEP_SAMPLES} "
                                               "(re-packed)",
        "relatedness_gram": f"bits of ({REL_ROWS}, {rec}) S={s}, king's 4 Grams",
        "relatedness_gram genome": f"bits of ({REL_ROWS}, {rec}) S={s}, genome's 5 Grams",
        f"relatedness_gram K={KEEP_SAMPLES}": f"bits of ({REL_ROWS}, {keep_rec}) "
                                               f"S={KEEP_SAMPLES}, king's 4 Grams",
    }
    cases = {
        # name: kernel, plain, library call or None, bytes the function must
        # move (each input byte read once, each output byte written once)
        "unpack_codes": (lambda: unpack_codes(packed, s), lambda: unpack_codes_plain(packed, s),
                         library_unpack, packed.numel() + BLOCK_ROWS * s),
        "genotype_text": (lambda: genotype_text(packed, s), lambda: genotype_text_plain(packed, s),
                          library_text, packed.numel() + BLOCK_ROWS * 4 * s),
        "genotype_text S=2503": (lambda: genotype_text(packed, s_odd),
                                 lambda: genotype_text_plain(packed, s_odd), None,
                                 packed.numel() + BLOCK_ROWS * 4 * s_odd),
        "subset_text_from_packed": (lambda: subset_text_from_packed(packed, sel2),
                                    lambda: subset_text_plain(packed, sel2), None,
                                    _subset_bytes(BLOCK_ROWS, sel2) + BLOCK_ROWS * 2 * 4),
        "subset_text_from_packed K=1000": (lambda: subset_text_from_packed(packed, sel1000),
                                           lambda: subset_text_plain(packed, sel1000), None,
                                           _subset_bytes(BLOCK_ROWS, sel1000) + BLOCK_ROWS * 4000),
        "pack_codes": (lambda: pack_codes(codes), lambda: pack_codes_plain(codes), None,
                       codes.numel() + packed.numel()),
        "pack_codes S=2503": (lambda: pack_codes(codes_odd), lambda: pack_codes_plain(codes_odd),
                              None, codes_odd.numel() + BLOCK_ROWS * rec),
        f"pack_codes S={WIDE}": (lambda: pack_codes(codes_wide),
                                 lambda: pack_codes_plain(codes_wide), None,
                                 codes_wide.numel() + WIDE_PACK_ROWS * ((WIDE + 3) // 4)),
        "subset_repack": (lambda: subset_repack(packed, keep),
                          lambda: subset_repack_plain(packed, keep), None,
                          _subset_bytes(BLOCK_ROWS, keep) + BLOCK_ROWS * keep_rec),
        # its direct form: a --keep of two samples
        "subset_repack K=2": (lambda: subset_repack(packed, sel2),
                              lambda: subset_repack_plain(packed, sel2), None,
                              _subset_bytes(BLOCK_ROWS, sel2) + BLOCK_ROWS),
        f"subset_repack K={WIDE - 3} of S={WIDE}": (
            lambda: subset_repack(packed_wide, sel_wide),
            lambda: subset_repack_plain(packed_wide, sel_wide), None,
            _subset_bytes(WIDE_PACK_ROWS, sel_wide) + WIDE_PACK_ROWS * ((WIDE - 3 + 3) // 4)),
        "genotype_text_transposed": (lambda: genotype_text_transposed(packed_t),
                                     lambda: genotype_text_transposed_plain(packed_t), None,
                                     packed.numel() * 17),
        "genotype_text_from_codes": (lambda: genotype_text_from_codes(codes),
                                     lambda: text_from_codes_plain(codes),
                                     library_text_from_codes, codes.numel() * 5),
        "gt_counts_device": (lambda: gt_counts_device(packed, s),
                             lambda: gt_counts_plain(packed, s), None,
                             packed.numel() + BLOCK_ROWS * 16),
        "sample_counts_device": (lambda: sample_counts_device(packed, s),
                                 lambda: sample_counts_plain(packed, s), None,
                                 packed.numel() + s * 16),
        f"sample_counts_device V={GLM_ROWS}": (lambda: sample_counts_device(ops, s),
                                               lambda: sample_counts_plain(ops, s), None,
                                               ops.numel() + s * 16),
        "glm_planes": (lambda: glm_planes(ops, s, lut2, cohort),
                       lambda: glm_planes_plain(ops, s, lut2, cohort), None,
                       _subset_bytes(GLM_ROWS, cohort) + GLM_ROWS * (2 * 4 * COHORT + 16)),
        "glm_planes P=3 K=2504": (lambda: glm_planes(ops, s, lut3),
                                  lambda: glm_planes_plain(ops, s, lut3), None,
                                  ops.numel() + GLM_ROWS * (3 * 4 * s + 16)),
        f"glm_planes K={WIDE - 3} of S={WIDE}": (
            lambda: glm_planes(ops_wide, WIDE, lut2, sel_wide),
            lambda: glm_planes_plain(ops_wide, WIDE, lut2, sel_wide), None,
            _subset_bytes(WIDE_GLM_ROWS, sel_wide) + WIDE_GLM_ROWS * (2 * 4 * (WIDE - 3) + 16)),
        "score_dosage": (lambda: score_dosage(ops, s, flip),
                         lambda: score_dosage_plain(ops, s, flip), None,
                         ops.numel() + GLM_ROWS * (4 * s + 5)),
        # the tiled form on the same work: its output 4 B past a 16-B boundary,
        # through kernels.launch (no wrapper checks or allocations inside)
        "score_dosage tiled": (score_tiled, lambda: score_dosage_plain(ops, s, flip), None,
                               ops.numel() + GLM_ROWS * (4 * s + 5)),
        "score_dosage K=2454": (lambda: score_dosage(ops, s, flip, True, cohort),
                                lambda: score_dosage_plain(ops, s, flip, True, cohort), None,
                                _subset_bytes(GLM_ROWS, cohort) + GLM_ROWS * (4 * COHORT + 5)),
        f"score_dosage K={WIDE - 3} of S={WIDE}": (
            lambda: score_dosage(ops_wide, WIDE, flip_wide, True, sel_wide),
            lambda: score_dosage_plain(ops_wide, WIDE, flip_wide, True, sel_wide), None,
            _subset_bytes(WIDE_GLM_ROWS, sel_wide) + WIDE_GLM_ROWS * (4 * (WIDE - 3) + 5)),
        # the records read and the bits written, their pad samples and
        # rows too (code 3); the Grams: the bits read, and each Gram's K x K
        # entries read and written; their operations below
        "relatedness_bits": (lambda: relatedness_bits(rel, s, bits_out),
                             lambda: relatedness_bits_plain(rel, s), None,
                             rel.numel() + 4 * rel_bits.numel()),
        f"relatedness_bits K={KEEP_SAMPLES}": (
            lambda: relatedness_bits(rel_keep, KEEP_SAMPLES, bits_out),
            lambda: relatedness_bits_plain(rel_keep, KEEP_SAMPLES), None,
            rel_keep.numel() + 4 * keep_bits.numel()),
        "relatedness_gram": (lambda: relatedness_gram(rel_bits, king, rel_grams["king", s]),
                             lambda: relatedness_gram_plain(rel_bits, king, rel_grams["king", s]),
                             None, 4 * rel_bits.numel() + len(king) * 8 * s * s),
        "relatedness_gram genome": (
            lambda: relatedness_gram(rel_bits, genome, rel_grams["genome", s]),
            lambda: relatedness_gram_plain(rel_bits, genome, rel_grams["genome", s]), None,
            4 * rel_bits.numel() + len(genome) * 8 * s * s),
        f"relatedness_gram K={KEEP_SAMPLES}": (
            lambda: relatedness_gram(keep_bits, king, rel_grams["king", KEEP_SAMPLES]),
            lambda: relatedness_gram_plain(keep_bits, king, rel_grams["king", KEEP_SAMPLES]), None,
            4 * keep_bits.numel() + len(king) * 8 * KEEP_SAMPLES ** 2),
        "grm_z": (lambda: grm_z(ops, s), lambda: grm_z_plain(ops, s), None,
                  ops.numel() + GLM_ROWS * (4 * s + 4)),
        f"grm_z K={KEEP_SAMPLES}": (lambda: grm_z(ops, s, keep), lambda: grm_z_plain(ops, s, keep),
                                    None, _subset_bytes(GLM_ROWS, keep) + GLM_ROWS * (4 * KEEP_SAMPLES + 4)),
        # the records and the (rows, band) f64 r²; its operations below
        "ld_r2_band": (lambda: ld_r2_band(ld_rows[: GLM_ROWS + 9], s, 9, GLM_ROWS, ld_out),
                       lambda: ld_r2_band_plain(ld_rows[: GLM_ROWS + 9], s, 9, GLM_ROWS), None,
                       (GLM_ROWS + 9) * rec + GLM_ROWS * 9 * 8),
        "ld_r2_band band=49": (
            lambda: ld_r2_band(ld_rows[: GLM_ROWS + 49], s, 49, GLM_ROWS, ld_out),
            lambda: ld_r2_band_plain(ld_rows[: GLM_ROWS + 49], s, 49, GLM_ROWS), None,
            (GLM_ROWS + 49) * rec + GLM_ROWS * 49 * 8),
        "ld_r2_band band=420": (
            lambda: ld_r2_band(ld_rows, s, 420, GLM_ROWS, ld_out),
            lambda: ld_r2_band_plain(ld_rows, s, 420, GLM_ROWS), None,
            ld_rows.numel() + GLM_ROWS * 420 * 8),
        f"ld_r2_band K={KEEP_SAMPLES}": (
            lambda: ld_r2_band(ld_keep[: GLM_ROWS + 9], KEEP_SAMPLES, 9, GLM_ROWS, ld_out),
            lambda: ld_r2_band_plain(ld_keep[: GLM_ROWS + 9], KEEP_SAMPLES, 9, GLM_ROWS), None,
            (GLM_ROWS + 9) * keep_rec + GLM_ROWS * 9 * 8),
        # the records, q, and y read and written
        "pca_approx_pass": (
            lambda: pca_approx_pass(ops, s, q18, y18, used18, scratch18),
            lambda: pca_approx_pass_plain(ops, s, q18, y18, used18), None,
            ops.numel() + 3 * 4 * s * APPROX_COLS),
        f"pca_approx_pass K={KEEP_SAMPLES}": (
            lambda: pca_approx_pass(ops_keep, KEEP_SAMPLES, q18_keep, y18[:KEEP_SAMPLES],
                                    used18, scratch18),
            lambda: pca_approx_pass_plain(ops_keep, KEEP_SAMPLES, q18_keep, y18[:KEEP_SAMPLES],
                                          used18), None,
            ops_keep.numel() + 3 * 4 * KEEP_SAMPLES * APPROX_COLS),
        # the record bytes that hold a kept sample of any mask, the masks and
        # the (V, P, 4) int32 counts
        "gt_counts_masked": (lambda: gt_counts_masked(packed, masks1, *ops1),
                             lambda: gt_counts_masked_plain(packed, masks1), None,
                             _kept_bytes(BLOCK_ROWS, masks1) + BLOCK_ROWS * 16),
        f"gt_counts_masked P={COHORTS}": (lambda: gt_counts_masked(packed, masks5, *ops5),
                                          lambda: gt_counts_masked_plain(packed, masks5), None,
                                          _kept_bytes(BLOCK_ROWS, masks5)
                                          + BLOCK_ROWS * 16 * COHORTS),
        f"gt_counts_masked P={POPULATIONS}": (lambda: gt_counts_masked(packed, masks26, *ops26),
                                              lambda: gt_counts_masked_plain(packed, masks26), None,
                                              _kept_bytes(BLOCK_ROWS, masks26)
                                              + BLOCK_ROWS * 16 * POPULATIONS),
    }
    # the operations of K15 (18 K binary operations a pair: nine AND-POPC
    # products of K bits) and of K13's pass (4 K L FLOP a row), at the peaks
    # for their types; the larger of them and the bytes' time is the bound
    op_bounds = {f"ld_r2_band{tag}": (18 * k * GLM_ROWS * band, B1_OPS_PER_MS)
                 for tag, k, band in (("", s, 9), (" band=49", s, 49), (" band=420", s, 420),
                                      (f" K={KEEP_SAMPLES}", KEEP_SAMPLES, 9))}
    op_bounds.update({f"pca_approx_pass{tag}": (4 * k * APPROX_COLS * GLM_ROWS, FP32_FLOP_PER_MS)
                      for tag, k in (("", s), (f" K={KEEP_SAMPLES}", KEEP_SAMPLES))})
    op_bounds.update({f"relatedness_gram{tag}": (_gram_ops(pairs, k, REL_ROWS), B1_OPS_PER_MS)
                      for tag, pairs, k in (("", king, s), (" genome", genome, s),
                                            (f" K={KEEP_SAMPLES}", king, KEEP_SAMPLES))})
    times = {}
    for name, (kernel, plain, library, nbytes) in cases.items():
        # alternate plain, kernel, kernel, plain (and library, library) so
        # drift hits them alike
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
        burst_ms = _time_ms(kernel, burst=BURST)
        library_ms = None
        if library is not None:
            if not torch.equal(library(), kernel()):
                raise AssertionError(f"{name}: the PyTorch call differs from the kernel")
            library_ms = statistics.median([_time_ms(library), _time_ms(library)])
        n_ops, peak = op_bounds.get(name, (0, 1.0))
        bound_by = "operations" if n_ops / peak > nbytes / HBM_BYTES_PER_MS else "bytes"
        bound_ms = max(n_ops / peak, nbytes / HBM_BYTES_PER_MS)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "burst_ms": burst_ms, "bound_by": bound_by}
        rows = (GLM_ROWS if name.startswith(("glm_planes", "score_dosage", "grm_z", "ld_r2_band",
                                             "pca_approx_pass"))
                else REL_ROWS if name.startswith("relatedness") else BLOCK_ROWS)
        shape = shapes.get(name, f"({rows}, {rec}) S={s}")
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"[3 kernels] {name} at {shape}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB moved), "
              f"plain {plain_ms:.4f} ms")
        print(f"[3 kernels] {name}: bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / HBM_BYTES_PER_MS:.4f} ms for the bytes at 3.35 TB/s, "
              f"{n_ops / peak:.4f} ms for {n_ops:.4g} operations at the peak), kernel at "
              f"{100 * bound_ms / ms:.1f}% of it; one PyTorch call {lib}")
        print(f"[3 kernels] {name}: {BURST} launches per event pair {burst_ms:.4f} ms a launch, "
              f"{100 * bound_ms / burst_ms:.1f}% of the bound")
    # K13's pass beside the parent's chain for the same work: K13's z, then
    # the two fp32 products (ops/pca.py before the pass kernels), in turns
    def chain(rows, sel, q):
        from pgen_tpu_torch.device import matmul_fp32

        z, _ = grm_z(rows, s, sel)
        return matmul_fp32(z.T, matmul_fp32(z, q))

    for name, (kernel, rows, sel, q) in {
            "pca_approx_pass": (cases["pca_approx_pass"][0], ops, None, q18),
            f"pca_approx_pass K={KEEP_SAMPLES}": (cases[f"pca_approx_pass K={KEEP_SAMPLES}"][0],
                                                  ops, keep, q18_keep)}.items():
        c1, k1, k2, c2 = (_time_ms(f) for f in (lambda: chain(rows, sel, q), kernel, kernel,
                                                  lambda: chain(rows, sel, q)))
        times[name]["chain_ms"] = statistics.median([c1, c2])
        print(f"[3 kernels] {name}: the parent's chain (K13 z, two fp32 products) "
              f"{c1:.4f} / {c2:.4f} ms, the pass {k1:.4f} / {k2:.4f} ms (chain, pass, pass, "
              f"chain): {statistics.median([c1, c2]) / statistics.median([k1, k2]):.2f}x")
    return {"err": err, "times": times, "products": _time_products(rel, ops, s)}


def _gram_ops(pairs, k: int, rows: int) -> int:
    """.b1 operations of K12's Gram kernel on ``rows`` rows of k samples, 2 M
    N K a product: a symmetric Gram's triangle (K (K + 1) / 2 entries), an
    asymmetric one's K^2 entries, 2 operations a row each."""
    return sum(rows * (k * (k + 1) if x == y else 2 * k * k) for x, y in pairs)


def _relatedness_pairs(rows, kept: int, gen) -> list:
    """K12's two kernels on records of ``kept`` samples against their plain
    versions on the same inputs: the bits, then each set's Grams (king's and
    genome's) from those bits, added into the same random int32 Grams."""
    import torch

    from pgen_tpu_torch.ops.relatedness import (
        GRAM_SETS,
        gram_pad,
        relatedness_bits,
        relatedness_bits_plain,
        relatedness_gram,
        relatedness_gram_plain,
    )

    bits = relatedness_bits(rows, kept)
    out = [("relatedness_bits", bits, relatedness_bits_plain(rows, kept))]
    s_pad = gram_pad(kept)
    for pairs in GRAM_SETS:
        start = torch.randint(-(1 << 20), 1 << 20, (len(pairs), s_pad, s_pad), dtype=torch.int32,
                              device=rows.device, generator=gen)
        out.append(("relatedness_gram", relatedness_gram(bits, pairs, start.clone()),
                    relatedness_gram_plain(bits, pairs, start.clone())))
    return out


def _time_products(rel, ops, s) -> dict:
    """The library products beside K12 and K13 at the paths' block shapes:
    one torch._int_mm Gram of the int8 planes of the CPU's scan (made on the
    card by relatedness_planes_plain; K12's first form wrote them and
    chained four or five such products; 2 S^2 x 32,768 int8 ops), one
    z'z in f64 as the exact GRM makes it (z cast in chunks of rows; 2 S^2 x
    16,384 FLOP) and in full fp32 as pgen_tpu makes it, the two products
    of an --approx pass before K13's pass kernels, z'(z q) (q of 18
    columns), and the first product of a logistic
    IRLS iteration (X5: r C of a 256-variant block over phase 8 (c)'s
    cohort, k = 2), each against the card's dense peak for its type."""
    import torch

    from pgen_tpu_torch.device import matmul_fp32
    from pgen_tpu_torch.ops.pca import add_gram_fp64, grm_z
    from pgen_tpu_torch.ops.relatedness import relatedness_planes_plain

    planes = relatedness_planes_plain(rel, s)
    z, _ = grm_z(ops, s)
    q = torch.randn((s, 18), device=z.device)
    # ops/logistic_host.py: rq = mm(r, covars), r (256, cohort), C (cohort, 2)
    r_irls = torch.randn((256, COHORT), device=z.device)
    c_irls = torch.randn((COHORT, 2), device=z.device)
    acc = torch.zeros((s, s), dtype=torch.float64, device=z.device)
    gram = torch._int_mm(planes[0], planes[3].t())
    if not torch.equal(gram.double(), planes[0].double() @ planes[3].double().T):
        raise AssertionError("torch._int_mm differs from the f64 product of the planes")
    s_pad, v_pad = planes.shape[1:]
    cases = {
        "int_mm_gram": (lambda: torch._int_mm(planes[0], planes[3].t()), 2 * s_pad ** 2 * v_pad,
                        INT8_OPS_PER_MS, "int8"),
        "zz_fp64": (lambda: add_gram_fp64(acc, z), 2 * s ** 2 * ops.shape[0], FP64_FLOP_PER_MS,
                    "fp64"),
        "zz_fp32": (lambda: matmul_fp32(z.T, z), 2 * s ** 2 * ops.shape[0], FP32_FLOP_PER_MS,
                    "fp32"),
        "approx_pass_fp32": (lambda: matmul_fp32(z.T, matmul_fp32(z, q)),
                             4 * s * 18 * ops.shape[0], FP32_FLOP_PER_MS, "fp32"),
        "irls_first_matmul_fp32": (lambda: matmul_fp32(r_irls, c_irls), 2 * 256 * COHORT * 2,
                                   FP32_FLOP_PER_MS, "fp32"),
    }
    out = {}
    for name, (fn, ops_n, peak, kind) in cases.items():
        ms = statistics.median([_time_ms(fn), _time_ms(fn)])
        out[name] = {"ms": ms, "ops": ops_n, "share": ops_n / ms / peak}
        print(f"[3 kernels] product {name}: {ms:.4f} ms for {ops_n:.4g} {kind} ops, "
              f"{ops_n / ms / 1e9:.1f} TOP/s, {100 * ops_n / ms / peak:.1f}% of the card's "
              f"dense {kind} peak ({peak * 1e3 / 1e12:.0f} T/s)")
    irls_bytes = 4 * (256 * COHORT + COHORT * 2 + 256 * 2)
    out["irls_first_matmul_fp32"]["bound_ms"] = irls_bytes / HBM_BYTES_PER_MS
    print(f"[3 kernels] product irls_first_matmul_fp32 reads and writes {irls_bytes} B: bound "
          f"{irls_bytes / HBM_BYTES_PER_MS:.5f} ms at 3.35 TB/s, "
          f"{100 * irls_bytes / HBM_BYTES_PER_MS / out['irls_first_matmul_fp32']['ms']:.1f}% of it")
    return out


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


def _port_run(argv: list, device: str | None = None, stdout: Path | None = None) -> tuple:
    """One run of the port's CLI with ``argv`` as given, plus ``--device``
    when the subcommand has a card stage; stdout (text and
    ``sys.stdout.buffer``) goes to the file ``stdout`` when given. Returns
    its wall seconds and its stderr, which it prints for a cuda run."""
    from pgen_tpu_torch.cli import main as port_main

    argv = [*map(str, argv), *(["--device", device] if device else [])]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stderr(err))
        if stdout is not None:
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(open(stdout, "w"))))
        rc = port_main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"port CLI {' '.join(argv[:2])} returned {rc}\n{err.getvalue()}")
    if device != "cpu":
        for line in err.getvalue().strip().splitlines():
            print(f"    {line}")
    return seconds, err.getvalue()


def _port_cli(args: list, out: Path, device: str) -> tuple:
    """One run of the port's CLI (``args`` is the subcommand and its input,
    then its flags) with ``-o out`` and ``--stats``; returns its wall
    seconds and its stderr (the --stats report)."""
    return _port_run([*args, "-o", out, "--stats"], device)


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
    from pgen_tpu_torch.ops import (
        glm, gt_stats, gt_text, ld, pack, pca, relatedness, score, unpack)

    mods = (unpack, gt_text, pack, gt_stats, glm, score, relatedness, pca, ld)
    return {name: next(getattr(m, name) for m in mods if hasattr(m, name)) for name in KERNELS}


def _reset_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def make_fixtures(tmp: Path) -> dict:
    """The chr22-scale filesets, made by the port's own copy of
    tools/make_fixtures.py's ensure_chr22 (uniform record bytes, seed 22):
    full, ragged (phase 4) and import (phase 6)."""
    from pgen_tpu_torch.formats.fixtures import ensure_chr22

    t0 = time.perf_counter()
    made = {sub: ensure_chr22(tmp / sub, num_variants=n, uniform_bytes=True)
            for sub, n in (("full", CHR22_VARIANTS), ("ragged", RAGGED_VARIANTS),
                           ("import", IMPORT_VARIANTS))}
    size = Path(f"{made['full']}.pgen").stat().st_size
    print(f"[4 filter] fixtures in {time.perf_counter() - t0:.1f} s: "
          f"{CHR22_VARIANTS}, {RAGGED_VARIANTS} and {IMPORT_VARIANTS} variants x 2504 samples, "
          f"{size} B .pgen")
    return made


def phase_filter(tmp: Path, full: Path, ragged: Path) -> tuple:
    """The port's CLI on cuda for each configuration (launch counts read
    around these runs only), each output checked with numpy against the
    .pgen; then the same CLI on cpu, whose plain PyTorch text the CPU tests
    hold byte for byte against pgen_tpu, as the sha256 reference. Returns
    the launches and the sha256 of the keep-two and the plain keep-all
    outputs (phase 14's references)."""
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

    # untimed: the first filter of a process builds the port's C++ host
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
    return launches, {"keep-two": results[0][0][0], "keep-all": results[2][0][0]}


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


def _keep_samples(iids):
    """Phase 5's 1,001 samples, drawn with the seed, in file order."""
    import numpy as np

    return np.sort(np.random.default_rng(SEED).choice(len(iids), KEEP_SAMPLES, replace=False))


def phase_pgen_out(tmp: Path, full: Path) -> tuple:
    """filter --out-format pgen --keep (1,001 samples drawn with the seed) on
    the full chr22 fixture through the port's CLI on cuda (launch counts read
    around that run only). The .pgen body must equal a numpy re-pack of the
    fixture's records at the kept samples; the three files must be
    sha256-equal to the same CLI with --device cpu. Returns the launches and
    the .pgen's sha256 (phase 14's reference)."""
    import numpy as np

    iids, pos, _, packed = _read_fileset(full)
    keep = _keep_samples(iids)
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
    return launches, hashes[0]


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


def _stage_ms(stderr: str, stage: str) -> float:
    """A stage's milliseconds from a --stats report (a child stage's line
    is indented under its parent's)."""
    for line in stderr.splitlines():
        if line.lstrip(" ").startswith(f"{stage}: "):
            return float(line.split()[1])
    raise AssertionError(f"the --stats report has no {stage} stage")


def _argv_a(iids):
    return ["--include-var", 'ALT == "G"', "--samples", f"{iids[7]},{iids[2000]}"]


def phase_device_provider(tmp: Path, full: Path, ragged: Path) -> tuple:
    """filter --provider device through the port's CLI on cuda, as a lone
    process that makes no process group (launch counts read around these
    runs only; each run's process_group stage is printed and must stay
    under 50 ms):
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

    results, walls, groups = [], [], []
    _reset_launches()
    for label, prefix, argv, name, route, expect in runs:
        out = tmp / f"cuda.{name}"
        print(f"[7 device provider] {label} on cuda:")
        seconds, err = device_run(prefix, argv, out, "cuda")
        walls.append(seconds)
        group_ms = _stage_ms(err, "process_group")
        groups.append(group_ms)
        if group_ms > 50.0:
            raise AssertionError(f"{label}: process_group took {group_ms} ms in a lone process, "
                                 "which makes no group")
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
    import torch.distributed as dist

    if dist.is_initialized():
        raise AssertionError("a lone device-provider run left a process group behind")
    print(f"[7 device provider] process_group stage of the lone cuda runs (no group is made), ms: "
          f"{groups}")
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


GWAS_REGION = 50_000  # variants of phase 8 (b)
LOGISTIC_REGION = 20_000  # variants of phase 8 (c)
ORACLE_VARIANTS = 2000  # variants of phase 8 (a) held against numpy's least squares
INT_ORACLE_VARIANTS = 1500  # variants of (b) --interaction held against the same
PLANTED = 10  # variants with an effect on QT, QT0 and CC
SCORE_EVERY = 10  # phase 8 (d) scores every 10th variant


def _codes_numpy(packed, rows):
    """(len(rows), 4R) codes of the given records, every slot, decoded with
    a numpy byte table (LSB-first 2-bit codes), sharing no code with the
    port."""
    import numpy as np

    b = np.arange(256)
    table = np.stack([(b >> (2 * k)) & 3 for k in range(4)], axis=1).astype(np.uint8)
    return table[np.asarray(packed[rows])].reshape(len(rows), -1)


def _gwas_tables(tmp: Path, iids, packed) -> dict:
    """The seeded --pheno table (QT: normal around effects of 0.4 per allele
    planted on 10 variants plus the covariates, 2% NA; QT0: the same model
    with new noise and no NA; CC: 2 where the same model with logistic noise
    lies in its top 40%, else 1, 2% NA) and the --covar table (C1 normal, C2
    normal around 50 with sd 8). Returns the paths, the planted rows and the
    values as written (NaN for NA)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    n = len(iids)
    planted = np.sort(rng.choice(packed.shape[0], PLANTED, replace=False))
    codes = _codes_numpy(packed, planted)[:, :n].astype(np.float64)
    called = codes != 3
    g = np.where(called, codes, 0.0)
    mean = g.sum(axis=1, keepdims=True) / np.maximum(called.sum(axis=1, keepdims=True), 1)
    signal = (np.where(called, g, mean) - mean).sum(axis=0)
    c1, c2 = rng.normal(size=n), rng.normal(50.0, 8.0, size=n)
    model = 0.4 * signal + 0.3 * c1 + 0.02 * c2
    qt, qt0 = model + rng.normal(size=n), model + rng.normal(size=n)
    liability = model + rng.logistic(size=n)
    cc = np.where(liability > np.quantile(liability, 0.6), 2.0, 1.0)
    qt[rng.random(n) < 0.02] = np.nan
    cc[rng.random(n) < 0.02] = np.nan
    # what the files hold, read back as the port reads them
    values = {k: np.array([float(f"{x:.9g}") for x in v])
              for k, v in (("QT", qt), ("QT0", qt0), ("CC", cc), ("C1", c1), ("C2", c2))}

    def write(path, names):
        cells = ["\t".join(["#IID", *names])]
        for i, iid in enumerate(iids):
            cells.append("\t".join([iid] + ["NA" if np.isnan(values[k][i]) else f"{values[k][i]:.9g}"
                                            for k in names]))
        path.write_text("\n".join(cells) + "\n")

    write(tmp / "pheno.tsv", ("QT", "QT0", "CC"))
    write(tmp / "covar.tsv", ("C1", "C2"))
    return {"pheno": tmp / "pheno.tsv", "covar": tmp / "covar.tsv", "planted": planted,
            "values": values}


def _glm_table(path: Path) -> tuple:
    """A .glm table as (header, the 8 leading columns of each row, (rows, 4)
    f64 numbers with NaN for NA)."""
    import numpy as np

    lines = path.read_text().splitlines()
    rows = [ln.split("\t") for ln in lines[1:]]
    nums = np.array([[np.nan if c == "NA" else float(c) for c in r[8:12]] for r in rows])
    return lines[0], [r[:8] for r in rows], nums.reshape(len(rows), 4)


def _ols_oracle(packed, rows, cohort, y, covars) -> tuple:
    """numpy f64 least squares of y on [1, covars, g] over each variant's
    called samples of the cohort: (OBS_CT, BETA, SE, T) of g, NaN where the
    design is not estimable (fewer than one residual degree of freedom, or
    no dosage variance)."""
    import numpy as np

    codes = _codes_numpy(packed, rows)[:, cohort]
    out = np.full((len(rows), 4), np.nan)
    for i, c in enumerate(codes):
        m = c != 3
        g = c[m].astype(np.float64)
        x = np.column_stack([np.ones(m.sum()), covars[m], g])
        out[i, 0] = m.sum()
        df = m.sum() - x.shape[1]
        if df < 1 or g.var() <= 1e-9:
            continue
        xtx_inv = np.linalg.inv(x.T @ x)
        beta = xtx_inv @ (x.T @ y[m])
        rss = float(((y[m] - x @ beta) ** 2).sum())
        se = np.sqrt(rss / df * xtx_inv[-1, -1])
        out[i, 1:] = beta[-1], se, beta[-1] / se
    return out


def _worst(got, want, rtol: float, atol) -> float:
    """The largest |got - want| / (atol + rtol |want|) where want is a
    number (atol may be an array shaped as want)."""
    import numpy as np

    ok = ~np.isnan(want)
    atol = np.broadcast_to(atol, want.shape)[ok]
    ratio = np.abs(got[ok] - want[ok]) / (atol + rtol * np.abs(want[ok]))
    return float(ratio.max()) if ratio.size else 0.0


def _assert_close(label: str, got, want, rtol: float, atol) -> float:
    """np.isclose(got, want, rtol, atol) everywhere both are numbers, the
    same NaN cells; returns the largest |got - want| / (atol + rtol |want|)."""
    import numpy as np

    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{label}: NA cells differ")
    worst = _worst(got, want, rtol, atol)
    if worst > 1.0:
        raise AssertionError(f"{label}: off by {worst:.3g} x the tolerance (rtol {rtol})")
    return worst


def _compare_glm_runs(label: str, got: Path, want: Path, rtol: float, atol: float,
                      logistic: bool = False) -> str:
    """Two .glm tables of one design: the same header, leading columns
    (TEST and OBS_CT included) and NA cells; BETA (log OR) and SE within
    atol + rtol |value| (pgen_tpu's own form), the statistic and P within
    pgen_tpu's 1e-2 / 1e-3."""
    import numpy as np

    hg, lg, ng = _glm_table(got)
    hw, lw, nw = _glm_table(want)
    if hg != hw or lg != lw:
        raise AssertionError(f"{label}: header or leading columns differ")
    if logistic:
        ng[:, 0], nw[:, 0] = np.log(ng[:, 0]), np.log(nw[:, 0])
    beta = _assert_close(f"{label} BETA", ng[:, 0], nw[:, 0], rtol, atol)
    se = _assert_close(f"{label} SE", ng[:, 1], nw[:, 1], rtol, atol)
    stat = _assert_close(f"{label} statistic/P", ng[:, 2:], nw[:, 2:], 1e-2, 1e-3)
    return (f"{len(lg)} rows, {int(np.isnan(nw[:, 0]).sum())} NA; worst BETA {beta:.3g} of "
            f"its tolerance (rtol {rtol} atol {atol} on |BETA| alone), SE {se:.3g}, "
            f"statistic/P {stat:.3g}")


def _interaction_oracle(packed, rows, cohort, y, covars) -> tuple:
    """numpy f64 least squares of y on [1, covars, g, g * covars] over each
    variant's called samples: (OBS_CT (rows,), BETA and SE (rows, 1 + k)) of
    g and of each g * covariate, at the covariates as given (plink2's raw
    parameterisation); NaN where the design is not estimable."""
    import numpy as np

    k = covars.shape[1]
    codes = _codes_numpy(packed, rows)[:, cohort]
    obs = np.zeros(len(rows))
    beta = np.full((len(rows), 1 + k), np.nan)
    se = np.full((len(rows), 1 + k), np.nan)
    for i, c in enumerate(codes):
        m = c != 3
        g = c[m].astype(np.float64)
        x = np.column_stack([np.ones(m.sum()), covars[m], g, g[:, None] * covars[m]])
        obs[i] = m.sum()
        df = m.sum() - x.shape[1]
        if df < 1 or g.var() <= 1e-9:
            continue
        # centred covariates condition the solve; the raw ADD term follows
        # from beta_g - sum_i mean_i beta_gci and the same map on the covariance
        mean = covars[m].mean(axis=0)
        xc = np.column_stack([np.ones(m.sum()), covars[m] - mean, g, g[:, None] * (covars[m] - mean)])
        inv = np.linalg.inv(xc.T @ xc)
        b = inv @ (xc.T @ y[m])
        rss = float(((y[m] - xc @ b) ** 2).sum())
        w = np.zeros((1 + k, x.shape[1]))  # rows: ADD raw, then each ADDxC
        w[0, 1 + k] = 1.0
        w[0, 2 + k:] = -mean
        w[1:, 2 + k:] = np.eye(k)
        beta[i] = w @ b
        se[i] = np.sqrt(rss / df * np.einsum("tj,jk,tk->t", w, inv, w))
    return obs, beta, se


def _score_oracle(packed, rows, flip, weights, mean_impute: bool, n_samples: int) -> tuple:
    """numpy f64 scores over every sample: (sums (S, Kw), dosage sums,
    ALLELE_CT), with plink2's mean imputation or 0 for a missing call."""
    import numpy as np

    sums = np.zeros((n_samples, weights.shape[1]))
    dosage = np.zeros(n_samples)
    called_ct = np.zeros(n_samples, dtype=np.int64)
    used = 0
    for lo in range(0, len(rows), GLM_ROWS):
        hi = min(lo + GLM_ROWS, len(rows))
        c = _codes_numpy(packed, rows[lo:hi])[:, :n_samples].astype(np.float64)
        called = c != 3
        d = np.where(flip[lo:hi, None], 2.0 - c, c) * called
        n_called = called.sum(axis=1)
        used += int((n_called > 0).sum())
        if mean_impute:
            fill = d.sum(axis=1) / np.maximum(n_called, 1)
            d = np.where(called, d, fill[:, None])
        sums += d.T @ weights[lo:hi]
        dosage += d.sum(axis=0)
        called_ct += called.sum(axis=0)
    allele_ct = np.full(n_samples, 2 * used) if mean_impute else 2 * called_ct
    return sums, dosage, allele_ct


def _weights_table(tmp: Path, full: Path, n_var: int, rng) -> tuple:
    """Phase 8 (d)'s score table ``tmp/weights.tsv``: three weight columns
    on every 10th variant, drawn from ``rng``, the effect allele REF on
    about half. Returns (the scored rows, their flips, the weights as
    written)."""
    import numpy as np

    score_rows = np.arange(0, n_var, SCORE_EVERY)
    flip = rng.random(len(score_rows)) < 0.5
    weights = np.array([[float(f"{w:.6g}") for w in r] for r in rng.normal(size=(len(score_rows), 3))])
    pvar = [ln.split(b"\t", 5) for ln in Path(f"{full}.pvar").read_bytes().split(b"\n")
            if ln and not ln.startswith(b"#")]
    with open(tmp / "weights.tsv", "w") as fh:
        fh.write("ID\tA1\tW1\tW2\tW3\n")
        for r, f, w in zip(score_rows, flip, weights):
            fields = pvar[r]
            fh.write(f"{fields[2].decode()}\t{fields[3 if f else 4].decode()}\t"
                     f"{w[0]:.6g}\t{w[1]:.6g}\t{w[2]:.6g}\n")
    return score_rows, flip, weights


def _sscore(path: Path) -> tuple:
    import numpy as np

    lines = path.read_text().splitlines()
    rows = [ln.split("\t") for ln in lines[1:]]
    return lines[0].split("\t"), [r[0] for r in rows], np.array([r[1:] for r in rows], dtype=np.float64)


def phase_gwas(tmp: Path, full: Path, device: str = "cuda") -> dict:
    """glm and score through the port's CLI on ``device`` (launch counts
    read around those runs only), on the full chr22 fixture with seeded
    phenotype, covariate and weight tables: (a) linear QT ~ C1 + C2 over all
    variants against numpy's f64 least squares on 2,000 seeded variants
    (BETA/SE rtol 1e-3 atol 1e-5 and T rtol 1e-2 atol 1e-3, pgen_tpu's
    device-vs-numpy bounds; OBS_CT exact; the same NA cells) and the planted
    variants the 10 smallest P; (b) --modifier genotypic and --interaction
    with QT0 over a 50,000-variant region against --device cpu (rtol 2e-4
    atol 1e-6 on BETA and on SE, each alone: pgen_tpu's interaction
    provider bound), the interaction table also against numpy's f64 least
    squares on 1,500 seeded variants at the same bound; (c) logistic CC over
    a 20,000-variant region against --device cpu (the same at rtol 2e-3
    atol 2e-5 on log OR); (d) score of three weight columns on every 10th variant,
    half the effect alleles REF, with and without --no-mean-imputation,
    against numpy's f64 sums (ALLELE_CT exact, |d sum| <= 1e-4 max|sum|)."""
    import numpy as np

    iids, pos, _, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    t0 = time.perf_counter()
    tables = _gwas_tables(tmp, iids, packed)
    ph, cv, planted, values = tables["pheno"], tables["covar"], tables["planted"], tables["values"]
    rng = np.random.default_rng(SEED + 8)
    score_rows, flip, weights = _weights_table(tmp, full, n_var, rng)
    print(f"[8 GWAS] tables in {time.perf_counter() - t0:.1f} s: --pheno QT, QT0, CC and --covar "
          f"C1, C2 over {n} samples, effects planted on variants {planted.tolist()}; "
          f"{len(score_rows)} score lines, {int(flip.sum())} with the effect allele REF")

    def region(first, count):
        return f"22:{pos[first]}-{pos[first + count - 1]}"

    region_b = region(n_var // 2 - GWAS_REGION // 2, GWAS_REGION)
    region_c = region(n_var // 4, LOGISTIC_REGION)
    tabs = ["--pheno", ph, "--covar", cv, "--covar-name", "C1,C2"]
    runs = [
        # label, argv, output name, compared with --device cpu
        ("(a) linear QT ~ C1 + C2, every variant", ["glm", full, *tabs, "--pheno-name", "QT"],
         "a.glm", False),
        (f"(b) --modifier genotypic QT0 -r {region_b}",
         ["glm", full, *tabs, "--pheno-name", "QT0", "--modifier", "genotypic", "-r", region_b],
         "b_geno.glm", True),
        (f"(b) --interaction QT0 -r {region_b}",
         ["glm", full, *tabs, "--pheno-name", "QT0", "--interaction", "-r", region_b],
         "b_int.glm", True),
        (f"(c) logistic CC -r {region_c}", ["glm", full, *tabs, "--pheno-name", "CC", "-r", region_c],
         "c.glm", True),
        ("(d) score, mean imputation", ["score", full, "--score", tmp / "weights.tsv",
                                        "--score-col-nums", "3-5", "--score-sums"], "d.sscore", False),
        ("(d) score --no-mean-imputation", ["score", full, "--score", tmp / "weights.tsv",
                                            "--score-col-nums", "3-5", "--score-sums",
                                            "--no-mean-imputation"], "d_nm.sscore", False),
    ]
    walls = {}
    _reset_launches()
    for label, argv, name, _ in runs:
        print(f"[8 GWAS] {label} on {device}:")
        walls[name] = _port_cli(argv, tmp / f"{device}.{name}", device)[0]
    launches = _read_launches()

    # (a) against numpy's least squares, and the planted variants on top
    head, lead, nums = _glm_table(tmp / f"{device}.a.glm")
    if head.split("\t")[6:9] != ["TEST", "OBS_CT", "BETA"] or len(lead) != n_var:
        raise AssertionError(f"(a): {len(lead)} rows under {head!r}; expected {n_var} ADD rows")
    if any(r[1] != str(p) or r[6] != "ADD" for r, p in zip(lead, pos)):
        raise AssertionError("(a): rows are not the fileset's variants in order")
    p = nums[:, 3]
    top = np.argsort(np.where(np.isnan(p), np.inf, p), kind="stable")[:PLANTED]
    if set(top.tolist()) != set(planted.tolist()):
        raise AssertionError(f"(a): the 10 smallest P are at {sorted(top.tolist())}, "
                             f"effects were planted at {planted.tolist()}")
    pick = np.union1d(np.sort(rng.choice(n_var, ORACLE_VARIANTS - PLANTED, replace=False)), planted)
    cohort = np.flatnonzero(~np.isnan(values["QT"]))
    want = _ols_oracle(packed, pick, cohort, values["QT"][cohort],
                       np.column_stack([values["C1"], values["C2"]])[cohort])
    obs = np.array([int(lead[v][7]) for v in pick])
    if not np.array_equal(obs, want[:, 0]):
        raise AssertionError("(a): OBS_CT differs from numpy's called counts")
    est = _assert_close("(a) BETA/SE", nums[pick, :2], want[:, 1:3], 1e-3, 1e-5)
    stat = _assert_close("(a) T_STAT", nums[pick, 2], want[:, 3], 1e-2, 1e-3)
    (tmp / f"{device}.a.glm").unlink()
    print(f"[8 GWAS] (a) {n_var} ADD rows over {len(cohort)} samples: the planted variants are "
          f"the {PLANTED} smallest P (largest of them {np.nanmax(p[planted]):.3g}, next "
          f"{np.sort(p[~np.isin(np.arange(n_var), planted)])[0]:.3g}); on {len(pick)} seeded "
          f"variants OBS_CT equal to numpy's, BETA/SE within {est:.3g} and T within {stat:.3g} "
          f"of their tolerances against numpy's f64 least squares; wall {walls['a.glm']:.3f} s")

    # (b) --interaction against numpy's f64 least squares too, BETA and SE
    # at pgen_tpu's interaction bound alone
    head, lead, nums = _glm_table(tmp / f"{device}.b_int.glm")
    first_b = n_var // 2 - GWAS_REGION // 2
    if len(lead) != 3 * GWAS_REGION or [r[6] for r in lead[:3]] != ["ADD", "ADDxC1", "ADDxC2"]:
        raise AssertionError(f"(b) --interaction: {len(lead)} rows, tests {[r[6] for r in lead[:3]]}")
    pick_b = np.sort(rng.choice(GWAS_REGION, INT_ORACLE_VARIANTS, replace=False))
    everyone = np.arange(n)
    obs, want_beta, want_se = _interaction_oracle(
        packed, first_b + pick_b, everyone, values["QT0"],
        np.column_stack([values["C1"], values["C2"]]))
    at = (3 * pick_b[:, None] + np.arange(3)[None, :]).reshape(-1)
    if not np.array_equal(np.array([int(lead[i][7]) for i in at[::3]]), obs):
        raise AssertionError("(b) --interaction: OBS_CT differs from numpy's called counts")
    int_beta = _assert_close("(b) --interaction BETA vs f64", nums[at, 0], want_beta.reshape(-1),
                             2e-4, 1e-6)
    int_se = _assert_close("(b) --interaction SE vs f64", nums[at, 1], want_se.reshape(-1),
                           2e-4, 1e-6)
    print(f"[8 GWAS] (b) --interaction on {device} against numpy's f64 least squares on "
          f"{INT_ORACLE_VARIANTS} seeded variants (ADD, ADDxC1, ADDxC2): OBS_CT equal, worst BETA "
          f"{int_beta:.3g} and SE {int_se:.3g} of rtol 2e-4 atol 1e-6 on the value alone")

    # (b), (c) against --device cpu
    for label, argv, name, vs_cpu in runs:
        if not vs_cpu:
            continue
        cpu_s = _port_cli(argv, tmp / f"vs_cpu.{name}", "cpu")[0]
        logistic = name == "c.glm"
        rtol, atol = (2e-3, 2e-5) if logistic else (2e-4, 1e-6)
        report = _compare_glm_runs(label, tmp / f"{device}.{name}", tmp / f"vs_cpu.{name}", rtol,
                                   atol, logistic)
        for out in (f"{device}.{name}", f"vs_cpu.{name}"):
            (tmp / out).unlink()
        print(f"[8 GWAS] {label}: {device} equal to cpu in header, leading columns and NA "
              f"cells; {report}; wall {device} {walls[name]:.3f} s, cpu {cpu_s:.3f} s")

    # (d) against numpy's f64 sums
    for name, mean_impute in (("d.sscore", True), ("d_nm.sscore", False)):
        head, got_iids, got = _sscore(tmp / f"{device}.{name}")
        sums, dosage, allele_ct = _score_oracle(packed, score_rows, flip, weights, mean_impute, n)
        if got_iids != list(iids) or head[:3] != ["#IID", "ALLELE_CT", "DOSAGE_SUM"]:
            raise AssertionError(f"(d) {name}: samples or header differ")
        if not np.array_equal(got[:, 0], allele_ct):
            raise AssertionError(f"(d) {name}: ALLELE_CT differs from numpy's")
        drift = []
        for col, want_col in ((got[:, 1], dosage), *zip(got[:, 5:8].T, sums.T)):
            d = float(np.abs(col - want_col).max() / np.abs(want_col).max())
            if d > 1e-4:
                raise AssertionError(f"(d) {name}: |d sum| {d:.3g} of max|sum|, over 1e-4")
            drift.append(d)
        avg = got[:, 2:5] - sums / np.maximum(allele_ct, 1)[:, None]
        if np.abs(avg).max() > 1e-4 * np.abs(sums / np.maximum(allele_ct, 1)[:, None]).max():
            raise AssertionError(f"(d) {name}: averages differ from numpy's")
        (tmp / f"{device}.{name}").unlink()
        print(f"[8 GWAS] (d) {name}: {n} samples x {len(score_rows)} variants, ALLELE_CT equal to "
              f"numpy's, |d sum| / max|sum| against numpy's f64: DOSAGE_SUM {drift[0]:.3g}, "
              f"W1-W3 {drift[1]:.3g} {drift[2]:.3g} {drift[3]:.3g}; wall {walls[name]:.3f} s")
    print(f"[8 GWAS] path launches: {launches}")
    return launches


REL_REGION = 20_000  # variants of phase 9's region runs
REL_COHORT = 1001  # samples of phase 9's --samples-file
REL_PAIRS = 64  # sample pairs held against the numpy oracle
REL_SAMPLES = 64  # samples whose GRM entries are held against it
PCA_K = 10


def _relatedness_oracle(packed, n_samples: int, pairs, samples) -> dict:
    """numpy over every variant, sharing no code with the port: for each
    (i, j) of ``pairs`` the both-called counts of het/het, i hom-ref with j
    hom-alt and the reverse, hom-ref/hom-ref, hom-alt/hom-alt, i het and j
    het; and the f64 GRM sum over ``samples`` (z from each row's alt
    frequency over all samples, 0 on a missing call and a monomorphic row)
    with the count of polymorphic rows. Rows' code counts by popcount over
    16-bit words (S = 4R: no pad slots)."""
    import numpy as np

    rec = packed.shape[1]
    if 4 * rec != n_samples or rec % 2:
        raise AssertionError("the oracle counts whole 16-bit words: S = 4R with R even")
    pc16 = np.array([bin(x).count("1") for x in range(1 << 16)], dtype=np.uint8)
    keys = ("hethet", "ra", "ar", "rr", "aa", "het_i", "het_j", "nsnp")
    counts = {k: np.zeros(len(pairs), dtype=np.int64) for k in keys}
    gram = np.zeros((len(samples), len(samples)))
    m_used = 0
    union = np.union1d(samples, pairs.reshape(-1))
    byte_of, shift = union >> 2, (2 * (union & 3)).astype(np.uint8)
    at_z, at_i, at_j = (np.searchsorted(union, x) for x in (samples, pairs[:, 0], pairs[:, 1]))
    for lo in range(0, packed.shape[0], BLOCK_ROWS):
        blk = np.asarray(packed[lo : lo + BLOCK_ROWS])
        words = blk.view(np.uint16)
        low, high = words & 0x5555, (words >> 1) & 0x5555
        n_l = pc16[low].sum(1, dtype=np.int64)
        n_h = pc16[high].sum(1, dtype=np.int64)
        n_b = pc16[low & high].sum(1, dtype=np.int64)
        called = n_samples - n_b
        ac = (n_l - n_b) + 2 * (n_h - n_b)
        p = ac / np.maximum(2 * called, 1)
        var = 2 * p * (1 - p)
        used = var > 0
        m_used += int(used.sum())
        codes = (blk[:, byte_of] >> shift) & 3
        g = codes[:, at_z]
        ok = (g != 3) & used[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(ok, (g - 2 * p[:, None]) / np.sqrt(var)[:, None], 0.0)
        gram += z.T @ z
        ci, cj = codes[:, at_i], codes[:, at_j]
        both = (ci != 3) & (cj != 3)
        for key, hit in (("hethet", (ci == 1) & (cj == 1)), ("ra", (ci == 0) & (cj == 2)),
                         ("ar", (ci == 2) & (cj == 0)), ("rr", (ci == 0) & (cj == 0)),
                         ("aa", (ci == 2) & (cj == 2)), ("het_i", ci == 1), ("het_j", cj == 1),
                         ("nsnp", both)):
            counts[key] += (both & hit).sum(0)
    return {"pairs": counts, "gram": gram, "m_used": m_used}


def _table_rows(path: Path, rows) -> list:
    """The lines at body indices ``rows`` (0 = the line after the header)
    of a table, as lists of fields."""
    lines = path.read_bytes().split(b"\n")
    return [lines[1 + r].decode().split("\t") for r in rows]


def _pair_row(i, j, n: int):
    """Body index of pair (i, j), i < j, in the triu order the tables use."""
    return i * (2 * n - i - 1) // 2 + (j - i - 1)


def _last_column(path: Path):
    """A table's last column (KINSHIP, PI_HAT) as floats."""
    import numpy as np

    body = path.read_bytes().split(b"\n")[1:-1]
    return np.array([float(line.rsplit(b"\t", 1)[1]) for line in body])


def _same_files(label: str, files) -> None:
    """Each (cuda, cpu) pair of files sha256-equal; both deleted."""
    for got, want in files:
        if _sha256(got) != _sha256(want):
            raise AssertionError(f"{label}: {got.name} differs from --device cpu's {want.name}")
        got.unlink()
        want.unlink()


def _pca_outputs(prefix: Path, n_samples: int) -> tuple:
    import numpy as np

    vals = np.loadtxt(f"{prefix}.eigenval", ndmin=1)
    vecs = np.loadtxt(f"{prefix}.eigenvec", skiprows=1, usecols=range(1, 1 + len(vals)), ndmin=2)
    if vecs.shape != (n_samples, len(vals)):
        raise AssertionError(f"{prefix.name}.eigenvec: shape {vecs.shape}")
    return vals, vecs


def _m_used(stderr: str) -> int:
    found = re.search(r"x (\d+) polymorphic variants", stderr)
    if not found:
        raise AssertionError("pca's stderr names no polymorphic variant count")
    return int(found.group(1))


def phase_relatedness(tmp: Path, full: Path) -> dict:
    """king, genome and pca through the port's CLI with --device cuda on
    the full chr22 fixture (launch counts read around these runs only):
    (a) king over every variant, NSNP/HETHET/IBS0/KINSHIP text of 64 seeded
    pairs equal to a numpy f64 oracle's; then a 20,000-variant region with
    --samples-file of 1,001 seeded IIDs, with all samples over --min-kinship
    at the cohort's 99.9th-percentile kinship (about 0.1% of the 3.1M rows,
    which the emission of every row would spend 10-22 s a run on), and the
    cohort's --cutoff at that kinship (samples drop), each output
    sha256-equal to --device cpu; (b) genome the same way (--min-pi-hat at
    the cohort's 99.9th-percentile PI_HAT), IBS0/IBS1/IBS2 and NSNP of the
    64 pairs equal to the oracle's; (c) pca -k 10
    --make-rel bin over every variant: .rel.bin x m_used on 64 seeded
    samples within 1e-6 max|GRM| of the oracle's f64 GRM and m_used its
    count of polymorphic rows, the region's GRM within the same bound of
    --device cpu's and its eigenvalues at rtol 1e-3; (d) pca -k 10
    --approx: orthonormal eigenvectors (1e-6), each eigenvalue at most
    (1 + 1e-3) times (c)'s, descending; the region's at rtol 1e-3 of
    --device cpu's --approx. Both exact runs on cuda decompose the GRM on
    the card (``pca_from_grm.tensor_calls``)."""
    import numpy as np
    import torch

    from pgen_tpu_torch.ops.pca import pca_from_grm

    iids, pos, _, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    rng = np.random.default_rng(SEED + 9)
    first = n_var // 2 - REL_REGION // 2
    region = f"22:{pos[first]}-{pos[first + REL_REGION - 1]}"
    cohort = np.sort(rng.choice(n, REL_COHORT, replace=False))
    (tmp / "cohort.txt").write_text("".join(f"{iids[s]}\n" for s in cohort))
    pairs = np.sort(rng.choice(n, (4 * REL_PAIRS, 2)), axis=1)
    pairs = np.unique(pairs[pairs[:, 0] < pairs[:, 1]], axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:REL_PAIRS]]
    samples = np.sort(rng.choice(n, REL_SAMPLES, replace=False))
    region_args = ["-r", region]
    cohort_args = [*region_args, "--samples-file", tmp / "cohort.txt"]
    walls, memory = {}, {}

    def run(label, argv, out, device="cuda"):
        if device == "cuda":
            print(f"[9 relatedness] {label} on cuda:")
        seconds, err = _port_cli(argv, out, device)
        walls[f"{label} {device}"] = seconds
        return err

    _reset_launches()
    eighs = pca_from_grm.tensor_calls
    for label, argv, out in (("(a) king, every variant", ["king", full], "king.kin0"),
                             ("(b) genome, every variant", ["genome", full], "genome.genome")):
        torch.cuda.reset_peak_memory_stats()
        run(label, argv, tmp / out)
        memory[label] = torch.cuda.max_memory_allocated()
        print(f"[9 relatedness] {label}: peak device memory {memory[label] / 1e6:.1f} MB")
    err_c = run("(c) pca -k 10 --make-rel bin, every variant",
                ["pca", full, "-k", PCA_K, "--make-rel", "bin"], tmp / "pca_full")
    run("(d) pca -k 10 --approx, every variant", ["pca", full, "-k", PCA_K, "--approx"],
        tmp / "approx_full")
    region_runs = [
        ("(a) king -r --samples-file", ["king", full, *cohort_args], "king_c.kin0"),
        ("(b) genome -r --samples-file", ["genome", full, *cohort_args], "genome_c.genome"),
        ("(c) pca -r --make-rel bin", ["pca", full, *region_args, "-k", PCA_K, "--make-rel",
                                       "bin"], "pca_r"),
        ("(d) pca -r --approx", ["pca", full, *region_args, "-k", PCA_K, "--approx"], "approx_r"),
    ]
    for label, argv, name in region_runs:
        run(label, argv, tmp / f"cuda.{name}")
    # the cohort's 99.9th percentiles: --cutoff on the cohort, and the
    # thresholds of the region's every-sample tables (whose 3.1M emitted
    # rows would take 10-22 s a run on each device)
    cutoff = float(f"{np.nanpercentile(_last_column(tmp / 'cuda.king_c.kin0'), 99.9):.6g}")
    min_pi = float(f"{np.nanpercentile(_last_column(tmp / 'cuda.genome_c.genome'), 99.9):.4f}")
    region_runs += [
        (f"(a) king -r --min-kinship {cutoff}",
         ["king", full, *region_args, "--min-kinship", cutoff], "king_r.kin0"),
        (f"(b) genome -r --min-pi-hat {min_pi}",
         ["genome", full, *region_args, "--min-pi-hat", min_pi], "genome_r.genome"),
        (f"(a) king -r --samples-file --cutoff {cutoff}",
         ["king", full, *cohort_args, "--cutoff", cutoff], "cut"),
    ]
    for label, argv, name in region_runs[-3:]:
        run(label, argv, tmp / f"cuda.{name}")
    launches = _read_launches()
    for kname in ("relatedness_bits", "relatedness_gram", "grm_z", "pca_approx_pass"):
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the relatedness path")
    if pca_from_grm.tensor_calls - eighs != 2:  # (c) over every variant and on the region
        raise AssertionError(f"exact pca decomposed {pca_from_grm.tensor_calls - eighs} GRMs "
                             "on the card, not 2")

    t0 = time.perf_counter()
    oracle = _relatedness_oracle(packed, n, pairs, samples)
    print(f"[9 relatedness] numpy f64 oracle over {n_var} variants ({len(pairs)} pairs, "
          f"{len(samples)} samples) in {time.perf_counter() - t0:.1f} s")

    # (a), (b) over every variant against the oracle
    o = oracle["pairs"]
    rows = _table_rows(tmp / "king.kin0", [_pair_row(i, j, n) for i, j in pairs])
    for k, ((i, j), got) in enumerate(zip(pairs, rows)):
        nn = int(o["nsnp"][k])
        ibs0 = float(o["ra"][k] + o["ar"][k])
        den = float(o["het_i"][k] + o["het_j"][k])
        kinship = (float(o["hethet"][k]) - 2.0 * ibs0) / den if den > 0 else float("nan")
        want = [iids[i], iids[j], str(nn), f"{o['hethet'][k] / max(nn, 1):.6g}",
                f"{ibs0 / max(nn, 1):.6g}", f"{kinship:.6g}"]
        if got != want:
            raise AssertionError(f"(a) king pair ({i}, {j}): {got} != oracle {want}")
    rows = _table_rows(tmp / "genome.genome", [_pair_row(i, j, n) for i, j in pairs])
    for k, ((i, j), got) in enumerate(zip(pairs, rows)):
        ibs0 = int(o["ra"][k] + o["ar"][k])
        ibs2 = int(o["rr"][k] + o["hethet"][k] + o["aa"][k])
        want = [iids[i], iids[j], str(int(o["nsnp"][k])), str(ibs0),
                str(int(o["nsnp"][k]) - ibs0 - ibs2), str(ibs2)]
        if got[:6] != want:
            raise AssertionError(f"(b) genome pair ({i}, {j}): {got[:6]} != oracle {want}")
    n_rows = [len((tmp / f).read_bytes().split(b"\n")) - 2 for f in ("king.kin0", "genome.genome")]
    if n_rows != [n * (n - 1) // 2] * 2:
        raise AssertionError(f"(a), (b): {n_rows} rows, expected {n * (n - 1) // 2} each")
    for f in ("king.kin0", "genome.genome"):
        (tmp / f).unlink()
    print(f"[9 relatedness] (a) king and (b) genome over {n_var} variants: {n_rows[0]} pairs "
          f"each; NSNP, HETHET, IBS0, KINSHIP and IBS0/1/2 of {len(pairs)} seeded pairs equal "
          f"to the oracle's text; walls {walls['(a) king, every variant cuda']:.3f} s and "
          f"{walls['(b) genome, every variant cuda']:.3f} s")

    # (c) over every variant against the oracle
    m_used = _m_used(err_c)
    if m_used != oracle["m_used"]:
        raise AssertionError(f"(c) m_used {m_used} != the oracle's {oracle['m_used']}")
    rel = np.fromfile(tmp / "pca_full.rel.bin", dtype="<f8").reshape(n, n)
    got = rel[np.ix_(samples, samples)] * m_used
    bound = 1e-6 * np.abs(oracle["gram"]).max()
    worst = float(np.abs(got - oracle["gram"]).max())
    if worst > bound:
        raise AssertionError(f"(c) GRM x m_used off the oracle by {worst:.4g} > {bound:.4g}")
    vals_c, _ = _pca_outputs(tmp / "pca_full", n)
    print(f"[9 relatedness] (c) pca over {n_var} variants: m_used {m_used} equal to the "
          f"oracle's; GRM x m_used on {len(samples)} samples within {worst:.4g} of the oracle's "
          f"f64 (bound 1e-6 max|GRM| = {bound:.4g}); eigenvalues {np.round(vals_c, 4).tolist()}")
    # (d) over every variant against (c)
    vals_d, vecs_d = _pca_outputs(tmp / "approx_full", n)
    ortho = float(np.abs(vecs_d.T @ vecs_d - np.eye(PCA_K)).max())
    if ortho > 1e-6:
        raise AssertionError(f"(d) eigenvectors off orthonormal by {ortho:.3g}")
    if np.any(vals_d > (1 + 1e-3) * vals_c) or np.any(np.diff(vals_d) > 0):
        raise AssertionError(f"(d) Rayleigh-Ritz values {vals_d} do not interlace (c)'s {vals_c}")
    print(f"[9 relatedness] (d) --approx over {n_var} variants: eigenvectors orthonormal within "
          f"{ortho:.3g}; eigenvalues at {np.round(vals_d / vals_c, 5).tolist()} of (c)'s")

    # the region runs against --device cpu
    for label, argv, name in region_runs:
        run(label, argv, tmp / f"cpu.{name}", "cpu")
    dropped = len((tmp / "cuda.cut.king.cutoff.out.id").read_text().split())
    if not dropped:
        raise AssertionError(f"(a) --cutoff {cutoff}: no sample dropped")
    kept_rows = [len((tmp / f"cuda.{f}").read_bytes().split(b"\n")) - 2
                 for f in ("king_r.kin0", "genome_r.genome")]
    if min(kept_rows) < 1 or max(kept_rows) > n * (n - 1) // 50:
        raise AssertionError(f"region tables over the thresholds kept {kept_rows} rows")
    _same_files("(a), (b) region", [(tmp / f"cuda.{f}", tmp / f"cpu.{f}") for f in (
        "king_r.kin0", "king_c.kin0", "genome_r.genome", "genome_c.genome",
        "cut.king.cutoff.in.id", "cut.king.cutoff.out.id")])
    rel_gpu = np.fromfile(tmp / "cuda.pca_r.rel.bin", dtype="<f8")
    rel_cpu = np.fromfile(tmp / "cpu.pca_r.rel.bin", dtype="<f8")
    bound_r = 1e-6 * np.abs(rel_cpu).max()
    worst_r = float(np.abs(rel_gpu - rel_cpu).max())
    if worst_r > bound_r:
        raise AssertionError(f"(c) region GRM off --device cpu's by {worst_r:.4g} > {bound_r:.4g}")
    ratios = []
    for name in ("pca_r", "approx_r"):
        got_vals, _ = _pca_outputs(tmp / f"cuda.{name}", n)
        want_vals, _ = _pca_outputs(tmp / f"cpu.{name}", n)
        ratio = float(np.abs(got_vals / want_vals - 1).max())
        if ratio > 1e-3:
            raise AssertionError(f"{name}: eigenvalues off --device cpu's by {ratio:.3g} (rtol 1e-3)")
        ratios.append(ratio)
    print(f"[9 relatedness] region {region} ({REL_REGION} variants): king and genome tables of "
          f"{REL_COHORT} samples, of all samples over --min-kinship {cutoff} and --min-pi-hat "
          f"{min_pi} ({kept_rows[0]} and {kept_rows[1]} rows), and the cohort's --cutoff {cutoff} "
          f"id files ({dropped} samples dropped) sha256-equal to --device cpu; the GRM within "
          f"{worst_r:.4g} of cpu's (bound "
          f"{bound_r:.4g}), eigenvalues within {ratios[0]:.3g} (exact) and {ratios[1]:.3g} "
          "(--approx) of cpu's, rtol 1e-3")
    shown = "; ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"[9 relatedness] walls: {shown}")
    print(f"[9 relatedness] path launches: {launches}")
    return launches


COUNT_REGION = 20_000  # variants of phase 10's runs against --device cpu
COUNT_ORACLE_VARIANTS = 2000  # variants of phase 10 held against its numpy oracle
POPS = ("AFR", "AMR", "EAS", "EUR", "SAS")  # phase 10's fst cohorts (COHORTS of them)
# phase 10 (c), beside stats: each report and the extension of its -o file
# (missing's -o is a prefix of .vmiss and .smiss)
REPORTS = {"freq": ".afreq", "gcount": ".gcount", "hardy": ".hardy", "missing": "", "het": ".het"}


def _port_stdout(argv: list, out: Path, device: str) -> tuple:
    """One run of the port's CLI whose table goes to stdout (query, stats),
    written to ``out``; returns its wall seconds and its stderr."""
    return _port_run(argv, device, stdout=out)


def _masked_counts_numpy(packed, rows, samples):
    """(len(rows), 4) code counts of the given records over the given
    samples (distinct ids), from numpy-decoded codes."""
    import numpy as np

    codes = _codes_numpy(packed, rows)[:, samples]
    return np.stack([(codes == k).sum(1) for k in range(4)], 1)


def _lines(path: Path) -> list:
    """A table's lines after its header, as lists of fields."""
    return [line.split("\t") for line in path.read_text().splitlines()[1:]]


def _fst_oracle(c1, c2, method: str) -> tuple:
    """Per-variant numerator, denominator and validity of Hudson's or Weir
    and Cockerham's estimator from two cohorts' (V, 4) counts, numpy f64
    (plink2's --fst formulas, written apart from the port's copy)."""
    import numpy as np

    n1, n2 = (c[:, :3].sum(1).astype(np.float64) for c in (c1, c2))
    with np.errstate(invalid="ignore", divide="ignore"):
        p1, p2 = ((c[:, 1] + 2.0 * c[:, 2]) / (2.0 * m) for c, m in ((c1, n1), (c2, n2)))
        if method == "hudson":
            num = (p1 - p2) ** 2 - p1 * (1 - p1) / (2 * n1 - 1) - p2 * (1 - p2) / (2 * n2 - 1)
            den = p1 * (1 - p2) + p2 * (1 - p1)
            ok = (n1 >= 1) & (n2 >= 1)
        else:
            tot = n1 + n2
            nbar = tot / 2
            nc = tot - (n1 * n1 + n2 * n2) / tot
            pbar = (n1 * p1 + n2 * p2) / tot
            s2 = (n1 * (p1 - pbar) ** 2 + n2 * (p2 - pbar) ** 2) / nbar
            hbar = (c1[:, 1] + c2[:, 1]) / tot
            inner = pbar * (1 - pbar) - s2 / 2
            a = nbar / nc * (s2 - (inner - hbar / 4) / (nbar - 1))
            b = nbar / (nbar - 1) * (inner - (2 * nbar - 1) / (4 * nbar) * hbar)
            num, den = a, a + b + hbar / 2
            ok = (n1 >= 1) & (n2 >= 1) & (nbar > 1) & (nc > 0)
    ok &= np.isfinite(num) & np.isfinite(den) & (den != 0)
    return num, den, ok


def _close_text(label: str, got: str, want: float) -> None:
    """A .6g cell against an f64 value: within its six digits ("NA" where
    the value is undefined)."""
    import math

    if got == "NA" or not math.isfinite(want):
        if got != "NA" or math.isfinite(want):
            raise AssertionError(f"{label}: {got} against the oracle's {want}")
    elif abs(float(got) - want) > 1e-5 * abs(want) + 1e-12:
        raise AssertionError(f"{label}: {got} against the oracle's {want:.9g}")


def _same_het(label: str, got: Path, want: Path) -> float:
    """Two het tables: every column bytewise but E(HOM) and F, those at rtol
    1e-12 (f64 sums in another order); both files deleted. Returns the
    largest relative difference."""
    worst = 0.0
    g, w = got.read_text().splitlines(), want.read_text().splitlines()
    if g[0] != w[0] or len(g) != len(w):
        raise AssertionError(f"{label}: {got.name} and {want.name} differ in shape")
    for a, b in zip((ln.split("\t") for ln in g[1:]), (ln.split("\t") for ln in w[1:])):
        if [a[0], a[1], a[3]] != [b[0], b[1], b[3]] or [a[2] == "NA", a[4] == "NA"] != [
                b[2] == "NA", b[4] == "NA"]:
            raise AssertionError(f"{label}: {a} != --device cpu's {b}")
        for x, y in ((a[2], b[2]), (a[4], b[4])):
            if x != "NA":
                rel = abs(float(x) - float(y)) / max(abs(float(y)), 1e-300)
                if rel > 1e-12:
                    raise AssertionError(f"{label}: {a} != --device cpu's {b} (rtol 1e-12)")
                worst = max(worst, rel)
    got.unlink()
    want.unlink()
    return worst


def phase_counts(tmp: Path, full: Path) -> list:
    """query, the reports, stats and fst through the port's CLI on the full
    chr22 fixture (launch counts read around each part's cuda runs):
    (a) a metadata-only query launches no kernel, its rows those numpy
    reads from the .pvar; (b) a query binding GT_AF and GT_MISSING at
    median thresholds (K8) and one under -s binding GT_NOBS and
    GT_MISSING_RATE (K9), against a numpy oracle (2,000 seeded variants'
    counts; every sample's missing count); (c) freq, gcount, hardy,
    missing, het and stats --per-sample over every variant, for all samples
    (K8, K9, K1) and a --samples-file of 1,001 seeded IIDs (K14): the
    .gcount, .afreq, .hardy counts and .vmiss rows of the 2,000 variants
    equal to numpy's masked counts, .smiss, stats' MISSING/NOBS and .het's
    OBS_CT to every sample's missing count; (d) fst hudson and wc over a
    seeded --pheno POP column of five labels with 2% NA (K14 at P = 5), and
    the same over the 2,000 variants (-R) with --report-variants, every cell
    and summary within its six digits of a numpy f64 oracle. Then every
    output of (b)-(d) on a 20,000-variant region, sha256-equal to --device
    cpu's (het's E(HOM) and F at rtol 1e-12; the -s query takes no region).
    Returns the launches of each part."""
    import numpy as np

    iids, pos, alt, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    rng = np.random.default_rng(SEED + 10)
    first = n_var // 2 - COUNT_REGION // 2
    region = ["-r", f"22:{pos[first]}-{pos[first + COUNT_REGION - 1]}"]
    cohort = np.sort(rng.choice(n, KEEP_SAMPLES, replace=False))
    (tmp / "samples_1001.txt").write_text("".join(f"{iids[s]}\n" for s in cohort))
    labels = rng.integers(0, COHORTS, n)
    na = rng.random(n) < 0.02
    (tmp / "pops.tsv").write_text("#IID\tPOP\n" + "".join(
        f"{iid}\t{'NA' if na[s] else POPS[labels[s]]}\n" for s, iid in enumerate(iids)))
    rows = np.sort(rng.choice(n_var, COUNT_ORACLE_VARIANTS, replace=False))
    (tmp / "oracle_rows.txt").write_text("".join(f"22\t{pos[r]}\n" for r in rows))
    walls, launches, region_runs = {}, [], []

    def timed(label, seconds):
        walls[label] = seconds
        print(f"[10 counts] {label}: {seconds:.3f} s")

    def on_region(label, argv, stem, suffix="", stdout=False):
        """The cuda run on the region now (its launches counted with its
        part's), the --device cpu run and the comparison at the end: the
        output (stdout, or -o) is {device}.{stem}{suffix}."""
        (_port_stdout if stdout else _port_cli)([*argv, *region], tmp / f"cuda.{stem}{suffix}",
                                                "cuda")
        region_runs.append((label, argv, stem, suffix, stdout))

    t0 = time.perf_counter()
    oracle = {"all": _masked_counts_numpy(packed, rows, np.arange(n)),
              "cohort": _masked_counts_numpy(packed, rows, cohort)}
    missing = _sample_missing_numpy(packed)[:n]
    print(f"[10 counts] numpy oracle ({len(rows)} variants' counts over all samples and the "
          f"cohort; every sample's missing count) in {time.perf_counter() - t0:.1f} s")

    # (a) metadata only: no kernel, the .pvar's rows
    _reset_launches()
    seconds, _ = _port_stdout(["query", full, "-f", "ID", "-i", 'ALT == "G"'], tmp / "a.txt",
                              "cuda")
    got = _read_launches()
    if any(got.values()):
        raise AssertionError(f"(a) a metadata-only query launched {got}")
    want = "".join(f"snp{i}\n" for i in np.flatnonzero(alt == b"G"))
    if (tmp / "a.txt").read_text() != want:
        raise AssertionError("(a) the query's rows differ from the .pvar's ALT == G rows")
    (tmp / "a.txt").unlink()
    timed(f"(a) query -f ID -i 'ALT == \"G\"', {want.count(chr(10))} rows, no kernel", seconds)

    # (b) GT_* on the variant axis (K8) and on the sample axis (K9)
    c = oracle["all"]
    ac = c[:, 1] + 2 * c[:, 2]
    af = ac / (2 * c[:, :3].sum(1))
    af_med, miss_med = float(np.median(af)), int(np.median(c[:, 3]))
    rate = missing / n_var
    rate_med = float(np.median(rate))
    variant_query = ["query", full, "-f", 'ID + " " + str::from(GT_AC)',
                     "-i", f"GT_AF > {af_med!r} && GT_MISSING < {miss_med}"]
    _reset_launches()
    seconds, _ = _port_stdout(variant_query, tmp / "b.txt", "cuda")
    timed("(b) query GT_AF/GT_MISSING, every variant", seconds)
    seconds, _ = _port_stdout(["query", full, "-s", "-f", 'IID + " " + str::from(GT_NOBS)',
                               "-i", f"GT_MISSING_RATE < {rate_med!r}"], tmp / "b_s.txt", "cuda")
    timed("(b) query -s GT_NOBS/GT_MISSING_RATE, every sample", seconds)
    on_region("(b) query", variant_query, "b_r", ".txt", stdout=True)
    launches.append(_read_launches())
    for kname in ("gt_counts_device", "sample_counts_device"):
        if launches[-1][kname] <= 0:
            raise AssertionError(f"(b) {kname} never launched")
    kept = dict(line.split(" ") for line in (tmp / "b.txt").read_text().splitlines())
    for r, a, m, want_ac in zip(rows, af, c[:, 3], ac):
        hit = kept.get(f"snp{r}")
        if (hit is not None) != bool(a > af_med and m < miss_med) or (hit and int(hit) != want_ac):
            raise AssertionError(f"(b) variant {r}: query row {hit} against the oracle's AF {a}, "
                                 f"MISSING {m}, AC {want_ac}")
    want = "".join(f"{iids[s]} {n_var - missing[s]}\n" for s in range(n) if rate[s] < rate_med)
    if (tmp / "b_s.txt").read_text() != want:
        raise AssertionError("(b) the -s query's rows differ from the oracle's")
    (tmp / "b.txt").unlink()
    (tmp / "b_s.txt").unlink()
    print(f"[10 counts] (b) {len(kept)} variants at GT_AF > {af_med:.6g} && GT_MISSING < "
          f"{miss_med}, the {len(rows)} oracle variants among them as numpy has them, GT_AC "
          f"equal; {want.count(chr(10))} samples at GT_MISSING_RATE < {rate_med:.6g}, GT_NOBS "
          "equal to the oracle's")

    # (c) the reports over every variant: all samples, then the cohort
    for who, samples, flags in (("all", np.arange(n), []),
                                ("cohort", cohort, ["--samples-file", tmp / "samples_1001.txt"])):
        _reset_launches()
        for report, ext in REPORTS.items():
            seconds, _ = _port_cli([report, full, *flags], tmp / f"{report}_{who}{ext}", "cuda")
            timed(f"(c) {report}, every variant, {len(samples)} samples", seconds)
            on_region(f"(c) {report} {who}", [report, full, *flags], f"{report}_{who}_r", ext)
        stats = ["stats", full, "--per-sample", *flags]
        seconds, _ = _port_stdout(stats, tmp / f"stats_{who}.txt", "cuda")
        timed(f"(c) stats --per-sample, every variant, {len(samples)} samples", seconds)
        on_region(f"(c) stats {who}", stats, f"stats_{who}_r", ".txt", stdout=True)
        launches.append(_read_launches())
        count = "gt_counts_device" if who == "all" else "gt_counts_masked"
        for kname in (count, "sample_counts_device", "unpack_codes"):
            if launches[-1][kname] <= 0:
                raise AssertionError(f"(c) {kname} never launched over {who} samples")
        # per-variant rows of the oracle's variants, per-sample rows of every kept sample
        tables = {ext: _lines(tmp / f"{report}_{who}.{ext}") for report, ext in (
            ("gcount", "gcount"), ("freq", "afreq"), ("hardy", "hardy"), ("missing", "vmiss"),
            ("missing", "smiss"), ("het", "het"))}
        for k, r in enumerate(rows):
            hr, het, ha, mi = (int(x) for x in oracle[who][k])
            an = 2 * (hr + het + ha)
            freq = "NA" if an == 0 else f"{(het + 2 * ha) / an:.6g}"
            gcount = tables["gcount"][r]
            for got, want in (([gcount[1], *gcount[4:]], [f"snp{r}", *map(str, (hr, het, ha, mi))]),
                              (tables["afreq"][r][4:], [freq, str(an)]),
                              (tables["hardy"][r][4:7], [str(ha), str(het), str(hr)]),
                              (tables["vmiss"][r][2:4], [str(mi), str(len(samples))])):
                if got != want:
                    raise AssertionError(f"(c) variant {r}, {who} samples: {got} != oracle {want}")
        per_sample = (tmp / f"stats_{who}.txt").read_text().split("#IID")[1].splitlines()[1:]
        for k, s in enumerate(samples):
            called = str(n_var - missing[s])
            st = per_sample[k].split("\t")
            if (tables["smiss"][k][:3] != [iids[s], str(missing[s]), str(n_var)]
                    or [tables["het"][k][0], tables["het"][k][3]] != [iids[s], called]
                    or [st[0], st[4], st[5]] != [iids[s], str(missing[s]), called]):
                raise AssertionError(f"(c) sample {iids[s]}: .smiss {tables['smiss'][k]}, .het "
                                     f"{tables['het'][k]}, stats {st}: {missing[s]} missing")
        if [len(tables["gcount"]), len(tables["smiss"]), len(tables["het"]), len(per_sample)] != [
                n_var, len(samples), len(samples), len(samples)]:
            raise AssertionError(f"(c) {who}: tables of {len(tables['gcount'])} variants and "
                                 f"{len(tables['smiss'])} samples")
        for f in tmp.glob(f"*_{who}.*"):
            f.unlink()
        print(f"[10 counts] (c) {who} samples ({len(samples)}): .gcount, .afreq, .hardy counts "
              f"and .vmiss rows of {len(rows)} seeded variants equal to numpy's masked counts; "
              ".smiss, stats --per-sample MISSING/NOBS and .het OBS_CT equal to every sample's "
              "missing count")

    # (d) fst over five cohorts (K14 at P = 5): every variant, then the oracle's
    pops = {p: np.flatnonzero((labels == i) & ~na) for i, p in enumerate(POPS)}
    per_pop = {p: _masked_counts_numpy(packed, rows, ids) for p, ids in pops.items()}
    _reset_launches()
    for method in ("hudson", "wc"):
        fst = ["fst", full, "--pheno", tmp / "pops.tsv", "--pheno-name", "POP", "--method", method]
        seconds, _ = _port_cli(fst, tmp / f"fst_{method}", "cuda")
        timed(f"(d) fst --method {method}, every variant, {COHORTS} cohorts", seconds)
        _port_cli([*fst, "-R", tmp / "oracle_rows.txt", "--report-variants"],
                  tmp / f"fst_o_{method}", "cuda")
        on_region(f"(d) fst {method}", [*fst, "--report-variants"], f"fst_{method}_r")
    launches.append(_read_launches())
    if launches[-1]["gt_counts_masked"] <= 0:
        raise AssertionError("(d) gt_counts_masked never launched")
    for method in ("hudson", "wc"):
        summary = _lines(tmp / f"fst_{method}.fst.summary")
        if len(summary) != COHORTS * (COHORTS - 1) // 2 or any(
                not np.isfinite(float(r[2])) or int(r[3]) < n_var // 2 for r in summary):
            raise AssertionError(f"(d) fst {method} over every variant: {summary}")
        for p1, p2, cell, used in _lines(tmp / f"fst_o_{method}.fst.summary"):
            num, den, ok = _fst_oracle(per_pop[p1], per_pop[p2], method)
            if int(used) != int(ok.sum()):
                raise AssertionError(f"(d) {method} {p1}/{p2}: VARIANT_CT {used} != {ok.sum()}")
            _close_text(f"(d) {method} {p1}/{p2}", cell, num[ok].sum() / den[ok].sum())
            cells = _lines(tmp / f"fst_o_{method}.{p1}.{p2}.fst.var")
            for k, row in enumerate(cells):
                obs = per_pop[p1][k, :3].sum() + per_pop[p2][k, :3].sum()
                if row[2] != f"snp{rows[k]}" or int(row[3]) != obs or len(cells) != len(rows):
                    raise AssertionError(f"(d) {method} {p1}/{p2}: {row} against the oracle")
                _close_text(f"(d) {method} {p1}/{p2} {row[2]}", row[4],
                            num[k] / den[k] if ok[k] else float("nan"))
        print(f"[10 counts] (d) fst {method}: {len(summary)} cohort pairs over every variant, "
              f"finite; over the {len(rows)} oracle variants each pair's summary and "
              "per-variant cells within their six digits of the numpy f64 oracle, VARIANT_CT "
              "and OBS_CT equal")
    for f in tmp.glob("fst_*"):
        f.unlink()

    # every region run against --device cpu
    het_rel = 0.0
    for label, argv, stem, suffix, stdout in region_runs:
        (_port_stdout if stdout else _port_cli)([*argv, *region], tmp / f"cpu.{stem}{suffix}",
                                                "cpu")
        outputs = sorted(tmp.glob(f"cuda.{stem}*"))
        if not outputs:
            raise AssertionError(f"{label}: no output on the region")
        for got in outputs:
            want = tmp / f"cpu.{got.name[len('cuda.'):]}"
            if got.suffix == ".het":
                het_rel = max(het_rel, _same_het(label, got, want))
            else:
                _same_files(label, [(got, want)])
    print(f"[10 counts] region {region[1]} ({COUNT_REGION} variants): {len(region_runs)} runs of "
          f"(b)-(d) on cuda equal to --device cpu's, sha256 (het's E(HOM) and F within "
          f"{het_rel:.3g}, rtol 1e-12)")
    shown = "; ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"[10 counts] walls: {shown}")
    print(f"[10 counts] path launches: "
          f"{ {k: sum(part[k] for part in launches) for k in launches[0]} }")
    return launches


LD_REGION = 20_000  # variants of phase 11's region runs and of its f64 oracle
LD_WINDOWS = 2000  # seeded windows of (c)'s every-variant check
# phase 11's planted LD: groups of 2-5 rows whose followers copy the first
# row with this share of its bytes redrawn (the same bytes for the whole
# group), so two members' r² is about (1 - share)²: 0.90, 0.35 or 0.06,
# the middle level halfway between the thresholds the phase uses, each at
# least 5 standard deviations (the sampling noise, about 0.03 over a cohort
# of 1,001) from them
LD_SHARES = (0.05, 0.41, 0.75)
LD_THRESHOLDS = (0.2, 0.5)
LD_CLEARANCE = 1e-3  # the least distance of an oracle r² from a threshold
LD_INDEX = 40  # phase 11 (d)'s planted index variants
MEMORY_LIMIT = 4 << 30  # device bytes a full-chr22 LD run may hold


def _ld_fileset(tmp: Path, full: Path, cohort) -> Path:
    """A copy of the full chr22 fixture with LD planted (its uniform random
    records give r² about 1/2504): seeded groups of 2-5 consecutive rows, in
    each the followers a copy of the first row with the codes of a seeded
    share (LD_SHARES) of its samples redrawn, the same samples for the whole
    group (one of 64 seeded sets a share): exactly that share of ``cohort``
    and of the other samples, so the level holds over either set."""
    import shutil

    import numpy as np

    iids, _, _, packed = _read_fileset(full)
    n_var, rec = packed.shape
    rng = np.random.default_rng(SEED + 11)
    starts = np.concatenate([[0], np.cumsum(rng.integers(2, 6, n_var // 2 + 1))])
    starts = starts[starts < n_var]
    level = rng.integers(0, len(LD_SHARES), len(starts))
    pattern = rng.integers(0, 64, len(starts))
    # the record-byte bits of each redrawn sample set: (shares, 64, R)
    redraw = np.zeros((len(LD_SHARES), 64, 4 * rec), dtype=bool)
    for ids in (np.asarray(cohort), np.setdiff1d(np.arange(len(iids)), cohort)):
        for lv, share in enumerate(LD_SHARES):
            for m in range(64):
                redraw[lv, m, rng.permutation(ids)[: round(share * len(ids))]] = True
    pool = (redraw.reshape(len(LD_SHARES), 64, rec, 4)
            * np.array([3, 12, 48, 192], np.uint8)).sum(3, dtype=np.uint8)
    group = np.repeat(np.arange(len(starts)), np.diff(np.append(starts, n_var)))
    body = np.empty((n_var, rec), dtype=np.uint8)
    for lo in range(0, n_var, 1 << 16):
        hi = min(lo + (1 << 16), n_var)
        g = group[lo:hi]
        leader = starts[g]
        bits = pool[level[g], pattern[g]] * (np.arange(lo, hi) != leader)[:, None].astype(np.uint8)
        fresh = rng.integers(0, 256, (hi - lo, rec), dtype=np.uint8)
        body[lo:hi] = (fresh & bits) | (np.asarray(packed[leader]) & ~bits)
    prefix = tmp / "ld_chr22"
    with open(f"{prefix}.pgen", "wb") as f:
        f.write(Path(f"{full}.pgen").read_bytes()[:12])
        body.tofile(f)
    for ext in ("pvar", "psam"):
        shutil.copyfile(f"{full}.{ext}", f"{prefix}.{ext}")
    return prefix


def _ld_pairs(path: Path, rows=None) -> dict:
    """(i, j) -> R2 text of an .ld table's rows (IDs snp{i}), those whose
    first variant lies in ``rows`` (a range) when given."""
    pairs = {}
    with open(path) as fh:
        fh.readline()
        for line in fh:
            f = line.split("\t")
            i = int(f[2][3:])
            if rows is None or i in rows:
                pairs[i, int(f[5][3:])] = f[6]
    return pairs


def _clear(label: str, band, thresholds=LD_THRESHOLDS) -> float:
    """Every r² of an oracle band at least LD_CLEARANCE from each threshold;
    returns the least distance."""
    import numpy as np

    least = min(float(np.abs(band - t).min()) for t in thresholds)
    if least < LD_CLEARANCE:
        raise AssertionError(f"{label}: an oracle r² lies {least:.3g} from a threshold "
                             f"{thresholds}, within {LD_CLEARANCE}")
    return least


def _maf_numpy(counts):
    """prune's MAF from (V, 4) code counts."""
    import numpy as np

    ac = counts[:, 1] + 2 * counts[:, 2]
    an = 2 * (counts[:, 0] + counts[:, 1] + counts[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(an > 0, ac / np.maximum(an, 1), 0.0)
    return np.minimum(af, 1.0 - af)


def _prune_ids(prefix: Path) -> tuple:
    return tuple(Path(f"{prefix}.prune.{k}").read_text().split() for k in ("in", "out"))


def phase_ld(tmp: Path, full: Path) -> list:
    """ld, prune --indep-pairwise and clump through the port's CLI on a copy
    of the full chr22 fixture with LD planted (``_ld_fileset``), launch
    counts read around each part's cuda runs and the device's peak memory
    printed for each full-chr22 run (under MEMORY_LIMIT): (a) ld over every
    variant at the defaults (window 10, 1000 kb, r² 0.2), the pairs of a
    seeded 20,000-variant region exactly those of the port's
    banded_r2_numpy (f64) and their R2 within rtol 1e-4 atol 1e-6 (and six
    digits), then ld at the defaults on the region sha256-equal to --device
    cpu; (b) ld --ld-window 50 --ld-window-r2 0 on the region with a
    --samples-file of 1,001 IIDs (K5, then K15) sha256-equal to --device
    cpu; (c) prune 50 5 0.2 over every variant:
    on 2,000 seeded windows of its walk no two kept variants over r² 0.2 by
    the f64 oracle; on the region prune 50 5 0.2, and 100kb 1 0.5 with the
    cohort, each list equal to greedy_prune on the oracle's band and
    sha256-equal to --device cpu; (d) clump of the region with a seeded P
    table, sha256-equal to --device cpu. Every oracle r² of the region (and
    of the windows) lies at least LD_CLEARANCE from 0.2 and 0.5. Returns the
    launches of each part."""
    import numpy as np
    import torch

    from pgen_tpu_torch.ops.ld import banded_r2_numpy, centered_dosage_np, greedy_prune
    from pgen_tpu_torch.pipeline.prune import window_extents

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    iids = _read_fileset(full)[0]
    n = len(iids)
    cohort = np.sort(rng.choice(n, KEEP_SAMPLES, replace=False))
    (tmp / "ld_cohort.txt").write_text("".join(f"{iids[s]}\n" for s in cohort))
    prefix = _ld_fileset(tmp, full, cohort)
    _, pos, _, packed = _read_fileset(prefix)
    n_var = len(pos)
    print(f"[11 ld] fileset with planted LD written in {time.perf_counter() - t0:.1f} s")
    first = int(rng.integers(0, n_var - LD_REGION - 64))
    region_rows = range(first, first + LD_REGION)
    region = ["-r", f"22:{pos[first]}-{pos[first + LD_REGION - 1]}"]
    chrom = np.full(LD_REGION, b"22")
    kb_extents = window_extents(chrom, pos[region_rows.start : region_rows.stop], 100, True)
    kb_band = int(kb_extents.max()) - 1

    t0 = time.perf_counter()
    # the region and 49 rows past it: (a)'s pairs leave the region by up to 9
    oracle = banded_r2_numpy(packed[first : first + LD_REGION + 49], n, 49)[:LD_REGION]
    inside = np.arange(LD_REGION)[:, None] + 1 + np.arange(49)[None, :] < LD_REGION
    oracle_kb = banded_r2_numpy(packed[region_rows.start : region_rows.stop], n, kb_band,
                                sample_idx=cohort)
    # the cohort's runs use 0.5 alone (its r² vary more: a third of the samples)
    least = min(_clear("region", oracle), _clear("region, cohort, 100 kb", oracle_kb, (0.5,)))
    counts = _masked_counts_numpy(packed, np.arange(first, first + LD_REGION), np.arange(n))
    counts_cohort = _masked_counts_numpy(packed, np.arange(first, first + LD_REGION), cohort)
    print(f"[11 ld] f64 oracle of the region ({LD_REGION} variants: band 49, and band "
          f"{kb_band} over the cohort of {KEEP_SAMPLES}) in {time.perf_counter() - t0:.1f} s; "
          f"every r² at least {least:.4f} from {LD_THRESHOLDS}; planted pairs over 0.2: "
          f"{int((oracle[:, :9] >= 0.2).sum())} in (a)'s band")
    walls, launches, memory = {}, [], {}

    def timed(label, seconds):
        walls[label] = seconds
        print(f"[11 ld] {label}: {seconds:.3f} s")

    def full_run(label, argv, out):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, _ = _port_cli(argv, out, "cuda")
        memory[label] = torch.cuda.max_memory_allocated()
        print(f"[11 ld] {label}: peak device memory {memory[label] / 1e6:.1f} MB")
        if memory[label] > MEMORY_LIMIT:
            raise AssertionError(f"{label} held {memory[label]} B of device memory")
        timed(label, seconds)

    # (a) ld over every variant at the defaults
    _reset_launches()
    full_run("(a) ld, every variant", ["ld", prefix], tmp / "a.ld")
    seconds, _ = _port_cli(["ld", prefix, *region], tmp / "cuda.a.ld", "cuda")
    timed("(a) ld, region", seconds)
    launches.append(_read_launches())
    _port_cli(["ld", prefix, *region], tmp / "cpu.a.ld", "cpu")
    region_pairs = sum(1 for _ in open(tmp / "cuda.a.ld")) - 1
    _same_files("(a) ld on the region", [(tmp / "cuda.a.ld", tmp / "cpu.a.ld")])
    if launches[-1]["ld_r2_band"] <= 0:
        raise AssertionError("(a) ld_r2_band never launched")
    n_rows = sum(1 for _ in open(tmp / "a.ld")) - 1
    got = _ld_pairs(tmp / "a.ld", region_rows)
    ii, dd = np.nonzero(oracle[:, :9] >= 0.2)
    want = {(first + i, first + i + 1 + d): oracle[i, d] for i, d in zip(ii, dd)}
    if set(got) != set(want):
        raise AssertionError(f"(a) {len(got)} region pairs against the oracle's {len(want)}; "
                             f"{sorted(set(got) ^ set(want))[:5]} differ")
    worst = _assert_close("(a) R2 of the region", np.array([float(got[k]) for k in want]),
                          np.array(list(want.values())), 1e-4, 1e-6)
    (tmp / "a.ld").unlink()
    print(f"[11 ld] (a) {n_rows} pairs over every variant; the region's {len(got)} pairs those "
          f"of the f64 oracle, R2 at {worst:.3g} of rtol 1e-4 atol 1e-6; the region run's "
          f"{region_pairs} pairs equal to --device cpu's (sha256)")

    # (b) a wide window over the cohort, all pairs, on the region
    b_argv = ["ld", prefix, "--ld-window", "50", "--ld-window-r2", "0", "--samples-file",
              tmp / "ld_cohort.txt", *region]
    _reset_launches()
    seconds, _ = _port_cli(b_argv, tmp / "cuda.b.ld", "cuda")
    launches.append(_read_launches())
    timed("(b) ld --ld-window 50 --ld-window-r2 0, cohort, region", seconds)
    seconds, _ = _port_cli(b_argv, tmp / "cpu.b.ld", "cpu")
    timed("(b) the same, --device cpu", seconds)
    got = _ld_pairs(tmp / "cuda.b.ld")
    if len(got) != LD_REGION * 49 - 49 * 50 // 2:
        raise AssertionError(f"(b) {len(got)} pairs on cuda")
    _same_files("(b) ld --ld-window 50, cohort", [(tmp / "cuda.b.ld", tmp / "cpu.b.ld")])
    print(f"[11 ld] (b) {len(got)} pairs, equal to --device cpu's (sha256)")

    # (c) prune over every variant, then on the region against the oracle
    _reset_launches()
    full_run("(c) prune 50 5 0.2, every variant", ["prune", prefix, "--indep-pairwise", "50",
                                                   "5", "0.2"], tmp / "c")
    kept, removed = _prune_ids(tmp / "c")
    alive = np.zeros(n_var, dtype=bool)
    alive[[int(x[3:]) for x in kept]] = True
    if len(kept) + len(removed) != n_var or not removed:
        raise AssertionError(f"(c) {len(kept)} kept and {len(removed)} removed of {n_var}")
    starts = 5 * rng.choice((n_var - 50) // 5, LD_WINDOWS, replace=False)
    window_least, window_pairs = 1.0, 0
    for s in starts:
        c, norm = centered_dosage_np(_codes_numpy(packed, np.arange(s, s + 50))[:, :n])
        den = norm[:, None] * norm[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.triu(np.where(den > 0, (c @ c.T / np.maximum(den, 1e-300)) ** 2, 0.0), 1)
        window_least = min(window_least, _clear(f"(c) window at {s}", r2, (0.2,)))
        both = alive[s : s + 50, None] & alive[None, s : s + 50]
        window_pairs += int((r2 > 0.2).sum())
        if (r2[both] > 0.2).any():
            raise AssertionError(f"(c) two kept variants of the window at {s} over r² 0.2")
    for side in ("in", "out"):
        Path(f"{tmp / 'c'}.prune.{side}").unlink()
    print(f"[11 ld] (c) kept {len(kept)} of {n_var}; in {LD_WINDOWS} seeded windows of the walk "
          f"({window_pairs} pairs over 0.2, every r² at least {window_least:.4f} from it) no two "
          "kept variants over 0.2 by the f64 oracle")
    ids = np.array([f"snp{i}" for i in region_rows])
    for label, spec, flags, band, maf, extents, step, thr in (
            ("50 5 0.2", ["50", "5", "0.2"], [], np.where(inside, oracle, 0.0),
             _maf_numpy(counts), window_extents(chrom, None, 50, False), 5, 0.2),
            ("100kb 1 0.5, cohort", ["100kb", "1", "0.5"],
             ["--samples-file", tmp / "ld_cohort.txt"], oracle_kb, _maf_numpy(counts_cohort),
             kb_extents, 1, 0.5)):
        argv = ["prune", prefix, "--indep-pairwise", *spec, *flags, *region]
        seconds, _ = _port_cli(argv, tmp / "cuda.c", "cuda")
        timed(f"(c) prune {label}, region", seconds)
        _port_cli(argv, tmp / "cpu.c", "cpu")
        expect = greedy_prune(band[:, : int(extents.max()) - 1], maf, extents, step, thr)
        if _prune_ids(tmp / "cuda.c") != (list(ids[expect]), list(ids[~expect])):
            raise AssertionError(f"(c) prune {label} on the region differs from greedy_prune "
                                 "on the oracle's band")
        _same_files(f"(c) prune {label}", [(Path(f"{tmp / 'cuda.c'}.prune.{k}"),
                                            Path(f"{tmp / 'cpu.c'}.prune.{k}")) for k in
                                           ("in", "out")])
        print(f"[11 ld] (c) prune {label} on the region: {int(expect.sum())} kept, equal to "
              "greedy_prune on the f64 oracle's band and to --device cpu's (sha256)")
    launches.append(_read_launches())
    for kname in ("ld_r2_band", "gt_counts_device", "gt_counts_masked"):
        if launches[-1][kname] <= 0:
            raise AssertionError(f"(c) {kname} never launched")

    # (d) clump of the region's variants
    p = rng.uniform(1e-3, 1.0, LD_REGION)  # no index variant but the planted ones
    p[rng.choice(LD_REGION, LD_INDEX, replace=False)] = 10.0 ** -rng.uniform(5, 10, LD_INDEX)
    (tmp / "assoc.tsv").write_text("#ID\tP\n" + "".join(
        f"snp{i}\t{q:.4g}\n" for i, q in zip(region_rows, p)))
    _reset_launches()
    seconds, err = _port_cli(["clump", prefix, "--clump", tmp / "assoc.tsv"], tmp / "cuda.clumps",
                             "cuda")
    launches.append(_read_launches())
    timed("(d) clump, region", seconds)
    _port_cli(["clump", prefix, "--clump", tmp / "assoc.tsv"], tmp / "cpu.clumps", "cpu")
    n_clumps = (tmp / "cuda.clumps").read_text().count("\n") - 1
    if not 0 < n_clumps <= LD_INDEX:
        raise AssertionError(f"(d) {n_clumps} clumps from {LD_INDEX} index variants")
    _same_files("(d) clump", [(tmp / "cuda.clumps", tmp / "cpu.clumps")])
    print(f"[11 ld] (d) {n_clumps} clumps, equal to --device cpu's (sha256)")
    shown = "; ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"[11 ld] walls: {shown}")
    print(f"[11 ld] peak device memory: "
          + "; ".join(f"{k} {v / 1e6:.1f} MB" for k, v in memory.items()))
    print(f"[11 ld] path launches: "
          f"{ {k: sum(part[k] for part in launches) for k in launches[0]} }")
    for f in tmp.glob("ld_chr22.*"):
        f.unlink()
    return launches


MESH_WORLDS = (2, 4)  # phase 12 under --ranks, as far as the visible cards go
# NVLink 4 between the cards of an H100 SXM host: 450 GB/s a direction
# (NVIDIA's data sheet), in bytes per ms: the bound of each collective
NVLINK_BYTES_PER_MS = 450e9 / 1e3
MESH_CARD_KERNELS = {"glm": ("glm_planes",), "score": ("score_dosage",),
                     "king": ("relatedness_bits", "relatedness_gram"),
                     "genome": ("relatedness_bits", "relatedness_gram", "gt_counts_device"),
                     "pca": ("grm_z",)}

# One rank of a phase 12 run: the port's CLI, then each kernel's launch
# count written to the file named first.
_RANK_MAIN = """
import importlib, json, sys
from pgen_tpu_torch.cli import main
rc = main(sys.argv[3:])
mods = [importlib.import_module(f"pgen_tpu_torch.ops.{m}")
        for m in ("unpack", "gt_text", "pack", "gt_stats", "glm", "score", "relatedness",
                  "pca", "ld")]
names = sys.argv[2].split(",")
json.dump({k: next(getattr(m, k).launches for m in mods if hasattr(m, k)) for k in names},
          open(sys.argv[1], "w"))
sys.exit(rc)
"""

# Phase 12 (h): one rank of the collectives timed alone, each case as the
# mesh steps make it, median of 5 CUDA-event pairs after two warm-ups; rank
# 0 prints {case: ms} as JSON.
_COLLECTIVE_MAIN = """
import json, os, statistics, sys
import torch
import torch.distributed as dist
dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
torch.cuda.set_device(dev)
dist.init_process_group("nccl", device_id=dev)
gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
world = dist.get_world_size()
out = {}
for name, (op, specs) in json.loads(sys.argv[1]).items():
    ts = [torch.ones(shape, dtype=getattr(torch, dtype), device=dev) for shape, dtype in specs]
    wholes = [torch.empty((world * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=dev)
              if op == "all_gather" else None for t in ts]

    def run():
        for t, whole in zip(ts, wholes):
            if op == "all_reduce":
                dist.all_reduce(t)
            elif op == "broadcast":
                dist.broadcast(t, src=0)
            else:
                gather(whole, t)

    run()
    run()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    out[name] = statistics.median(times)
if dist.get_rank() == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""

_RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "PGEN_TPU_COORDINATOR", "PGEN_TPU_NUM_PROCS", "PGEN_TPU_PROC_ID")


def _run_processes(cmds: list, envs: list, tmp: Path, tag: str, timeout: float = 600) -> tuple:
    """``cmds[i]`` with the environment ``envs[i]``, all started at once from
    the checkout's root, each one's stdout and stderr to a file; one that
    fails stops the others at once, as does the timeout. Returns the wall
    seconds and each one's (stdout, stderr); raises if one exited non-zero."""
    t0 = time.perf_counter()
    procs, files = [], []
    try:
        for i, (cmd, env) in enumerate(zip(cmds, envs)):
            files.append((open(tmp / f"{tag}.proc{i}.out", "w+"),
                          open(tmp / f"{tag}.proc{i}.err", "w+")))
            procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=files[-1][0],
                                          stderr=files[-1][1], text=True, env=env))
        deadline = time.perf_counter() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() > deadline:
                break
            time.sleep(0.02)
        seconds = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f_out, f_err in files:
        outs.append(tuple(f.seek(0) or f.read() for f in (f_out, f_err)))
        for f in (f_out, f_err):
            f.close()
            Path(f.name).unlink()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: process {i} of {len(procs)} exited {p.returncode}\n"
                                 f"{err[-3000:]}")
    return seconds, outs


def _spawn_ranks(cmds: list, world: int, tmp: Path, tag: str) -> tuple:
    """``cmds[r]`` as rank r of ``world`` processes of this host, each a
    torchrun-style rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT; at 4 ranks LOCAL_RANK reversed, rank r on card 3 - r), or
    for one a lone process with none of them (no group), through
    ``_run_processes``. Returns the wall seconds and each rank's (stdout,
    stderr)."""
    env = {k: v for k, v in os.environ.items() if k not in _RANK_VARS}
    if world > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    envs = [env if world == 1 else
            {**env, "RANK": str(r), "LOCAL_RANK": str(world - 1 - r if world == 4 else r)}
            for r in range(world)]
    return _run_processes(cmds[:world], envs, tmp, tag)


# what the port prints on stderr: its log and error lines, --stats stages and
# the closing summary (torch's own runtime lines, such as c10d's, are not)
_PORT_LINE = re.compile(r"^(pgen-tpu|.* pgen_tpu\.|.*: [\d.]+ ms over |[a-z]+: )")


def _mesh_run(argv: list, out: Path, world: int, tmp: Path) -> tuple:
    """One run of the port's CLI with ``--device cuda --stats -o out`` on
    ``world`` ranks (``_spawn_ranks``). Fails if a rank other than 0
    prints anything of the port's. Returns the wall seconds, rank 0's stderr
    (its --stats report) and each rank's launch counts."""
    names = ",".join(KERNELS)
    cmds = [[sys.executable, "-c", _RANK_MAIN, str(tmp / f"launches{r}.json"), names,
             *map(str, argv), "-o", str(out), "--device", "cuda", "--stats"]
            for r in range(world)]
    seconds, outs = _spawn_ranks(cmds, world, tmp, out.name)
    for r, (o, e) in enumerate(outs[1:], 1):
        said = [ln for ln in e.splitlines() if _PORT_LINE.match(ln)]
        if o or said:
            raise AssertionError(f"{out.name}: rank {r} of {world} printed {o[:300]!r} {said[:5]}")
    launches = []
    for r in range(world):
        launches.append(json.loads((tmp / f"launches{r}.json").read_text()))
        (tmp / f"launches{r}.json").unlink()
    return seconds, outs[0][1], launches


def _collective_cases(world: int, n_var: int, n: int) -> dict:
    """The collectives of the mesh steps at chr22's shapes: case -> (op,
    [(shape, dtype), ...]); all_gather shapes are one rank's shard."""
    per = -(-n_var // world)
    grams = [[n, n], "float64"]
    return {
        "king all_reduce (4 Grams)": ("all_reduce", [grams] * 4),
        "genome all_reduce (5 Grams)": ("all_reduce", [grams] * 5),
        "genome all_gather (counts)": ("all_gather", [[[1], "int64"], [[per, 4], "int64"]]),
        "pca all_reduce (GRM, m_used)": ("all_reduce", [grams, [[1], "int64"]]),
        "approx broadcast (q)": ("broadcast", [[[n, PCA_K + 8], "float32"]]),
        "approx all_reduce (y, m_used)": ("all_reduce", [[[n, PCA_K + 8], "float32"],
                                                         [[1], "int64"]]),
        "score all_reduce": ("all_reduce", [[[n, 3], "float64"], [[n], "float64"],
                                            [[n], "int64"], [[1], "int64"]]),
        # GlmMoments of linear QT ~ C1 + C2: n, mp (10 columns), gq (3), sg, sg2
        "glm all_gather (moments)": ("all_gather", [[[1], "int64"], [[per], "float64"],
                                                   [[per, 10], "float64"],
                                                   [[per, 3], "float64"], [[per], "float64"],
                                                   [[per], "float64"]]),
    }


def _collective_bytes(op: str, specs: list, world: int) -> int:
    """The bytes a collective's result holds: each tensor for an all_reduce
    or broadcast, the gathered whole for an all_gather."""
    import math

    size = {"float64": 8, "int64": 8, "float32": 4}
    one = sum(math.prod(shape) * size[dtype] for shape, dtype in specs)
    return one * world if op == "all_gather" else one


def _mesh_collectives(world: int, n_var: int, n: int, tmp: Path) -> dict:
    """(12h) the mesh steps' collectives alone on ``world`` cards, each
    beside its bound (its bytes over NVLink's 450 GB/s a direction)."""
    cases = _collective_cases(world, n_var, n)
    cmds = [[sys.executable, "-c", _COLLECTIVE_MAIN, json.dumps(cases)]] * world
    seconds, outs = _spawn_ranks(cmds, world, tmp, f"collectives{world}")
    times = json.loads(outs[0][0].strip().splitlines()[-1])
    rows = {}
    for name, (op, specs) in cases.items():
        nbytes = _collective_bytes(op, specs, world)
        rows[name] = {"ms": times[name], "bytes": nbytes,
                      "bound_ms": nbytes / NVLINK_BYTES_PER_MS}
        print(f"[12 mesh] (h) {name} on {world} cards: {times[name]:.4f} ms for "
              f"{nbytes / 1e6:.2f} MB (NCCL alone, CUDA events, median of 5); bound "
              f"{nbytes / NVLINK_BYTES_PER_MS:.4f} ms at 450 GB/s "
              f"({100 * nbytes / NVLINK_BYTES_PER_MS / times[name]:.1f}%)")
    print(f"[12 mesh] (h) on {world} cards: {seconds:.1f} s with process start and NCCL set-up")
    return rows


def _same_scores(label: str, got: Path, want: Path) -> float:
    """Two .sscore tables: the same header, IIDs and ALLELE_CT; every other
    column within 1e-4 of its largest |value|. Returns the worst share."""
    import numpy as np

    hg, ig, ng = _sscore(got)
    hw, iw, nw = _sscore(want)
    if hg != hw or ig != iw or not np.array_equal(ng[:, 0], nw[:, 0]):
        raise AssertionError(f"{label}: header, IIDs or ALLELE_CT differ")
    worst = 0.0
    for c in range(1, nw.shape[1]):
        d = float(np.abs(ng[:, c] - nw[:, c]).max() / np.abs(nw[:, c]).max())
        if d > 1e-4:
            raise AssertionError(f"{label}: {hw[c + 1]} off by {d:.3g} of max|value|, over 1e-4")
        worst = max(worst, d)
    return worst


def _same_pca(label: str, got: Path, want: Path, err_got: str, err_want: str, n: int,
              rel: bool) -> str:
    """m_used equal, eigenvalues at rtol 1e-3 and, with ``rel``, the GRM x
    m_used within 1e-6 of its largest entry."""
    import numpy as np

    m_got, m_want = _m_used(err_got), _m_used(err_want)
    if m_got != m_want:
        raise AssertionError(f"{label}: m_used {m_got} != {m_want}")
    vals_got, _ = _pca_outputs(got, n)
    vals_want, _ = _pca_outputs(want, n)
    ratio = float(np.abs(vals_got / vals_want - 1).max())
    if ratio > 1e-3:
        raise AssertionError(f"{label}: eigenvalues off by {ratio:.3g} (rtol 1e-3)")
    report = f"m_used {m_got} equal, eigenvalues within {ratio:.3g} (rtol 1e-3)"
    if rel:
        g = np.fromfile(f"{got}.rel.bin", dtype="<f8") * m_got
        w = np.fromfile(f"{want}.rel.bin", dtype="<f8") * m_want
        bound = 1e-6 * np.abs(w).max()
        worst = float(np.abs(g - w).max())
        if worst > bound:
            raise AssertionError(f"{label}: GRM x m_used off by {worst:.4g} > {bound:.4g}")
        report += f", GRM x m_used within {worst:.4g} (bound 1e-6 max|GRM| = {bound:.4g})"
    return report


def phase_mesh(tmp: Path, full: Path, worlds) -> dict:
    """glm, score, king, genome and pca through the port's CLI over variant
    shards, one process per card, on the full chr22 fixture with phase 8's
    seeded tables, each against the same run as one lone process: (a)
    linear glm QT ~ C1 + C2 over every variant and (b) --modifier genotypic
    QT0 over phase 8's 50,000-variant region (_compare_glm_runs at BETA/SE
    rtol 1e-3 atol 1e-5, OBS_CT and the NA cells exact); (c) score of every
    10th variant with and without --no-mean-imputation (ALLELE_CT exact,
    every other column within 1e-4 of its largest |value|); (d) king over
    every variant with --min-kinship, and --cutoff, at the 99.9th
    percentile of its kinships, and (e) genome with --min-pi-hat at that of
    its PI_HAT, each output sha256-equal; (f) pca -k 10 --make-rel bin and
    (g) --approx (m_used exact, eigenvalues at rtol 1e-3, the GRM x m_used
    within 1e-6 of its largest entry). Every run prints its wall (process
    start and NCCL set-up inside), its process_group and collective stages
    and rank 0's --stats report, whose lines a rank name its card and rows;
    every rank must have launched its kernels. (h) times the collectives
    alone. Needs as many cards as the largest of ``worlds``."""
    import numpy as np
    import torch

    from pgen_tpu_torch.pipeline.genome import genome_table
    from pgen_tpu_torch.pipeline.king import king_table

    cards = torch.cuda.device_count()
    worlds = [w for w in worlds if w <= cards]
    if not worlds:
        print(f"[12 mesh] skipped: {cards} card visible (one process per card needs two or "
              "more)")
        return {}
    iids, pos, _, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    tables = _gwas_tables(tmp, iids, packed)
    _weights_table(tmp, full, n_var, np.random.default_rng(SEED + 8))
    first_b = n_var // 2 - GWAS_REGION // 2
    region_b = f"22:{pos[first_b]}-{pos[first_b + GWAS_REGION - 1]}"
    # the 99.9th percentiles of every pair's kinship and PI_HAT, from one
    # run each that emits no row
    t0 = time.perf_counter()
    iu = np.triu_indices(n, k=1)
    kin = king_table(str(full), out_file=str(tmp / "probe.kin0"), device="cuda",
                     min_kinship=1.0).kinship[iu]
    pi_hat = genome_table(str(full), out_file=str(tmp / "probe.genome"), device="cuda",
                          min_pi_hat=2.0).estimates["pi_hat"][iu]
    kinship = float(f"{np.nanpercentile(kin, 99.9):.6g}")
    min_pi = float(f"{np.nanpercentile(pi_hat, 99.9):.4f}")
    for f in ("probe.kin0", "probe.genome"):
        (tmp / f).unlink()
    print(f"[12 mesh] 99.9th percentiles over every variant and pair: kinship {kinship}, "
          f"PI_HAT {min_pi} ({time.perf_counter() - t0:.1f} s)")
    tabs = ["--pheno", tables["pheno"], "--covar", tables["covar"], "--covar-name", "C1,C2"]
    score = ["score", full, "--score", tmp / "weights.tsv", "--score-col-nums", "3-5",
             "--score-sums"]
    runs = [  # label, argv, output name, what compares, the collective named in --stats
        ("(a) glm QT ~ C1 + C2, every variant", ["glm", full, *tabs, "--pheno-name", "QT"],
         "a.glm", "glm", "all_gather"),
        (f"(b) glm --modifier genotypic QT0 -r {region_b}",
         ["glm", full, *tabs, "--pheno-name", "QT0", "--modifier", "genotypic", "-r", region_b],
         "b.glm", "glm", "all_gather"),
        ("(c) score, mean imputation", score, "c.sscore", "score", "all_reduce"),
        ("(c) score --no-mean-imputation", [*score, "--no-mean-imputation"], "c_nm.sscore",
         "score", "all_reduce"),
        (f"(d) king --min-kinship {kinship}", ["king", full, "--min-kinship", kinship],
         "d.kin0", ("",), "all_reduce"),
        (f"(d) king --cutoff {kinship}", ["king", full, "--cutoff", kinship], "d_cut",
         (".king.cutoff.in.id", ".king.cutoff.out.id"), "all_reduce"),
        (f"(e) genome --min-pi-hat {min_pi}", ["genome", full, "--min-pi-hat", min_pi],
         "e.genome", ("",), "all_reduce"),
        ("(f) pca -k 10 --make-rel bin", ["pca", full, "-k", PCA_K, "--make-rel", "bin"], "f",
         "pca", "all_reduce"),
        ("(g) pca -k 10 --approx", ["pca", full, "-k", PCA_K, "--approx"], "g", "approx",
         "all_reduce"),
    ]
    walls = {}
    for label, argv, name, check, collective in runs:
        errs = {}
        for world in (1, *worlds):
            out = tmp / f"w{world}.{name}"
            seconds, err, launches = _mesh_run(argv, out, world, tmp)
            walls[(label, world)] = seconds
            errs[world] = err
            for r, counts in enumerate(launches):
                idle = [k for k in MESH_CARD_KERNELS[argv[0]] if counts[k] <= 0]
                if idle:
                    raise AssertionError(f"{label}: rank {r} of {world} never launched {idle}")
            shared = ""
            if world > 1:
                shared = (f"; process_group {_stage_ms(err, 'process_group'):.1f} ms, "
                          f"{collective} {_stage_ms(err, collective):.1f} ms")
            kernels = ", ".join(f"{k} {[c[k] for c in launches]}"
                                for k in MESH_CARD_KERNELS[argv[0]])
            print(f"[12 mesh] {label} on {world} rank(s)"
                  f"{' (LOCAL_RANK reversed)' if world == 4 else ''}: wall {seconds:.3f} s "
                  f"(process start and NCCL set-up inside{shared}); launches a rank: {kernels}; "
                  "rank 0's report:")
            for line in err.strip().splitlines():
                print(f"    {line}")
        for world in worlds:
            got, want = tmp / f"w{world}.{name}", tmp / f"w1.{name}"
            if check == "glm":
                report = _compare_glm_runs(label, got, want, 1e-3, 1e-5)
            elif check == "score":
                report = f"|d| within {_same_scores(label, got, want):.3g} of max|value|"
            elif check in ("pca", "approx"):
                report = _same_pca(label, got, want, errs[world], errs[1], n, check == "pca")
            else:
                for suffix in check:
                    if _sha256(Path(f"{got}{suffix}")) != _sha256(Path(f"{want}{suffix}")):
                        raise AssertionError(f"{label}: {got.name}{suffix} differs on "
                                             f"{world} ranks")
                report = "sha256-equal"
            print(f"[12 mesh] {label}: {world} ranks against 1: {report}")
        for f in tmp.glob(f"w*.{name}*"):
            f.unlink()
    collectives = {w: _mesh_collectives(w, n_var, n, tmp) for w in worlds}
    shown = "; ".join(f"{label} x{w} {s:.3f} s" for (label, w), s in walls.items())
    print(f"[12 mesh] walls: {shown}")
    return collectives


HOST_REGION = 20_000  # variants of phase 13's region runs (export, roh, annotate vs cpu)
DIFF_RECORDS = 64  # phase 13 (e): records with planted code changes
ROH_SAMPLES = 8  # phase 13 (h): samples with a planted homozygous run
ROH_RUN = 5000  # variants of each planted run (about 1.3 Mb at the fixture's spacing)


def _unlink(*prefixes, exts=(".pgen", ".pvar", ".psam")) -> None:
    for prefix in prefixes:
        for ext in exts:
            Path(f"{prefix}{ext}").unlink(missing_ok=True)


def _write_fileset(prefix: Path, packed, pvar_head: bytes, pvar_rows, psam: Path,
                   n_samples: int) -> None:
    """A mode-0x02 fileset from numpy: the 12-byte header and the records,
    the .pvar's header lines and rows, a copy of ``psam``."""
    import shutil
    import struct

    with open(f"{prefix}.pgen", "wb") as f:
        f.write(b"\x6c\x1b\x02" + struct.pack("<II", len(packed), n_samples) + b"\x40")
        f.write(packed.tobytes())
    with open(f"{prefix}.pvar", "wb") as f:
        f.write(pvar_head)
        f.write(b"".join(pvar_rows))
    shutil.copyfile(psam, f"{prefix}.psam")


def _pvar_parts(prefix: Path) -> tuple:
    """The .pvar's header lines and its data rows (each with its newline)."""
    data = Path(f"{prefix}.pvar").read_bytes()
    body = data.index(b"\n#CHROM") + 1
    body = data.index(b"\n", body) + 1
    return data[:body], data[body:].splitlines(keepends=True)


def _info_oracle(counts, n_cohort: int) -> list:
    """--fill-info AC,AN,AF,MAF,NS,F_MISSING of each row of (rows, 4)
    counts, as annotate writes it (%d and %.6g)."""
    out = []
    for hom_ref, het, hom_alt, miss in counts.tolist():
        ac, nobs = het + 2 * hom_alt, hom_ref + het + hom_alt
        af = ac / max(2 * nobs, 1) if nobs else 0.0
        out.append("AC=%d;AN=%d;AF=%.6g;MAF=%.6g;NS=%d;F_MISSING=%.6g" % (
            ac, 2 * nobs, af, min(af, 1.0 - af), nobs, miss / max(n_cohort, 1)))
    return out


def _same_on_cpu(label: str, run, files) -> float:
    """``run("cpu", "cpu")`` after the cuda run that wrote ``files`` (each
    named cuda.*; the cpu run writes cpu.*): sha256-equal, then both
    deleted. Returns the cpu run's wall seconds."""
    hashes = [_sha256(f) for f in files]
    seconds = run("cpu", "cpu")
    for f, want in zip(files, hashes):
        twin = f.with_name(f.name.replace("cuda.", "cpu.", 1))
        if _sha256(twin) != want:
            raise AssertionError(f"{label}: {f.name} differs from the --device cpu run's")
        f.unlink()
        twin.unlink()
    return seconds


def phase_host(tmp: Path, full: Path, device: str = "cuda") -> dict:
    """The twelve fileset subcommands (ROADMAP §1 item 13) through the port's
    CLI on the full chr22 fixture, every sample, the card stages on
    ``device`` (launch counts read around the phase):
    (a) filter --keep writes the first and the last 1,252 samples as two
    pgen filesets (K5); merge of the two (K1 + K4) gives back the fixture's
    .pgen, sha256-equal. (b) split --parts 4, then concat of the parts:
    .pgen, .pvar and .psam sha256-equal to the fixture's. (c) sort of a
    copy with its rows in a seeded order gives back the .pgen and .pvar;
    isec of the fixture with its 20,000-variant region (a pgen fileset
    written by filter -r) gives that region (both_a, both_b). (d) index of
    the region's .vcf.gz (filter -o X.vcf.gz) writes the .tbi of filter
    --index, byte for byte; view -r of a 100-variant span prints those rows
    of the gunzipped VCF; describe prints the fixture's header. (e) diff of
    the fixture with a copy in which 64 seeded records hold seeded code
    changes (between called codes) reports exactly those cells, and its
    --per-sample DIFF_CT and CMP_CT are the planted and called counts (K1).
    (f) annotate --fill-info AC,AN,AF,MAF,NS,F_MISSING over every sample
    (K8) and a --samples-file of 1,001 (K14): the INFO of 2,000 seeded
    variants equal to numpy counts' text; then --fill-info all on the
    region fileset, with and without the cohort, sha256-equal to --device
    cpu. (g) export A, AD and ped of the region, sha256-equal to --device
    cpu (K1; a keep-all .raw of every variant would be 5.5 GB). (h) roh of
    the region with homozygous runs of 5,000 variants planted in 8 seeded
    samples: one segment a planted run, its ends within a window (50
    variants) of the run's, and the .hom and
    .hom.indiv sha256-equal to --device cpu (the host scan holds (S, L)
    u16 arrays: all of chr22 would need tens of GB). Returns the launches."""
    import gzip

    import numpy as np

    iids, pos, _, packed = _read_fileset(full)
    n_var, n = len(pos), len(iids)
    rng = np.random.default_rng(SEED + 13)
    first = int(rng.integers(0, n_var - HOST_REGION))
    region = f"22:{pos[first]}-{pos[first + HOST_REGION - 1]}"
    walls = {}
    psam = Path(f"{full}.psam")
    want_pgen = _sha256(Path(f"{full}.pgen"))

    def timed(label, seconds):
        walls[label] = seconds
        print(f"[13 host] {label}: {seconds:.3f} s")

    print(f"[13 host] every sample ({n}); cuts in variants: (a)-(f) all {n_var} but view "
          f"-r (100) and the INFO oracle ({COUNT_ORACLE_VARIANTS}); the region of (c) isec, "
          f"(d) index, (f) --device cpu, (g) and (h): {HOST_REGION} variants, {region}")
    _reset_launches()

    # (a) merge of two halves of the samples: K5 writes them, K1 + K4 join them
    half = n // 2
    for name, keep in (("h1", iids[:half]), ("h2", iids[half:])):
        (tmp / f"{name}.txt").write_text("".join(f"{i}\n" for i in keep))
        seconds, _ = _port_run(["filter", full, "--keep", tmp / f"{name}.txt", "--out-format",
                                "pgen", "-o", tmp / name], device)
        timed(f"(a) filter --keep {len(keep)} samples --out-format pgen", seconds)
    seconds, _ = _port_run(["merge", tmp / "h1", tmp / "h2", "-o", tmp / "merged", "--stats"],
                           device)
    if _sha256(Path(f"{tmp / 'merged'}.pgen")) != want_pgen:
        raise AssertionError("(a) merge of the two halves differs from the fixture's .pgen")
    if Path(f"{tmp / 'merged'}.psam").read_text().count("\n") != n + 1:
        raise AssertionError("(a) the merged .psam does not hold every sample")
    timed(f"(a) merge {half} + {n - half} samples x {n_var} variants, .pgen sha256-equal "
          f"to the fixture's", seconds)
    _unlink(tmp / "h1", tmp / "h2", tmp / "merged")

    # (b) split --parts 4, concat of the parts
    seconds, _ = _port_run(["split", full, "--parts", "4", "-o", tmp / "sp", "--stats"])
    timed("(b) split --parts 4", seconds)
    parts = [tmp / f"sp.part{i}" for i in range(1, 5)]
    seconds, _ = _port_run(["concat", *parts, "-o", tmp / "cat", "--stats"])
    if _fileset_sha256(tmp / "cat") != _fileset_sha256(full):
        raise AssertionError("(b) concat of split --parts 4 differs from the fixture")
    timed("(b) concat of the 4 parts, .pgen/.pvar/.psam sha256-equal to the fixture's",
          seconds)
    _unlink(tmp / "cat", *parts)

    # (c) sort of a shuffled copy; isec with the region
    head, rows = _pvar_parts(full)
    perm = rng.permutation(n_var)
    t0 = time.perf_counter()
    _write_fileset(tmp / "shuf", np.asarray(packed)[perm], head, [rows[i] for i in perm], psam,
                   n)
    print(f"[13 host] (c) a copy with its rows in a seeded order, in "
          f"{time.perf_counter() - t0:.1f} s")
    seconds, _ = _port_run(["sort", tmp / "shuf", "-o", tmp / "sorted", "--stats"])
    if (_fileset_sha256(tmp / "sorted")[:2] != _fileset_sha256(full)[:2]):
        raise AssertionError("(c) sort of the shuffled copy is not the fixture")
    timed("(c) sort of the shuffled copy, .pgen/.pvar sha256-equal to the fixture's", seconds)
    _unlink(tmp / "shuf", tmp / "sorted")
    seconds, _ = _port_run(["filter", full, "-r", region, "--out-format", "pgen",
                            "-o", tmp / "reg"], device)
    timed(f"(c) filter -r {region} --out-format pgen (the region fileset)", seconds)
    seconds, _ = _port_run(["isec", full, tmp / "reg", "--write", "both_a,both_b",
                            "-o", tmp / "is", "--stats"])
    for side in ("both_a", "both_b"):
        if _fileset_sha256(tmp / f"is.{side}") != _fileset_sha256(tmp / "reg"):
            raise AssertionError(f"(c) isec's {side} is not the region")
    timed("(c) isec of the fixture and the region: both_a and both_b sha256-equal to the "
          "region", seconds)
    _unlink(tmp / "is.both_a", tmp / "is.both_b")

    # (d) index, view, describe
    gz = tmp / "x.vcf.gz"
    seconds, _ = _port_run(["filter", tmp / "reg", "-o", gz, "--index"], device)
    timed(f"(d) filter -o X.vcf.gz --index of the region ({gz.stat().st_size} B)", seconds)
    import shutil

    shutil.copyfile(gz, tmp / "y.vcf.gz")
    seconds, _ = _port_run(["index", tmp / "y.vcf.gz", "--stats"])
    if Path(f"{tmp / 'y.vcf.gz'}.tbi").read_bytes() != Path(f"{gz}.tbi").read_bytes():
        raise AssertionError("(d) index's .tbi differs from filter --index's")
    timed("(d) index: .tbi byte-equal to filter --index's", seconds)
    lo = first + HOST_REGION // 2
    span = f"22:{pos[lo]}-{pos[lo + 99]}"
    seconds, _ = _port_run(["view", tmp / "y.vcf.gz", "-r", span, "-H"],
                           stdout=tmp / "view.txt")
    with gzip.open(gz, "rb") as f:
        body = [ln for ln in f.read().split(b"\n") if ln and not ln.startswith(b"#")]
    want = b"".join(ln + b"\n" for ln in body[lo - first : lo - first + 100])
    if (tmp / "view.txt").read_bytes() != want:
        raise AssertionError(f"(d) view -r {span} does not print the span's 100 rows")
    timed(f"(d) view -r {span} -H: the span's 100 rows of the gunzipped VCF", seconds)
    seconds, _ = _port_run(["describe", f"{full}.pgen"], stdout=tmp / "describe.txt")
    text = (tmp / "describe.txt").read_text()
    if f"variants: {n_var}\nsamples: {n}\n" not in text or "storage mode: 0x02" not in text:
        raise AssertionError(f"(d) describe printed {text!r}")
    timed("(d) describe of the fixture's .pgen", seconds)
    for f in (gz, tmp / "y.vcf.gz", Path(f"{gz}.tbi"), Path(f"{tmp / 'y.vcf.gz'}.tbi"),
              tmp / "view.txt", tmp / "describe.txt"):
        f.unlink()

    # (e) diff against a copy with planted code changes
    rows_k = np.sort(rng.choice(n_var, DIFF_RECORDS, replace=False))
    changed = np.asarray(packed[rows_k]).copy()
    cells = []
    for k, r in enumerate(rows_k):
        for s in np.sort(rng.choice(n, int(rng.integers(1, 4)), replace=False)):
            shift = 2 * (s & 3)
            old = (changed[k, s >> 2] >> shift) & 3
            if old == 3:
                continue  # half-missing pairs are not discordant by default
            new = (old + 1 + int(rng.integers(0, 2))) % 3
            changed[k, s >> 2] = (changed[k, s >> 2] & ~np.uint8(3 << shift)) | (new << shift)
            cells.append((r, s, old, new))
    shutil.copyfile(f"{full}.pgen", f"{tmp / 'planted'}.pgen")
    shutil.copyfile(f"{full}.pvar", f"{tmp / 'planted'}.pvar")
    shutil.copyfile(psam, f"{tmp / 'planted'}.psam")
    copy = np.memmap(f"{tmp / 'planted'}.pgen", dtype=np.uint8, mode="r+", offset=12,
                     shape=packed.shape)
    copy[rows_k] = changed
    copy.flush()
    del copy
    seconds, _ = _port_run(["diff", full, tmp / "planted", "--per-sample", "-o", tmp / "d.pdiff",
                            "--stats"], device)
    gt = ["0/0", "0/1", "1/1"]
    want = "".join(f"22\t{pos[r]}\tsnp{r}\t{iids[s]}\t{gt[a]}\t{gt[b]}\n" for r, s, a, b in cells)
    if (tmp / "d.pdiff").read_text() != "#CHROM\tPOS\tID\tIID\tGT1\tGT2\n" + want:
        raise AssertionError("(e) diff does not report exactly the planted cells")
    per = _lines(tmp / "d.pdiff.sdiff")
    diff_ct = np.bincount([s for _, s, _, _ in cells], minlength=n)
    called = n_var - _sample_missing_numpy(packed)[:n]
    if ([int(f[1]) for f in per] != diff_ct.tolist()
            or [int(f[2]) for f in per] != called.tolist()):
        raise AssertionError("(e) diff --per-sample's DIFF_CT/CMP_CT are not the planted and "
                             "called counts")
    timed(f"(e) diff against {DIFF_RECORDS} records with {len(cells)} planted cells: exactly "
          f"those reported; DIFF_CT and CMP_CT equal to numpy's", seconds)
    _unlink(tmp / "planted", exts=(".pgen", ".pvar", ".psam"))
    (tmp / "d.pdiff").unlink()
    (tmp / "d.pdiff.sdiff").unlink()

    # (f) annotate --fill-info: K8 over every sample, K14 over a cohort of 1,001
    oracle_rows = np.sort(rng.choice(n_var, COUNT_ORACLE_VARIANTS, replace=False))
    cohort = np.sort(rng.choice(n, KEEP_SAMPLES, replace=False))
    (tmp / "cohort.txt").write_text("".join(f"{iids[s]}\n" for s in cohort))
    tags = "AC,AN,AF,MAF,NS,F_MISSING"
    for label, extra, samples in (("every sample", [], np.arange(n)),
                                  (f"--samples-file of {KEEP_SAMPLES}",
                                   ["--samples-file", tmp / "cohort.txt"], cohort)):
        seconds, _ = _port_run(["annotate", full, "--fill-info", tags, *extra,
                                "-o", tmp / "an", "--stats"], device)
        _, got_rows = _pvar_parts(tmp / "an")
        got = [got_rows[r].rstrip(b"\n").split(b"\t")[7].decode() for r in oracle_rows]
        want = _info_oracle(_masked_counts_numpy(packed, oracle_rows, samples), len(samples))
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"(f) annotate --fill-info over {label}: INFO of variant "
                                 f"{oracle_rows[bad]} is {got[bad]!r}, numpy's {want[bad]!r}")
        timed(f"(f) annotate --fill-info {tags} over {label}, {n_var} variants: "
              f"{len(oracle_rows)} rows' INFO equal to numpy's", seconds)
        _unlink(tmp / "an")
    for label, extra in (("all samples", []),
                         (f"{KEEP_SAMPLES} samples", ["--samples-file", tmp / "cohort.txt"])):
        def run(tag, dev, extra=extra):
            return _port_run(["annotate", tmp / "reg", "--fill-info", "all", *extra,
                              "-o", tmp / f"{tag}.an"], dev)[0]
        seconds = run("cuda", device)
        cpu_s = _same_on_cpu("(f)", run, [tmp / f"cuda.an{e}" for e in (".pvar", ".pgen")])
        Path(f"{tmp / 'cuda.an'}.psam").unlink()
        Path(f"{tmp / 'cpu.an'}.psam").unlink()
        timed(f"(f) annotate --fill-info all of the region, {label}, sha256-equal to --device "
              f"cpu (cpu {cpu_s:.3f} s)", seconds)

    # (g) export A, AD, ped of the region
    for fmt, out, files in (("A", "ex.raw", [".raw"]), ("AD", "ex.raw", [".raw"]),
                            ("ped", "ex", [".ped", ".map"])):
        stem = out.split(".")[0]

        def run(tag, dev, fmt=fmt, out=out):
            return _port_run(["export", full, fmt, "-r", region, "-o", tmp / f"{tag}.{out}",
                              "--stats"], dev)[0]
        seconds = run("cuda", device)
        if fmt == "A":
            lines = Path(f"{tmp / 'cuda.ex.raw'}").read_bytes().split(b"\n", 4)[1:4]
            codes = _codes_numpy(packed, np.arange(first, first + HOST_REGION))
            for s, line in enumerate(lines):
                cells = line.split(b"\t")[6:]
                want = [b"NA" if c == 3 else str(c).encode() for c in codes[:, s].tolist()]
                if cells != want:
                    raise AssertionError(f"(g) export A: the row of sample {s} differs from "
                                         "numpy's decode")
        names = [tmp / f"cuda.{stem}{e}" for e in files]
        size = sum(f.stat().st_size for f in names)
        cpu_s = _same_on_cpu(f"(g) export {fmt}", run, names)
        timed(f"(g) export {fmt} of the region ({size} B), sha256-equal to --device cpu "
              f"(cpu {cpu_s:.3f} s)", seconds)

    # (h) roh of the region with planted homozygous runs
    reg_packed = np.asarray(packed[first : first + HOST_REGION]).copy()
    planted = np.sort(rng.choice(n, ROH_SAMPLES, replace=False))
    starts = rng.integers(0, HOST_REGION - ROH_RUN, ROH_SAMPLES)
    for s, a in zip(planted, starts):
        shift = 2 * (s & 3)
        hom = rng.integers(0, 2, ROH_RUN).astype(np.uint8) * 2
        col = reg_packed[a : a + ROH_RUN, s >> 2]
        reg_packed[a : a + ROH_RUN, s >> 2] = (col & ~np.uint8(3 << shift)) | (hom << shift)
    head, rows = _pvar_parts(tmp / "reg")
    _write_fileset(tmp / "roh", reg_packed, head, rows, psam, n)

    def run(tag, dev):
        return _port_run(["roh", tmp / "roh", "-o", tmp / f"{tag}.roh", "--stats"], dev)[0]
    seconds = run("cuda", device)
    # plink's state needs 3 acceptable 50-SNP windows (0.05 of those
    # covering a SNP) and the ends are trimmed to clean calls, so a called
    # segment may start or end up to a window inside or outside the run
    segs = _lines(Path(f"{tmp / 'cuda.roh'}.hom"))
    rpos = pos[first : first + HOST_REGION]
    want = sorted((iids[s], a, a + ROH_RUN - 1) for s, a in zip(planted, starts))
    got = sorted((f[0], int(np.searchsorted(rpos, int(f[4]))), int(np.searchsorted(rpos, int(f[5]))))
                 for f in segs)
    if len(got) != len(want) or any(g[0] != w[0] or abs(g[1] - w[1]) > 50 or abs(g[2] - w[2]) > 50
                                    for g, w in zip(got, want)):
        raise AssertionError(f"(h) roh called {got} (IID, first and last variant of the "
                             f"region), the planted runs are {want}")
    cpu_s = _same_on_cpu("(h) roh", run, [Path(f"{tmp / 'cuda.roh'}{e}")
                                          for e in (".hom", ".hom.indiv")])
    timed(f"(h) roh of the region, {ROH_SAMPLES} planted runs of {ROH_RUN} variants each "
          f"called, its ends within a window of the run's; .hom/.hom.indiv sha256-equal to "
          f"--device cpu (cpu {cpu_s:.3f} s)", seconds)
    _unlink(tmp / "roh", tmp / "reg")
    (tmp / "h1.txt").unlink()
    (tmp / "h2.txt").unlink()
    (tmp / "cohort.txt").unlink()

    launches = _read_launches()
    print(f"[13 host] path launches: {launches}")
    if device == "cuda":
        for kname in ("unpack_codes", "pack_codes", "gt_counts_device", "gt_counts_masked"):
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} never launched on the host subcommands' path")
    return launches


WORKERS = (2, 4)  # phase 14 (b): --workers N
SHARDS = 3  # phase 14 (c): --shards and the --shard-index processes
THREADS = (1, 2, 4)  # phase 14 (e): --threads T
BED_ORACLE_VARIANTS = 2000  # phase 14 (a): seeded rows of the --keep .bed held against numpy
# --stats of a --workers worker and of --shards: the launches of K2, K3 and
# the counts K8, K9, K14 (pgen_tpu_torch/parallel/shard.py REPORTED)
_LAUNCHES = (r"genotype_text (\d+), subset_text_from_packed (\d+), gt_counts_device (\d+), "
             r"sample_counts_device (\d+), gt_counts_masked (\d+)")
_WORKER_LINE = re.compile(
    r"^worker (\d+) \((\w+)\): entered ([\d.]+) s after the start, ran ([\d.]+) s; launches "
    + _LAUNCHES + r"; pinned (\d+) B, device peak (\d+) B$")
_SHARD_LINE = re.compile(r"^launches: " + _LAUNCHES + "$")


def _bed_lut_numpy():
    """Each pgen record byte as a PLINK1 .bed byte, with numpy alone: code 0
    (hom REF) -> 0b11, 1 (het) -> 0b10, 2 (hom ALT) -> 0b00, 3 (missing)
    -> 0b01, LSB-first as in both formats."""
    import numpy as np

    plink = np.array([3, 2, 0, 1], dtype=np.uint8)
    b = np.arange(256)
    lut = np.zeros(256, dtype=np.uint8)
    for k in range(4):
        lut |= (plink[(b >> (2 * k)) & 3] << (2 * k)).astype(np.uint8)
    return lut


def _bed_files_sha256(prefix: Path) -> list:
    return [_sha256(Path(f"{prefix}{suf}")) for suf in (".bed", ".bim", ".fam")]


def _worker_reports(stderr: str, n: int, label: str, launched: bool = True) -> list:
    """The --workers run's lines of its n workers: (start method, entered
    s, ran s, K2 launches, K3 launches, pinned B, device peak B, (K8, K9,
    K14 launches)) each; with ``launched`` every worker must have launched
    a text kernel."""
    rows = [m.groups() for m in map(_WORKER_LINE.match, stderr.splitlines()) if m]
    if [int(r[0]) for r in rows] != list(range(n)):
        raise AssertionError(f"{label}: --stats names workers {[r[0] for r in rows]}, not 0-{n - 1}")
    reports = [(r[1], float(r[2]), float(r[3]), int(r[4]), int(r[5]), int(r[9]), int(r[10]),
                tuple(map(int, r[6:9]))) for r in rows]
    for i, r in enumerate(reports):
        if launched and r[3] + r[4] <= 0:
            raise AssertionError(f"{label}: worker {i} launched neither K2 nor K3")
    return reports


def _shard_line(stderr: str, label: str) -> tuple:
    """(K2, K3, K8, K9, K14) launches a --shards run prints under --stats."""
    got = [tuple(map(int, m.groups())) for m in map(_SHARD_LINE.match, stderr.splitlines()) if m]
    if len(got) != 1:
        raise AssertionError(f"{label}: --stats printed launches {got}")
    return got[0]


def _shard_launches(stderr: str, label: str, launched: bool = True) -> tuple:
    """(K2, K3) launches a --shards run prints under --stats; with
    ``launched`` one must be above 0."""
    got = _shard_line(stderr, label)[:2]
    if launched and sum(got) <= 0:
        raise AssertionError(f"{label}: --stats printed launches {got}")
    return got


def phase_files(tmp: Path, full: Path, ragged: Path, refs: dict, device: str = "cuda") -> dict:
    """filter --out-format bed, import X.bed, --workers, --shards,
    --shard-index, --resume and --threads through the port's CLI on the
    card, on the full chr22 fixture (the 140,001-variant one for keep-all
    VCF text). ``refs``: phase 4's keep-two and plain keep-all sha256 and
    phase 5's --keep .pgen sha256. (a) --out-format bed keep-all (no kernel:
    the body numpy's LUT of the records) and with phase 5's --keep (K5, 17
    launches; 2,000 seeded rows equal to numpy's re-pack, LUT and pad mask),
    each sha256-equal to --device cpu, then import of each .bed: the
    fixture's .pgen and phase 5's. (b) --workers 2 and 4 on keep-two (K3)
    and on the keep-all .vcf.gz --index (K2): keep-two sha256-equal to phase
    4's; the .gz gunzipped equal to phase 4's plain keep-all, it and its
    .tbi sha256-equal to --shards N in one process (BGZF members follow the
    shards' blocks); keep-two again as a subprocess of the CLI under fork
    (the default is forkserver; the CPU tests run spawn). Each worker's
    launches must be above 0. (c) --shards 3 in one process, then --shard-index 0, 1 and 2
    as three processes at once into one shared .vcf: each sha256-equal to
    keep-two's. (d) --workers 3 with PGEN_TPU_TEST_FAIL_SHARD=1 exits 1 and
    its manifest marks shard 1 failed; --resume runs shard 1 alone and gives
    keep-two's bytes. (e) --threads 1, 2 and 4 on keep-two and on the plain
    keep-all, each sha256-equal to phase 4's, with exactly 17 and 3
    launches. Every card run is on ``device`` (``cpu`` skips the launch
    checks). Returns the phase's launches, those of its worker and shard
    processes added."""
    import numpy as np
    import torch

    from pgen_tpu_torch.cli import main as port_main

    iids, pos, _, packed = _read_fileset(full)
    n_var, n_ragged = len(pos), len(_read_fileset(ragged)[1])
    card = device == "cuda"
    two = ["--samples", f"{iids[7]},{iids[2000]}"]
    keep = _keep_samples(iids)
    keep_file = tmp / "keep14.txt"
    keep_file.write_text("".join(f"{iids[i]}\n" for i in keep))
    lut = _bed_lut_numpy()
    others = dict.fromkeys(KERNELS, 0)  # launches of the workers and shard processes
    cli = [sys.executable, "-m", "pgen_tpu_torch.cli"]
    print(f"[14 files] full chr22 ({n_var} variants x {len(iids)} samples); keep-all VCF text "
          f"on the {n_ragged}-variant fixture; keep-two = samples 7 and 2000")
    _reset_launches()

    # (a) .bed out, keep-all then the --keep cohort; import of each
    for label, argv, tag in (("keep-all", [], "ka"),
                             (f"--keep {KEEP_SAMPLES}", ["--keep", keep_file], "kp")):
        before = _read_launches()
        cuda_s, err = _port_cli(["filter", full, "--out-format", "bed", *argv], tmp / f"{tag}_cuda",
                                device)
        k5 = _read_launches()["subset_repack"] - before["subset_repack"]
        if card and k5 != (0 if tag == "ka" else -(-n_var // BLOCK_ROWS)):
            raise AssertionError(f"(a) .bed {label}: K5 launched {k5} times")
        width = len(iids) if tag == "ka" else KEEP_SAMPLES
        rec = (width + 3) // 4
        body = np.memmap(f"{tmp / tag}_cuda.bed", dtype=np.uint8, mode="r", offset=3,
                         shape=(n_var, rec))
        if tag == "ka":
            for lo in range(0, n_var, BLOCK_ROWS):
                if not np.array_equal(body[lo : lo + BLOCK_ROWS], lut[packed[lo : lo + BLOCK_ROWS]]):
                    raise AssertionError(f"(a) .bed {label}: rows from {lo} are not numpy's LUT")
        else:
            rows = np.sort(np.random.default_rng(SEED + 14).choice(n_var, BED_ORACLE_VARIANTS,
                                                                   replace=False))
            want = lut[_repack_numpy(np.asarray(packed[rows]), keep)]
            want[:, -1] &= (1 << (2 * (width % 4))) - 1 if width % 4 else 0xFF
            if not np.array_equal(np.asarray(body[rows]), want):
                raise AssertionError(f"(a) .bed {label}: rows differ from numpy's re-pack and LUT")
        del body
        hashes = _bed_files_sha256(tmp / f"{tag}_cuda")
        cpu_s, _ = _port_cli(["filter", full, "--out-format", "bed", *argv], tmp / f"{tag}_cpu",
                             "cpu")
        if _bed_files_sha256(tmp / f"{tag}_cpu") != hashes:
            raise AssertionError(f"(a) .bed {label}: the cuda run's files differ from the cpu run's")
        _unlink(tmp / f"{tag}_cpu", exts=(".bed", ".bim", ".fam"))
        imp_s, _ = _port_cli(["import", f"{tmp / tag}_cuda.bed"], tmp / f"{tag}_imp", device)
        want_pgen = _sha256(Path(f"{full}.pgen")) if tag == "ka" else refs["keep-pgen"]
        if _sha256(Path(f"{tmp / tag}_imp.pgen")) != want_pgen:
            raise AssertionError(f"(a) import of the {label} .bed is not the "
                                 f"{'fixture' if tag == 'ka' else 'phase 5'} .pgen")
        _unlink(tmp / f"{tag}_cuda", exts=(".bed", ".bim", ".fam"))
        _unlink(tmp / f"{tag}_imp")
        print(f"[14 files] (a) .bed {label}: {n_var} x {rec} B body, "
              f"{'numpy LUT of every record' if tag == 'ka' else f'{BED_ORACLE_VARIANTS} rows equal to numpy'}"
              f", .bed/.bim/.fam sha256-equal to cpu; import gives back the "
              f"{'fixture' if tag == 'ka' else 'phase 5'} .pgen; wall cuda {cuda_s:.3f} s, "
              f"cpu {cpu_s:.3f} s, import {imp_s:.3f} s (K5 {k5})")

    def workers_run(label, prefix, argv, out, n):
        seconds, err = _port_cli(["filter", prefix, *argv, "--workers", str(n)], out, device)
        reports = _worker_reports(err, n, label, card)
        for r in reports:
            others["genotype_text"] += r[3]
            others["subset_text_from_packed"] += r[4]
        return seconds, reports

    def show(label, seconds, reports):
        starts = ", ".join(f"{r[1]:.2f}/{r[2]:.2f}" for r in reports)
        print(f"[14 files] {label}: wall {seconds:.3f} s, start method {reports[0][0]}; each "
              f"worker's entry after the start / its shard's seconds: {starts}; launches "
              f"K2/K3 {[(r[3], r[4]) for r in reports]}; peak pinned {[r[5] for r in reports]} B, "
              f"device {[r[6] for r in reports]} B")

    # (b) --workers N: keep-two (K3) and the keep-all .vcf.gz --index (K2)
    for n in WORKERS:
        out = tmp / f"w{n}.vcf"
        seconds, reports = workers_run(f"(b) --workers {n} keep-two", full, two, out, n)
        if _sha256(out) != refs["keep-two"]:
            raise AssertionError(f"(b) --workers {n} keep-two differs from phase 4's")
        out.unlink()
        show(f"(b) --workers {n} keep-two, sha256-equal to phase 4's", seconds, reports)
        gz = tmp / f"w{n}.vcf.gz"
        seconds, reports = workers_run(f"(b) --workers {n} keep-all .vcf.gz --index", ragged,
                                       ["--index"], gz, n)
        ref = tmp / f"s{n}.vcf.gz"
        ref_s, err = _port_cli(["filter", ragged, "--index", "--shards", str(n)], ref, device)
        _shard_launches(err, f"(b) --shards {n} .vcf.gz", card)
        for a, b in ((gz, ref), (Path(f"{gz}.tbi"), Path(f"{ref}.tbi"))):
            if _sha256(a) != _sha256(b):
                raise AssertionError(f"(b) --workers {n}: {a.name} differs from --shards {n}'s")
        if _gunzip_sha256(gz) != refs["keep-all"]:
            raise AssertionError(f"(b) --workers {n}: the .vcf.gz is not phase 4's keep-all text")
        for f in (gz, ref, Path(f"{gz}.tbi"), Path(f"{ref}.tbi")):
            f.unlink()
        show(f"(b) --workers {n} keep-all .vcf.gz --index, .gz/.tbi sha256-equal to --shards "
             f"{n} in one process ({ref_s:.3f} s), gunzipped equal to phase 4's", seconds,
             reports)
    for method in ("fork",):
        out = tmp / f"{method}.vcf"
        env = {**os.environ, "PGEN_TPU_MP_CONTEXT": method}
        seconds, outs = _run_processes(
            [[*cli, "filter", str(full), *two, "--workers", "2", "--device", device, "--stats",
              "-o", str(out)]], [env], tmp, method)
        reports = _worker_reports(outs[0][1], 2, f"(b) --workers 2 under {method}", card)
        if reports[0][0] != method or _sha256(out) != refs["keep-two"]:
            raise AssertionError(f"(b) --workers 2 under {method} differs from phase 4's")
        for r in reports:
            others["subset_text_from_packed"] += r[4]
        out.unlink()
        show(f"(b) --workers 2 keep-two as a process of the CLI, sha256-equal", seconds, reports)

    # (c) --shards 3 in one process; --shard-index 0..2 as three processes at once
    out = tmp / "sh.vcf"
    seconds, err = _port_cli(["filter", full, *two, "--shards", str(SHARDS)], out, device)
    launched = _shard_launches(err, f"(c) --shards {SHARDS}", card)
    if _sha256(out) != refs["keep-two"]:
        raise AssertionError(f"(c) --shards {SHARDS} differs from phase 4's keep-two")
    out.unlink()
    print(f"[14 files] (c) --shards {SHARDS} keep-two in one process: wall {seconds:.3f} s, "
          f"sha256-equal; launches K2/K3 {launched}")
    out = tmp / "shared.vcf"
    cmds = [[*cli, "filter", str(full), *two, "--shards", str(SHARDS), "--shard-index", str(i),
             "--device", device, "--stats", "-o", str(out)] for i in range(SHARDS)]
    seconds, outs = _run_processes(cmds, [dict(os.environ)] * SHARDS, tmp, "shard_index")
    launched = [_shard_launches(e, f"(c) --shard-index {i}", card)
                for i, (_, e) in enumerate(outs)]
    for k2, k3 in launched:
        others["genotype_text"] += k2
        others["subset_text_from_packed"] += k3
    if _sha256(out) != refs["keep-two"]:
        raise AssertionError("(c) the three --shard-index processes' file differs from keep-two's")
    out.unlink()
    print(f"[14 files] (c) --shard-index 0-{SHARDS - 1} as {SHARDS} processes at once into one "
          f".vcf: wall {seconds:.3f} s (process start included), sha256-equal; launches K2/K3 "
          f"{launched}")

    # (d) a failed worker, then --resume
    out = tmp / "resume.vcf"
    base = ["filter", str(full), *two, "--workers", "3"]
    os.environ["PGEN_TPU_TEST_FAIL_SHARD"] = "1"
    err = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = port_main([*base, "--device", device, "-o", str(out)])
        fail_s = time.perf_counter() - t0
    finally:
        del os.environ["PGEN_TPU_TEST_FAIL_SHARD"]
    manifest = json.loads(Path(f"{out}.manifest.json").read_text())
    statuses = [s["status"] for s in manifest["shards"]]
    if rc != 1 or statuses != ["done", "failed", "done"] or "--resume" not in err.getvalue():
        raise AssertionError(f"(d) the injected failure gave rc {rc}, shards {statuses}\n"
                             f"{err.getvalue()[-2000:]}")
    seconds, err = _port_run([*base, "--resume", "--stats", "-o", out], device)
    rows = [m.groups() for m in map(_WORKER_LINE.match, err.splitlines()) if m]
    if [r[0] for r in rows] != ["1"] or (card and int(rows[0][5]) <= 0):
        raise AssertionError(f"(d) --resume ran workers {[r[0] for r in rows]}, not shard 1 alone")
    others["subset_text_from_packed"] += int(rows[0][5])
    if _sha256(out) != refs["keep-two"] or Path(f"{out}.manifest.json").exists():
        raise AssertionError("(d) --resume did not finish keep-two's bytes")
    out.unlink()
    print(f"[14 files] (d) --workers 3 with shard 1 failing: exit 1 in {fail_s:.3f} s, manifest "
          f"{statuses}; --resume ran shard 1 alone in {seconds:.3f} s, sha256-equal to keep-two's")

    # (e) --threads T: each thread its own buffers and stream
    for label, prefix, argv, ref, kname, blocks in (
            ("keep-two", full, two, refs["keep-two"], "subset_text_from_packed",
             -(-n_var // BLOCK_ROWS)),
            ("keep-all", ragged, [], refs["keep-all"], "genotype_text",
             -(-n_ragged // BLOCK_ROWS))):
        for t in THREADS:
            out = tmp / f"t{t}.vcf"
            before = _read_launches()[kname]
            if card:
                torch.cuda.reset_peak_memory_stats()
            seconds, err = _port_cli(["filter", prefix, *argv, "--threads", str(t)], out, device)
            launched = _read_launches()[kname] - before
            if (card and launched != blocks) or _sha256(out) != ref:
                raise AssertionError(f"(e) --threads {t} {label}: {launched} launches of {kname} "
                                     f"(want {blocks}), or its bytes differ from phase 4's")
            out.unlink()
            threaded = any(ln.startswith("emit: ") for ln in err.splitlines())
            emit = f"emit {_stage_ms(err, 'emit'):.1f} ms, " if threaded else ""
            # each thread (no more than blocks) pins a block's staging and text
            width = 2 if kname == "subset_text_from_packed" else len(iids)
            pinned = min(t, blocks) * BLOCK_ROWS * ((len(iids) + 3) // 4 + 4 * width)
            print(f"[14 files] (e) --threads {t} {label}: wall {seconds:.3f} s ({emit}assemble "
                  f"{_stage_ms(err, 'assemble'):.1f} ms summed over threads), sha256-equal to "
                  f"phase 4's, {launched} launches of {kname}; {pinned} B pinned"
                  + (f", peak device {torch.cuda.max_memory_allocated()} B" if card else ""))
    keep_file.unlink()

    launches = _read_launches()
    for kname, n in others.items():
        launches[kname] += n
    print(f"[14 files] path launches (its worker and shard processes' added): {launches}")
    for kname in ("subset_repack", "genotype_text", "subset_text_from_packed"):
        if card and launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on phase 14's paths")
    return launches


A4_REGION = 5000  # phase 15 (a): variants of the -r region whose rows are written
A4_DUP_EVERY = 10  # phase 15 (a) --rm-dup: every 10th region row takes the ID before it
A4_TWIN_PAD = 7500  # phase 15 (a): rows on each side of the region in the twins' fileset
CPU_TWIN_THREADS = 2  # phase 15 (a): torch threads of each of the four --device cpu runs
COUNT_KERNELS = ("gt_counts_device", "sample_counts_device", "gt_counts_masked")

# Phase 15 (b): one process of run_distributed_filter, its group from the
# PGEN_TPU_* variables; then a second call in the same process with its own
# group (coordinator_address given, overriding the variables), one part a
# process. Prints one JSON line: its wall, and each call's wall, time from
# the process's start to its group, and K2/K3 launches.
_DIST_MAIN = """
import json, os, sys, time
started = time.time()
from pgen_tpu_torch.ops.gt_text import genotype_text, subset_text_from_packed
from pgen_tpu_torch.parallel.distributed import run_distributed_filter
prefix, sam_query, out, port2, device = sys.argv[1:6]
calls = []
for shared_fs, extra in ((True, {}), (False, {"coordinator_address": f"127.0.0.1:{port2}"})):
    genotype_text.launches = subset_text_from_packed.launches = 0
    t0 = time.time()
    res = run_distributed_filter(prefix, sam_query=sam_query, out_file=out,
                                 shared_fs=shared_fs, device=device, **extra)
    stages = res.timer.stages
    calls.append({"shared_fs": shared_fs, "call_s": time.time() - t0,
                  "start_to_group_s": t0 - started + stages["process_group"].seconds,
                  "group_s": stages["process_group"].seconds,
                  "barrier_s": stages["barrier"].seconds,
                  "K2": genotype_text.launches, "K3": subset_text_from_packed.launches})
print(json.dumps({"rank": int(os.environ["PGEN_TPU_PROC_ID"]), "wall_s": time.time() - started,
                  "calls": calls}))
"""


# Phase 15 (a): the port's CLI once for each argv list of argv[1] (JSON), in
# order, on argv[2] threads; prints each run's wall seconds as one JSON list.
_CPU_RUNS = """
import json, sys, time
import torch
from pgen_tpu_torch.cli import main
torch.set_num_threads(int(sys.argv[2]))
walls = []
for argv in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    if main(argv) != 0:
        sys.exit(f"{argv[:2]} failed")
    walls.append(time.perf_counter() - t0)
print(json.dumps(walls))
"""


def _dup_fileset(tmp: Path, full: Path, rows) -> tuple:
    """The full fixture with every ``A4_DUP_EVERY``-th of ``rows`` (from the
    second) carrying the ID of the row before it: the .pgen and .psam
    linked, the .pvar rewritten. Returns its prefix and every row's ID."""
    d = tmp / "dup15"
    d.mkdir()
    prefix = d / "chr22"
    for ext in (".pgen", ".psam"):
        os.symlink(f"{full}{ext}", f"{prefix}{ext}")
    head, body = _pvar_parts(full)
    ids = [row.split(b"\t", 3)[2] for row in body]
    for i in rows[1::A4_DUP_EVERY]:
        f = body[i].split(b"\t", 3)
        body[i] = b"\t".join([f[0], f[1], ids[i - 1], f[3]])
        ids[i] = ids[i - 1]
    Path(f"{prefix}.pvar").write_bytes(head + b"".join(body))
    return prefix, ids


def _region_copy(prefix: Path, src: Path, rows, packed) -> Path:
    """A fileset of ``rows`` of the fileset ``src`` whose records are
    ``packed``: the records and .pvar rows taken, the .psam copied."""
    prefix.parent.mkdir()
    head, body = _pvar_parts(src)
    _write_fileset(prefix, packed[rows], head, [body[i] for i in rows], Path(f"{src}.psam"),
                   len(_read_fileset(src)[0]))
    return prefix


def phase_surface(tmp: Path, full: Path, refs: dict, device: str = "cuda") -> dict:
    """The last of pgen_tpu's surface on the card, on the full chr22
    fixture. (a) --provider device's GT_* counts under --shards 2 (in this
    process): a variant GT_MAF predicate over every sample (K8), a sample
    GT_MISSING_RATE predicate (K9), a GT_MAF predicate over a
    --samples-file of 1,001 IIDs (K14), --rm-dup list with the first on a
    copy of the fixture whose region holds duplicated IDs (K8 twice: the
    report, then the shards), and --workers 2 on the first. Each threshold
    is the median of numpy's counts, each run writes the rows of a
    5,000-variant region (-r) and counts every row of the fixture: one
    mask computation is 17 launches (65,536-row blocks), and each run's
    K8/K9/K14 deltas must be exactly 17 times its computations (each
    worker's --stats line 17). Each VCF is checked with numpy against the
    .pgen (kept rows and samples from numpy's counts; the .rmdup.list
    against numpy's), then by sha256 against the lone --provider device
    filter; and each case on a fileset of the 20,000 rows around the
    region (of the fixture, or of its --rm-dup copy) on the card against
    the same run on --device cpu (the plain counts, each case in a process
    of its own, all four beside the card's runs on ``CPU_TWIN_THREADS``
    threads each: over every row they took 37.6-65.3 s each, the
    smoke's time); the --workers run against the
    --shards run's. (b) run_distributed_filter as two processes at once
    (PGEN_TPU_COORDINATOR, _NUM_PROCS, _PROC_ID) on the visible card(s):
    keep-two with shared_fs, then, in the same processes with a group of
    their own each call, shared_fs=False; the shared file and the two parts
    concatenated are sha256-equal to phase 4's keep-two; each process's K3
    launches must be above 0. Every card run is on ``device`` (``cpu``
    skips the launch checks). Returns the phase's launches, its worker and
    distributed processes' added."""
    import numpy as np

    from pgen_tpu_torch.ops.gt_stats import COUNT_BLOCK_ROWS

    iids, pos, _, packed = _read_fileset(full)
    n_var, card = len(pos), device == "cuda"
    blocks = -(-n_var // COUNT_BLOCK_ROWS)
    lo = n_var // 4
    lo_pos, hi_pos = pos[lo], pos[lo + A4_REGION - 1]
    region = f"22:{lo_pos}-{hi_pos}"
    in_region = np.flatnonzero((pos >= lo_pos) & (pos <= hi_pos))
    every, cohort = np.arange(len(iids)), _keep_samples(iids)
    cohort_file = tmp / "cohort15.txt"
    cohort_file.write_text("".join(f"{iids[i]}\n" for i in cohort))

    # thresholds at the median of numpy's counts, so that about half pass
    maf = _maf_numpy(_variant_counts_numpy(packed, in_region))
    maf_thr = float(f"{np.median(maf):.6f}")
    cmaf = _maf_numpy(_masked_counts_numpy(packed, in_region, cohort))
    cmaf_thr = float(f"{np.median(cmaf):.6f}")
    missing_rate = _sample_missing_numpy(packed)[: len(iids)] / n_var
    miss_thr = float(f"{np.median(missing_rate):.8f}")
    maf_rows, cohort_rows = in_region[maf >= maf_thr], in_region[cmaf >= cmaf_thr]
    miss_samples = np.flatnonzero(missing_rate < miss_thr)
    dup, ids = _dup_fileset(tmp, full, in_region)
    twin_rows = np.arange(max(0, lo - A4_TWIN_PAD), min(n_var, lo + A4_REGION + A4_TWIN_PAD))
    twins = {src: _region_copy(tmp / f"twin15_{k}" / "chr22", src, twin_rows, packed)
             for k, src in enumerate((full, dup))}
    kept_ids = [ids[i] for i in maf_rows]
    want_dups = sorted(x.decode() for x in set(kept_ids) if kept_ids.count(x) > 1)
    print(f"[15 surface] full chr22 ({n_var} variants x {len(iids)} samples), rows written of "
          f"-r {region} ({len(in_region)} variants); one mask computation = {blocks} launches "
          f"({COUNT_BLOCK_ROWS}-row blocks); GT_MAF >= {maf_thr} keeps {len(maf_rows)}, over "
          f"the cohort of {KEEP_SAMPLES} >= {cmaf_thr} keeps {len(cohort_rows)}; "
          f"GT_MISSING_RATE < {miss_thr} keeps {len(miss_samples)} samples; the --rm-dup copy "
          f"lists {len(want_dups)} IDs (numpy)")

    variant = ["--include-var", f"GT_MAF >= {maf_thr}", "-r", region]
    cases = [
        # label, fileset, argv, mask computations a count kernel, (kept rows, samples)
        ("variant GT_MAF", full, variant, {"gt_counts_device": 1}, (maf_rows, every)),
        ("sample GT_MISSING_RATE", full,
         ["--include-sam", f"GT_MISSING_RATE < {miss_thr}", "-r", region],
         {"sample_counts_device": 1}, (in_region, miss_samples)),
        (f"--samples-file {KEEP_SAMPLES} GT_MAF", full,
         ["--samples-file", cohort_file, "--include-var", f"GT_MAF >= {cmaf_thr}", "-r", region],
         {"gt_counts_masked": 1}, (cohort_rows, cohort)),
        ("--rm-dup list GT_MAF", dup, [*variant, "--rm-dup", "list"], {"gt_counts_device": 2},
         (maf_rows, every)),
    ]
    others = dict.fromkeys(KERNELS, 0)  # launches of the worker and distributed processes
    _reset_launches()
    t_phase = time.perf_counter()

    def outputs(out: Path) -> list:
        return [out] + ([Path(f"{out}.rmdup.list")] if Path(f"{out}.rmdup.list").exists() else [])

    def run_argv(i: int, fileset=None) -> list:
        return ["filter", fileset or cases[i][1], *cases[i][2], "--provider", "device"]

    # the --device cpu runs on the twins' filesets (the plain counts over
    # their rows, twice for --rm-dup), each case in a process of its own,
    # all started beside the card's runs
    cpu_procs, twin_shas = [], []
    try:
        for i in range(len(cases)):
            cpu_run = [*map(str, run_argv(i, twins[cases[i][1]])), "--shards", "2", "--device",
                       "cpu", "-o", str(tmp / f"a4_{i}_cpu.vcf")]
            log = open(tmp / f"a4_{i}_cpu.err", "w+")
            cpu_procs.append((subprocess.Popen(
                [sys.executable, "-c", _CPU_RUNS, json.dumps([cpu_run]), str(CPU_TWIN_THREADS)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True), log))
        # (a) --shards 2 in this process, then the lone --provider device filter
        shas = []
        for i, (label, _, argv, computations, (rows, samples)) in enumerate(cases):
            out = tmp / f"a4_{i}.vcf"
            before = _read_launches()
            cuda_s, err = _port_cli([*run_argv(i), "--shards", "2"], out, device)
            delta = {k: _read_launches()[k] - before[k] for k in COUNT_KERNELS}
            want = {k: blocks * computations.get(k, 0) for k in COUNT_KERNELS}
            line = _shard_line(err, f"(a) {label}")
            if card and delta != want:
                raise AssertionError(f"(a) {label}: count launches {delta}, want {want} "
                                     f"({blocks} a mask computation)")
            if card and line[2:] != tuple(blocks * min(computations.get(k, 0), 1)
                                          for k in COUNT_KERNELS):
                raise AssertionError(f"(a) {label}: the shards' --stats line says {line}")
            _check_gt_text(out, packed, rows, samples)
            if argv[-1] == "list":
                got = Path(f"{out}.rmdup.list").read_text().splitlines()
                if got != want_dups:
                    raise AssertionError(f"(a) {label}: .rmdup.list has {len(got)} IDs, numpy "
                                         f"{len(want_dups)}")
            hashes = [_sha256(f) for f in outputs(out)]
            # the lone --provider device filter
            other = tmp / f"a4_{i}_lone.vcf"
            lone_s, _ = _port_cli(run_argv(i), other, device)
            if [_sha256(f) for f in outputs(other)] != hashes:
                raise AssertionError(f"(a) {label}: the lone run's files differ")
            for f in outputs(other):
                f.unlink()
            for f in outputs(out)[1:]:
                f.unlink()
            out.unlink()
            shas.append(hashes)
            # the same on the twins' fileset, against the --device cpu run
            twin = tmp / f"a4_{i}_twin.vcf"
            _port_cli([*run_argv(i, twins[cases[i][1]]), "--shards", "2"], twin, device)
            twin_shas.append([_sha256(f) for f in outputs(twin)])
            for f in outputs(twin):
                f.unlink()
            print(f"[15 surface] (a) --shards 2 {label}: GT text equal to numpy's decode of the "
                  f".pgen{', .rmdup.list to numpy' if len(hashes) > 1 else ''}, sha256-equal to "
                  f"the lone run; count launches {delta} = {blocks} x {computations}; wall cuda "
                  f"{cuda_s:.3f} s, lone {lone_s:.3f} s")

        # (a) --workers 2 on the variant case: each worker counts on its card
        out = tmp / "a4_workers.vcf"
        seconds, err = _port_cli(["filter", full, *variant, "--provider", "device",
                                  "--workers", "2"], out, device)
        reports = _worker_reports(err, 2, "(a) --workers 2 GT_MAF", card)
        for r in reports:
            if card and r[7] != (blocks, 0, 0):
                raise AssertionError(f"(a) --workers 2: a worker launched K8/K9/K14 {r[7]}, "
                                     f"want ({blocks}, 0, 0)")
            others["genotype_text"] += r[3]
            others["subset_text_from_packed"] += r[4]
            for k, n in zip(COUNT_KERNELS, r[7]):
                others[k] += n
        if _sha256(out) != shas[0][0]:
            raise AssertionError("(a) --workers 2 differs from the --shards 2 run")
        out.unlink()
        print(f"[15 surface] (a) --workers 2 GT_MAF: wall {seconds:.3f} s, sha256-equal to "
              f"--shards 2; each worker's entry / seconds {[(r[1], r[2]) for r in reports]}, "
              f"launches K8/K9/K14 {[r[7] for r in reports]}, K2/K3 "
              f"{[(r[3], r[4]) for r in reports]}")

        # (b) run_distributed_filter, two processes at once
        out = tmp / "dist15.vcf"
        env = {k: v for k, v in os.environ.items() if k not in _RANK_VARS}
        coordinator = f"127.0.0.1:{_free_port()}"
        envs = [{**env, "PGEN_TPU_COORDINATOR": coordinator, "PGEN_TPU_NUM_PROCS": "2",
                 "PGEN_TPU_PROC_ID": str(r)} for r in range(2)]
        sam_query = f'IID == "{iids[7]}" || IID == "{iids[2000]}"'
        cmd = [sys.executable, "-c", _DIST_MAIN, str(full), sam_query, str(out),
               str(_free_port()), device]
        seconds, outs = _run_processes([cmd, cmd], envs, tmp, "dist15")
        reports = sorted((json.loads(o.strip().splitlines()[-1]) for o, _ in outs),
                         key=lambda r: r["rank"])
        parts = hashlib.sha256()
        for r in range(2):
            parts.update(Path(f"{out}.shard{r}").read_bytes())
        if _sha256(out) != refs["keep-two"] or parts.hexdigest() != refs["keep-two"]:
            raise AssertionError("(b) run_distributed_filter's file or parts differ from "
                                 "phase 4's keep-two")
        for r in reports:
            for call in r["calls"]:
                if card and call["K3"] <= 0:
                    raise AssertionError(f"(b) process {r['rank']} launched no K3 "
                                         f"(shared_fs={call['shared_fs']})")
                others["genotype_text"] += call["K2"]
                others["subset_text_from_packed"] += call["K3"]
        for f in (out, *(Path(f"{out}.shard{r}") for r in range(2))):
            f.unlink()
        for r in reports:
            calls = "; ".join(
                f"shared_fs={c['shared_fs']}: call {c['call_s']:.3f} s, group "
                f"{c['group_s']:.3f} s, barrier {c['barrier_s']:.3f} s, K3 {c['K3']}"
                for c in r["calls"])
            print(f"[15 surface] (b) run_distributed_filter process {r['rank']}: wall "
                  f"{r['wall_s']:.3f} s, start to group "
                  f"{r['calls'][0]['start_to_group_s']:.3f} s; {calls}")
        print(f"[15 surface] (b) keep-two shared file and parts sha256-equal to phase 4's; both "
              f"processes {seconds:.3f} s (process start included)")

        # the background's --device cpu runs
        cpu_walls = []
        for i, (proc, log) in enumerate(cpu_procs):
            cpu_out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                log.seek(0)
                raise AssertionError(f"(a) {cases[i][0]}: the --device cpu run exited "
                                     f"{proc.returncode}\n{log.read()[-3000:]}")
            cpu_walls += json.loads(cpu_out.strip().splitlines()[-1])
            other = tmp / f"a4_{i}_cpu.vcf"
            if [_sha256(f) for f in outputs(other)] != twin_shas[i]:
                raise AssertionError(f"(a) {cases[i][0]}: the --device cpu run's files differ")
            for f in outputs(other):
                f.unlink()
        print(f"[15 surface] (a) on the {len(twin_rows)} rows around the region, --device cpu "
              f"runs beside the card's ({CPU_TWIN_THREADS} threads each), each sha256-equal to "
              "the card's run: "
              + ", ".join(f"{case[0]} {w:.3f} s" for case, w in zip(cases, cpu_walls)))
        cohort_file.unlink()
        for ext in (".pgen", ".pvar", ".psam"):
            Path(f"{dup}{ext}").unlink()
            for twin in twins.values():
                Path(f"{twin}{ext}").unlink()
    finally:
        for proc, log in cpu_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    launches = _read_launches()
    for kname, n in others.items():
        launches[kname] += n
    print(f"[15 surface] path launches (its worker and distributed processes' added), "
          f"{time.perf_counter() - t_phase:.1f} s: {launches}")
    for kname in ("subset_text_from_packed", *COUNT_KERNELS):
        if card and launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on phase 15's paths")
    return launches


def _adopt_orphans() -> None:
    """Makes this process the child subreaper of what it starts (Linux
    prctl PR_SET_CHILD_SUBREAPER), so that a process whose parent exits
    before it does (a CLI subprocess's forkserver) becomes this process's
    child, which ``_stop_processes`` can stop and reap."""
    import ctypes

    if ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def _children() -> dict:
    """This process's children, pid -> (state, command line), from /proc."""
    out = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            state, ppid = (d / "stat").read_text().rsplit(")", 1)[1].split()[:2]
            if int(ppid) == os.getpid():
                cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
                out[int(d.name)] = (state, cmd)
        except (OSError, IndexError, ValueError):
            continue  # exited while being read
    return out


def _stop_processes() -> None:
    """Stops every process this run started that is still there: the
    workers' forkserver and multiprocessing's resource tracker, which the
    --workers runs in this process start and which would otherwise exit
    only after this process has (each closes its end of a pipe and waits),
    then any other child or adopted orphan (SIGTERM, SIGKILL after 5 s),
    each reaped and printed. Repeats until none is left, since a process
    stopped can leave children of its own."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    for _ in range(10):
        left = _children()
        if not left:
            return
        for pid, (state, cmd) in left.items():
            if state != "Z":  # a zombie is only reaped
                print(f"[smoke] stopping process {pid} left running: {cmd[:200]}")
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + 5
        for pid in left:
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(pid, os.WNOHANG) == (0, 0):
                    if time.monotonic() > deadline:
                        os.kill(pid, signal.SIGKILL)
                        os.waitpid(pid, 0)
                        break
                    time.sleep(0.05)
    raise AssertionError(f"processes left running: {_children()}")


def main(argv: list) -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    if not (ROOT / "pgen_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no checkout of the repository (pgen_tpu_torch/); "
              "run it from the root of one", file=sys.stderr)
        return 1
    _adopt_orphans()
    try:
        return _smoke(argv, started, torch)
    finally:
        _stop_processes()


def _time_phases() -> dict:
    """Wraps each phase function of this script, and make_fixtures, so that
    a call prints its seconds and adds them to the returned dict, by name in
    the order the phases start."""
    seconds = {}
    space = globals()
    for fname in [n for n in space if n.startswith("phase_") or n == "make_fixtures"]:
        def timed(*args, _fn=space[fname], _name=fname, **kwargs):
            seconds.setdefault(_name, 0.0)
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                seconds[_name] += time.perf_counter() - t0
                print(f"[smoke] {_name} took {time.perf_counter() - t0:.1f} s", flush=True)

        space[fname] = timed
    return seconds


def _smoke(argv: list, started: float, torch) -> int:
    sys.path.insert(0, str(ROOT))
    seconds = _time_phases()
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
            collectives = phase_mesh(tmp, full, MESH_WORLDS)
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}; takes none or --ranks (phases 7 (a) "
              "and 12 across 2 and 4 cards)", file=sys.stderr)
        return 2
    else:
        measured = phase_kernels()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            tmp = Path(tmp)
            fixtures = make_fixtures(tmp)
            launches, refs = phase_filter(tmp, fixtures["full"], fixtures["ragged"])
            per_path = [launches]
            launches, refs["keep-pgen"] = phase_pgen_out(tmp, fixtures["full"])
            per_path += [launches, phase_import(tmp, fixtures["import"])]
            launches, sha_a = phase_device_provider(tmp, fixtures["full"], fixtures["ragged"])
            per_path.append(launches)
            phase_ranks(tmp, fixtures["full"], sha_a)
            per_path.append(phase_gwas(tmp, fixtures["full"]))
            for kname in ("glm_planes", "score_dosage"):
                if per_path[-1][kname] <= 0:
                    raise AssertionError(f"{kname} never launched on the GWAS path")
            per_path.append(phase_relatedness(tmp, fixtures["full"]))
            per_path += phase_counts(tmp, fixtures["full"])
            per_path += phase_ld(tmp, fixtures["full"])
            collectives = phase_mesh(tmp, fixtures["full"], (2,))
            per_path.append(phase_host(tmp, fixtures["full"]))
            per_path.append(phase_files(tmp, fixtures["full"], fixtures["ragged"], refs))
            per_path.append(phase_surface(tmp, fixtures["full"], refs))
    print("[smoke] seconds by phase: "
          + ", ".join(f"{fname} {sec:.1f}" for fname, sec in seconds.items()))
    print(f"[smoke] {time.perf_counter() - started:.1f} s in all")
    loaded = sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] == "pgen_tpu")
    if loaded:
        raise AssertionError(f"the port's run loaded {loaded[:5]}")

    if not argv:
        rows = []
        for kname, where in KERNELS.items():
            m = measured["times"][kname]
            rows.append({
                "name": kname, "route": "cuda", "source": SOURCE, "replaces": where,
                "launches": sum(launches[kname] for launches in per_path),
                "max_abs_err": measured["err"][kname], "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "burst_ms": m["burst_ms"],
            })
        print(f"[smoke] products beside K12 and K13: {json.dumps(measured['products'])}")
        print("[smoke] launches count wrapper calls; a call of pca_approx_pass launches three "
              "kernels (pca_zq_kernel, pca_zty_kernel, pca_sum_kernel) for each 24 of q's "
              "columns")
        print(json.dumps({"kernels": rows}))
    if collectives:
        print(f"[smoke] mesh collectives a card count: {json.dumps(collectives)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
