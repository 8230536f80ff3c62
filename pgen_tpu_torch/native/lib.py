"""ctypes bindings for the C++ host runtime.

Builds pgen_native.so from pgen_native.cpp on first import (cached by source
hash under build/pgen_tpu_torch/ at the root of the checkout). If no C++
toolchain is available the pipeline falls back to the vectorized numpy path —
slower, but behavior-identical (tests cover both).

Copied from ``pgen_tpu/native/lib.py`` (and ``pgen_native.cpp`` beside it,
byte for byte but for one citation): only the imports and the build
directory differ, and the port adds ``format_g10_rows`` (pca's
``.eigenvec`` text, the ``#include <charconv>`` and ``<cmath>`` it needs, and
its code at the end of ``pgen_native.cpp``). It is host code, built with g++
and pgen_tpu's flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from pgen_tpu_torch.utils.log import get_logger

log = get_logger("native")

_SRC = Path(__file__).with_name("pgen_native.cpp")
_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "pgen_tpu_torch"


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _CACHE_DIR / f"pgen_native_{tag}.so"
    if so_path.exists():
        return so_path
    with tempfile.TemporaryDirectory() as td:
        tmp_so = Path(td) / "pgen_native.so"
        base = [
            "g++",
            "-O3",
            "-march=native",
            "-shared",
            "-fPIC",
            "-o",
            str(tmp_so),
            str(_SRC),
            "-lz",
            "-pthread",
        ]
        # Prefer libdeflate for the bgzf path (~3x zlib); fall back silently.
        attempts = [
            base + ["-DPGEN_HAVE_LIBDEFLATE", "-ldeflate"],
            base,
        ]
        for cmd in attempts:
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                break
            except (OSError, subprocess.CalledProcessError) as e:
                last = e
        else:
            detail = getattr(last, "stderr", b"")
            log.warning("native build failed (%s %s); using numpy fallback", last, detail)
            return None
        os.replace(tmp_so, so_path)
    return so_path


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pgen_emit_vcf_rows.restype = ctypes.c_int64
        lib.pgen_emit_vcf_rows.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, i32p,
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.pgen_emit_vcf_rows_buf.restype = ctypes.c_int64
        lib.pgen_emit_vcf_rows_buf.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, i32p,
            ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.pgen_emit_vcf_rows_meta.restype = ctypes.c_int64
        lib.pgen_emit_vcf_rows_meta.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, i64p, i32p,
            ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.pgen_emit_vcf_rows_masked.restype = ctypes.c_int64
        lib.pgen_emit_vcf_rows_masked.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, i64p, u8p,
            ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.pgen_assemble_rows_buf.restype = ctypes.c_int64
        lib.pgen_assemble_rows_buf.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, u8p, ctypes.c_int64,
        ]
        lib.pgen_extract_column.restype = None
        lib.pgen_extract_column.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.pgen_fill_seps_par.restype = None
        lib.pgen_fill_seps_par.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.pgen_assemble_rows_planes.restype = ctypes.c_int64
        lib.pgen_assemble_rows_planes.argtypes = [
            u32p, u32p, u32p, u32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, i64p, u8p, ctypes.c_int64,
        ]
        lib.pgen_gt_counts.restype = None
        lib.pgen_gt_counts.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
        ]
        lib.pgen_gt_counts_par.restype = None
        lib.pgen_gt_counts_par.argtypes = lib.pgen_gt_counts.argtypes
        lib.pgen_bgzf_compress.restype = ctypes.c_int64
        lib.pgen_bgzf_compress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.pgen_bgzf_bound.restype = ctypes.c_int64
        lib.pgen_bgzf_bound.argtypes = [ctypes.c_int64]
        lib.pgen_info_extract.restype = None
        lib.pgen_info_extract.argtypes = [
            u8p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64, i64p, i64p,
        ]
        lib.pgen_gt_counts_masked.restype = None
        lib.pgen_gt_counts_masked.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p,
        ]
        lib.pgen_gt_counts_masked_par.restype = None
        lib.pgen_gt_counts_masked_par.argtypes = lib.pgen_gt_counts_masked.argtypes
        lib.pgen_join_lines.restype = ctypes.c_int64
        lib.pgen_join_lines.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i32p, u8p, ctypes.c_int64,
        ]
        lib.pgen_column_equals.restype = None
        lib.pgen_column_equals.argtypes = [
            u8p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64, u8p,
        ]
        lib.pgen_count_seps.restype = None
        lib.pgen_count_seps.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p]
        lib.pgen_fill_seps.restype = None
        lib.pgen_fill_seps.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
        lib.pgen_unpack_codes.restype = None
        lib.pgen_unpack_codes.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.pgen_pack_codes.restype = None
        lib.pgen_pack_codes.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        self.has_bgzf_decompress = hasattr(lib, "pgen_bgzf_decompress")
        if self.has_bgzf_decompress:
            lib.pgen_bgzf_decompressed_size.restype = ctypes.c_int64
            lib.pgen_bgzf_decompressed_size.argtypes = [u8p, ctypes.c_int64]
            lib.pgen_bgzf_decompress.restype = ctypes.c_int64
            lib.pgen_bgzf_decompress.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ]
        self.has_sample_counts = hasattr(lib, "pgen_sample_counts")
        if self.has_sample_counts:
            lib.pgen_sample_counts.restype = None
            lib.pgen_sample_counts.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
            ]
        f64p = ctypes.POINTER(ctypes.c_double)
        self.has_glm_moments = hasattr(lib, "pgen_glm_moments_par")
        if self.has_glm_moments:
            lib.pgen_glm_moments_par.restype = None
            lib.pgen_glm_moments_par.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                u8p, f64p, ctypes.c_int64, f64p, ctypes.c_int64, f64p,
                ctypes.c_double, f64p, f64p, f64p, f64p, f64p,
            ]
        self.has_geno_moments = hasattr(lib, "pgen_glm_geno_moments_par")
        if self.has_geno_moments:
            lib.pgen_glm_geno_moments_par.restype = None
            lib.pgen_glm_geno_moments_par.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                u8p, f64p, ctypes.c_int64, f64p, ctypes.c_int64, f64p,
                ctypes.c_double, f64p, f64p, f64p, f64p,
            ]
        self.has_score_moments = hasattr(lib, "pgen_score_moments_par")
        if self.has_score_moments:
            lib.pgen_score_moments_par.restype = None
            lib.pgen_score_moments_par.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                u8p, u8p, f64p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, f64p, i64p, f64p, i64p,
            ]
        lib.pgen_format_g10_rows.restype = ctypes.c_int64
        lib.pgen_format_g10_rows.argtypes = [
            f64p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, u8p, ctypes.c_int64,
            ctypes.c_int,
        ]
        self.has_vcf_import = hasattr(lib, "pgen_vcf_import_rows")
        if self.has_vcf_import:
            lib.pgen_vcf_import_rows.restype = ctypes.c_int64
            lib.pgen_vcf_import_rows.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                u8p, u8p, i64p, i64p,
            ]

    @staticmethod
    def _u8(a: np.ndarray):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def emit_vcf_rows(
        self,
        packed: np.ndarray,
        rec_size: int,
        prefix_buf: np.ndarray,
        prefix_off: np.ndarray,
        sample_idx: np.ndarray | None,
        n_samples: int,
        fd: int,
    ) -> int:
        n_var = len(prefix_off) - 1
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
        sp = (
            np.ascontiguousarray(sample_idx, dtype=np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            )
            if sample_idx is not None
            else None
        )
        ret = self._lib.pgen_emit_vcf_rows(
            self._u8(packed),
            n_var,
            rec_size,
            self._u8(np.ascontiguousarray(prefix_buf, dtype=np.uint8)),
            prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sp,
            n_samples,
            fd,
        )
        if ret < 0:
            raise OSError("native VCF emission failed (write error)")
        return int(ret)

    def emit_vcf_rows_buf(
        self,
        packed: np.ndarray,
        rec_size: int,
        prefix_buf: np.ndarray,
        prefix_off: np.ndarray,
        sample_idx: np.ndarray | None,
        n_samples: int,
        out: np.ndarray,
    ) -> int:
        n_var = len(prefix_off) - 1
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
        sp = (
            np.ascontiguousarray(sample_idx, dtype=np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            )
            if sample_idx is not None
            else None
        )
        ret = self._lib.pgen_emit_vcf_rows_buf(
            self._u8(packed),
            n_var,
            rec_size,
            self._u8(np.ascontiguousarray(prefix_buf, dtype=np.uint8)),
            prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sp,
            n_samples,
            self._u8(out),
            out.nbytes,
        )
        if ret < 0:
            raise ValueError("native VCF emission: output buffer too small")
        return int(ret)

    def emit_vcf_rows_meta(
        self,
        packed: np.ndarray,
        rec_size: int,
        meta_buf: np.ndarray,
        line_starts: np.ndarray,
        line_ends: np.ndarray,
        sample_idx: np.ndarray | None,
        n_samples: int,
        out: np.ndarray,
    ) -> int:
        n_var = len(line_starts)
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        line_starts = np.ascontiguousarray(line_starts, dtype=np.int64)
        line_ends = np.ascontiguousarray(line_ends, dtype=np.int64)
        sp = (
            np.ascontiguousarray(sample_idx, dtype=np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            )
            if sample_idx is not None
            else None
        )
        i64p = ctypes.POINTER(ctypes.c_int64)
        ret = self._lib.pgen_emit_vcf_rows_meta(
            self._u8(packed),
            n_var,
            rec_size,
            self._u8(meta_buf),
            line_starts.ctypes.data_as(i64p),
            line_ends.ctypes.data_as(i64p),
            sp,
            n_samples,
            self._u8(out),
            out.nbytes,
        )
        if ret < 0:
            raise ValueError("native VCF emission: output buffer too small")
        return int(ret)

    def emit_vcf_rows_masked(
        self,
        packed: np.ndarray,
        rec_size: int,
        meta_buf: np.ndarray,
        line_starts: np.ndarray,
        line_ends: np.ndarray,
        byte_masks: np.ndarray,
        n_kept: int,
        out: np.ndarray,
    ) -> int:
        n_var = len(line_starts)
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        line_starts = np.ascontiguousarray(line_starts, dtype=np.int64)
        line_ends = np.ascontiguousarray(line_ends, dtype=np.int64)
        byte_masks = np.ascontiguousarray(byte_masks, dtype=np.uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        ret = self._lib.pgen_emit_vcf_rows_masked(
            self._u8(packed),
            n_var,
            rec_size,
            self._u8(meta_buf),
            line_starts.ctypes.data_as(i64p),
            line_ends.ctypes.data_as(i64p),
            self._u8(byte_masks),
            n_kept,
            self._u8(out),
            out.nbytes,
        )
        if ret < 0:
            raise ValueError("native masked VCF emission: output buffer too small")
        return int(ret)

    def assemble_rows_buf(
        self,
        gt_text: np.ndarray,
        prefix_buf: np.ndarray,
        prefix_off: np.ndarray,
        out: np.ndarray,
    ) -> int:
        gt_text = np.ascontiguousarray(gt_text, dtype=np.uint8)
        n_var, gt_len = gt_text.shape
        prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
        ret = self._lib.pgen_assemble_rows_buf(
            self._u8(gt_text),
            gt_len,
            n_var,
            self._u8(np.ascontiguousarray(prefix_buf, dtype=np.uint8)),
            prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._u8(out),
            out.nbytes,
        )
        if ret < 0:
            raise ValueError("native row assembly: output buffer too small")
        return int(ret)

    def extract_column(
        self,
        buf: np.ndarray,
        starts: np.ndarray,
        lens: np.ndarray,
        width: int,
    ) -> np.ndarray:
        """Zero-padded (rows, width) u8 column matrix in one memcpy pass."""
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        n = len(starts)
        out = np.empty((n, width), dtype=np.uint8)
        self._lib.pgen_extract_column(
            self._u8(buf),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            width,
            self._u8(out),
        )
        return out

    def assemble_rows_planes(
        self,
        planes,  # sequence of four (n_var, plane_words) u32 arrays
        gt_len: int,
        prefix_buf: np.ndarray,
        prefix_off: np.ndarray,
        out: np.ndarray,
    ) -> int:
        """Interleave 4 text-word planes while assembling rows (plane k
        lane j = text word of sample 4j+k; device plane-form output)."""
        ps = [np.ascontiguousarray(p, dtype=np.uint32) for p in planes]
        n_var, plane_words = ps[0].shape
        u32p = ctypes.POINTER(ctypes.c_uint32)
        prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
        ret = self._lib.pgen_assemble_rows_planes(
            ps[0].ctypes.data_as(u32p),
            ps[1].ctypes.data_as(u32p),
            ps[2].ctypes.data_as(u32p),
            ps[3].ctypes.data_as(u32p),
            plane_words,
            gt_len,
            n_var,
            self._u8(np.ascontiguousarray(prefix_buf, dtype=np.uint8)),
            prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._u8(out),
            out.nbytes,
        )
        if ret < 0:
            raise ValueError("native plane assembly: output buffer too small")
        return int(ret)

    def gt_counts(self, packed: np.ndarray, n_samples: int) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        out = np.empty((n_var, 4), dtype=np.int64)
        self._lib.pgen_gt_counts_par(
            self._u8(packed),
            n_var,
            rec,
            n_samples,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    def glm_moments(
        self,
        packed: np.ndarray,
        keep: np.ndarray,
        pcols: np.ndarray,
        qcols: np.ndarray,
        ptot: np.ndarray,
        n_kept: float,
        n_samples: int,
    ):
        """Sparse-complement GLM moments (see pgen_glm_moments).

        pcols/qcols: (S, P)/(S, K) f64 C-contiguous, zero rows for
        dropped samples; keep: (S,) u8; ptot: (P,) column sums over
        kept. Returns (n, mp, gq, sg, sg2) f64 arrays."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        np_, nq = pcols.shape[1], qcols.shape[1]
        f64p = ctypes.POINTER(ctypes.c_double)

        def fp(a):
            return a.ctypes.data_as(f64p)

        n = np.empty(n_var)
        mp = np.empty((n_var, np_))
        gq = np.empty((n_var, nq))
        sg = np.empty(n_var)
        sg2 = np.empty(n_var)
        self._lib.pgen_glm_moments_par(
            self._u8(packed), n_var, rec, n_samples, self._u8(keep),
            fp(pcols), np_, fp(qcols), nq, fp(ptot),
            ctypes.c_double(n_kept), fp(n), fp(mp), fp(gq), fp(sg), fp(sg2),
        )
        return n, mp, gq, sg, sg2

    def glm_geno_moments(
        self,
        packed: np.ndarray,
        keep: np.ndarray,
        pcols: np.ndarray,
        qcols: np.ndarray,
        ptot: np.ndarray,
        n_kept: float,
        n_samples: int,
    ):
        """Sparse-complement modifier moments (pgen_glm_geno_moments):
        like glm_moments but het/hom q2-sums stay separate. Returns
        (n, mp, hetq, homq)."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        np_, nq = pcols.shape[1], qcols.shape[1]
        f64p = ctypes.POINTER(ctypes.c_double)

        def fp(a):
            return a.ctypes.data_as(f64p)

        n = np.empty(n_var)
        mp = np.empty((n_var, np_))
        hetq = np.empty((n_var, nq))
        homq = np.empty((n_var, nq))
        self._lib.pgen_glm_geno_moments_par(
            self._u8(packed), n_var, rec, n_samples, self._u8(keep),
            fp(pcols), np_, fp(qcols), nq, fp(ptot),
            ctypes.c_double(n_kept), fp(n), fp(mp), fp(hetq), fp(homq),
        )
        return n, mp, hetq, homq

    def score_moments(
        self,
        packed: np.ndarray,
        keep: np.ndarray,
        flip: np.ndarray,
        waug: np.ndarray,
        mean_impute: bool,
        n_kept: int,
        n_samples: int,
    ):
        """Sparse-complement score accumulation (pgen_score_moments).
        waug: (V, K+1) f64 C-contiguous with a trailing ones column;
        returns (sums (S, K+1), miss_ct (S,), base (K+1,), m_used)."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        kk = waug.shape[1]
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        sums = np.zeros((n_samples, kk))
        miss = np.zeros(n_samples, dtype=np.int64)
        base = np.zeros(kk)
        m_used = np.zeros(1, dtype=np.int64)
        self._lib.pgen_score_moments_par(
            self._u8(packed), n_var, rec, n_samples, self._u8(keep),
            self._u8(flip), waug.ctypes.data_as(f64p), kk,
            int(bool(mean_impute)), n_kept,
            sums.ctypes.data_as(f64p), miss.ctypes.data_as(i64p),
            base.ctypes.data_as(f64p), m_used.ctypes.data_as(i64p),
        )
        return sums, miss, base, int(m_used[0])

    def bgzf_compress(self, data: np.ndarray, level: int = 1) -> np.ndarray:
        """Compress bytes into independent BGZF blocks (bcftools/tabix
        compatible). Returns the compressed bytes (no EOF marker)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        cap = int(self._lib.pgen_bgzf_bound(data.nbytes))
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.pgen_bgzf_compress(
            self._u8(data), data.nbytes, self._u8(out), cap, level
        )
        if n < 0:
            raise RuntimeError("bgzf compression failed")
        return out[:n]

    def info_extract(
        self,
        buf: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        key: bytes,
    ) -> tuple:
        """(val_starts, val_lens) per row; lens -1=absent, -2=flag."""
        n = len(starts)
        vs = np.empty(n, dtype=np.int64)
        vl = np.empty(n, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        k = np.frombuffer(key, dtype=np.uint8)
        self._lib.pgen_info_extract(
            self._u8(buf),
            ctypes.c_char_p(starts.ctypes.data),
            starts.strides[0],
            ctypes.c_char_p(ends.ctypes.data),
            ends.strides[0],
            n,
            self._u8(k),
            len(key),
            vs.ctypes.data_as(i64p),
            vl.ctypes.data_as(i64p),
        )
        return vs, vl

    def gt_counts_masked(
        self, packed: np.ndarray, byte_masks: np.ndarray
    ) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        byte_masks = np.ascontiguousarray(byte_masks, dtype=np.uint8)
        out = np.empty((n_var, 4), dtype=np.int64)
        self._lib.pgen_gt_counts_masked_par(
            self._u8(packed),
            n_var,
            rec,
            self._u8(byte_masks),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    def join_lines(self, mat_u8: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Join (n, width) u8 rows (lens[i] valid bytes each) with newlines."""
        mat_u8 = np.ascontiguousarray(mat_u8, dtype=np.uint8)
        n, width = mat_u8.shape
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        out = np.empty(int(lens.sum()) + n, dtype=np.uint8)
        ret = self._lib.pgen_join_lines(
            self._u8(mat_u8),
            n,
            width,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._u8(out),
            out.nbytes,
        )
        if ret != out.nbytes:
            raise ValueError("join_lines accounting mismatch")
        return out

    def column_equals(
        self,
        buf: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        literal: bytes,
    ) -> np.ndarray:
        n = len(starts)
        out = np.empty(n, dtype=np.uint8)
        lit = np.frombuffer(literal, dtype=np.uint8) if literal else np.zeros(0, np.uint8)
        self._lib.pgen_column_equals(
            self._u8(buf),
            ctypes.c_char_p(starts.ctypes.data),
            starts.strides[0],
            ctypes.c_char_p(ends.ctypes.data),
            ends.strides[0],
            n,
            self._u8(lit),
            len(literal),
            self._u8(out),
        )
        return out.view(bool)

    def scan_seps(self, buf: np.ndarray) -> tuple:
        """(tab_positions, newline_positions, carriage_return_count) for a
        u8 buffer, via a single-pass SIMD scan. The CR count lets the
        metadata loader detect CRLF files without a separate sweep."""
        buf = np.ascontiguousarray(buf, dtype=np.uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        nt = ctypes.c_int64()
        nn = ctypes.c_int64()
        ncr = ctypes.c_int64()
        self._lib.pgen_count_seps(
            self._u8(buf), buf.nbytes, ctypes.byref(nt), ctypes.byref(nn),
            ctypes.byref(ncr),
        )
        tabs = np.empty(nt.value, dtype=np.int64)
        nls = np.empty(nn.value, dtype=np.int64)
        self._lib.pgen_fill_seps_par(
            self._u8(buf),
            buf.nbytes,
            tabs.ctypes.data_as(i64p),
            nls.ctypes.data_as(i64p),
        )
        return tabs, nls, ncr.value

    def unpack_codes(self, packed: np.ndarray, n_samples: int) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        out = np.empty((n_var, n_samples), dtype=np.uint8)
        self._lib.pgen_unpack_codes(self._u8(packed), n_var, rec, n_samples, self._u8(out))
        return out

    def pack_codes(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        n_var, n_samples = codes.shape
        rec = (2 * n_samples + 7) // 8
        out = np.empty((n_var, rec), dtype=np.uint8)
        self._lib.pgen_pack_codes(self._u8(codes), n_var, n_samples, self._u8(out))
        return out

    def sample_counts(self, packed: np.ndarray, n_samples: int) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        n_var, rec = packed.shape
        out = np.zeros((n_samples, 4), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._lib.pgen_sample_counts(
            self._u8(packed), n_var, rec, n_samples, out.ctypes.data_as(i64p)
        )
        return out

    def format_g10_rows(self, vals: np.ndarray, prefix_buf: np.ndarray,
                        prefix_off: np.ndarray, threads: int) -> np.ndarray:
        """(n, k) f64 values -> the bytes of n text rows, row r being
        prefix_buf[prefix_off[r]:prefix_off[r + 1]], its values as
        f"{x:.10g}" joined by tabs, and a newline; over ``threads`` threads."""
        vals = np.ascontiguousarray(vals, dtype=np.float64)
        n, k = vals.shape
        prefix_buf = np.ascontiguousarray(prefix_buf, dtype=np.uint8)
        prefix_off = np.ascontiguousarray(prefix_off, dtype=np.int64)
        if (prefix_off.shape != (n + 1,) or prefix_off[0] < 0
                or prefix_off[-1] > prefix_buf.size or (np.diff(prefix_off) < 0).any()):
            raise ValueError("prefix_off must hold n + 1 ascending offsets into prefix_buf")
        # room for each prefix and 18 bytes a value (the C++'s bound)
        out = np.empty(int(prefix_off[-1] - prefix_off[0]) + n * (18 * k + 1), dtype=np.uint8)
        got = self._lib.pgen_format_g10_rows(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k,
            self._u8(prefix_buf), prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._u8(out), out.size, max(1, int(threads)))
        if got < 0:
            raise RuntimeError("native .10g rows overflowed their buffer")
        return out[:got]

    def bgzf_decompress(self, data: np.ndarray) -> np.ndarray | None:
        """Parallel BGZF decode; None when `data` is not well-formed BGZF
        (caller falls back to the generic gzip module)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        total = self._lib.pgen_bgzf_decompressed_size(self._u8(data), data.nbytes)
        if total < 0:
            return None
        out = np.empty(max(int(total), 1), dtype=np.uint8)
        got = self._lib.pgen_bgzf_decompress(
            self._u8(data), data.nbytes, self._u8(out), out.nbytes
        )
        if got != total:
            return None
        return out[:total]

    _IMPORT_REASONS = {
        1: "expected 9 tab-separated fixed fields + one field per sample",
        2: "FORMAT does not begin with GT",
        3: "unsupported GT (biallelic hard calls 0/0,0/1,1/1,./. only)",
    }

    def vcf_import_rows(self, chunk: np.ndarray, n_samples: int, rec_size: int):
        """Single-pass parse of a newline-terminated VCF data-row chunk.

        Returns (packed_records (rows, rec_size) u8, pvar_bytes, rows) or
        (None, None, (row, sample, message)) on a parse error so the caller
        can raise with its own row numbering/exception type."""
        chunk = np.ascontiguousarray(chunk, dtype=np.uint8)
        nt = ctypes.c_int64()
        nn = ctypes.c_int64()
        ncr = ctypes.c_int64()
        self._lib.pgen_count_seps(
            self._u8(chunk), chunk.nbytes, ctypes.byref(nt), ctypes.byref(nn),
            ctypes.byref(ncr),
        )
        rows_cap = nn.value
        packed = np.empty((rows_cap, rec_size), dtype=np.uint8)
        pvar_out = np.empty(max(chunk.nbytes, 1), dtype=np.uint8)
        pvar_len = ctypes.c_int64()
        err = np.zeros(3, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        rows = self._lib.pgen_vcf_import_rows(
            self._u8(chunk),
            chunk.nbytes,
            n_samples,
            rec_size,
            self._u8(packed),
            self._u8(pvar_out),
            ctypes.byref(pvar_len),
            err.ctypes.data_as(i64p),
        )
        if rows < 0:
            msg = self._IMPORT_REASONS.get(int(err[2]), "parse error")
            return None, None, (int(err[0]), int(err[1]), msg)
        return (
            packed[:rows],
            pvar_out[: pvar_len.value].tobytes(),
            int(rows),
        )


def _load():
    if os.environ.get("PGEN_TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        return _Native(ctypes.CDLL(str(so)))
    except OSError as e:
        log.warning("failed to load native lib: %s", e)
        return None


native = _load()
HAVE_NATIVE = native is not None
