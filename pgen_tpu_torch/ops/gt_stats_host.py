"""The host half of ``pgen_tpu/ops/gt_stats.py``, copied: per-variant and
per-sample genotype code counts on the host (native C++ or numpy),
cohort-aware subsets, and the ``GT_*`` expression variables derived
from them. Only the imports differ. Left out: the jax providers
``gt_counts_device`` and ``sample_counts_device``, with the
``provider == "device"`` branches of ``gt_counts`` and
``sample_counts`` (which here count on the host, the same exact
counts), and the oracles ``*_reference``. The port's device counts are
``ops/gt_stats.py`` (K8, K9).
"""

from __future__ import annotations

import numpy as np


def gt_counts_numpy(packed: np.ndarray, num_samples: int) -> np.ndarray:
    """Vectorized numpy: byte-histogram x 256->4 LUT matmul, pad-corrected."""
    packed = np.asarray(packed, dtype=np.uint8)
    nvar, rec = packed.shape
    lut = _byte_count_lut()  # (256, 4) int16
    counts = np.zeros((nvar, 4), dtype=np.int64)
    # accumulate per byte; chunk over record bytes to bound temporaries
    chunk = max(1, (1 << 24) // max(nvar, 1))
    for lo in range(0, rec, chunk):
        counts += lut[packed[:, lo : min(lo + chunk, rec)]].sum(
            axis=1, dtype=np.int64
        )
    pad = 4 * rec - num_samples
    if pad:
        last = packed[:, rec - 1]
        for p in range(4 - pad, 4):
            code = (last >> (2 * p)) & 3
            np.subtract.at(counts, (np.arange(nvar), code), 1)
    return counts


def gt_counts_native(packed: np.ndarray, num_samples: int) -> np.ndarray:
    from pgen_tpu_torch.native import native

    return native.gt_counts(packed, num_samples)


def sample_byte_masks(sample_idx: np.ndarray, rec_size: int) -> np.ndarray:
    """Per-record-byte 4-bit keep masks for a sorted sample-index subset."""
    masks = np.zeros(rec_size, dtype=np.uint8)
    sample_idx = np.asarray(sample_idx)
    np.bitwise_or.at(
        masks,
        sample_idx >> 2,
        np.left_shift(1, sample_idx & 3).astype(np.uint8),
    )
    return masks


def gt_counts_subset(
    packed: np.ndarray, sample_idx: np.ndarray, provider: str = "native"
) -> np.ndarray:
    """Code histogram over only the given samples (cohort-aware stats)."""
    packed = np.asarray(packed, dtype=np.uint8)
    masks = sample_byte_masks(sample_idx, packed.shape[1])
    if provider == "native":
        try:
            from pgen_tpu_torch.native import HAVE_NATIVE, native
        except ImportError:
            HAVE_NATIVE = False
        if HAVE_NATIVE:
            return native.gt_counts_masked(packed, masks)
    # fallback: (16,256,4) LUT fancy-indexed by (mask, byte)
    lutm = _masked_count_lut()
    nvar, rec = packed.shape
    counts = np.zeros((nvar, 4), dtype=np.int64)
    chunk = max(1, (1 << 24) // max(nvar, 1))
    for lo in range(0, rec, chunk):
        hi = min(lo + chunk, rec)
        counts += lutm[masks[lo:hi][None, :], packed[:, lo:hi]].sum(
            axis=1, dtype=np.int64
        )
    return counts


_LUTM = None


def _masked_count_lut() -> np.ndarray:
    global _LUTM
    if _LUTM is None:
        lut = np.zeros((16, 256, 4), dtype=np.int16)
        for m in range(16):
            for b in range(256):
                for p in range(4):
                    if m & (1 << p):
                        lut[m, b, (b >> (2 * p)) & 3] += 1
        _LUTM = lut
    return _LUTM


def maybe_gt_extra(node, records, num_samples, sample_idx, provider="native"):
    """If the expression references GT_* variables, compute them.

    Returns a {name: int64 array} dict over ALL variants, or None. Stats are
    cohort-aware: with a sample subset, counts cover only kept samples.
    """
    from pgen_tpu_torch.query.ast import variables

    if node is None:
        return None
    used = variables(node) & set(GT_VARIABLE_NAMES)
    if not used:
        return None
    if sample_idx is not None:
        counts = gt_counts_subset(records, sample_idx, provider)
        n_counted = len(sample_idx)
    else:
        counts = gt_counts(records, num_samples, provider)
        n_counted = num_samples
    return gt_variables(counts, n_counted, used)


def gt_counts(packed: np.ndarray, num_samples: int, provider: str = "native") -> np.ndarray:
    if provider == "native":
        try:
            from pgen_tpu_torch.native import HAVE_NATIVE
        except ImportError:
            HAVE_NATIVE = False
        if HAVE_NATIVE:
            return gt_counts_native(packed, num_samples)
        provider = "numpy"
    return gt_counts_numpy(packed, num_samples)


_LUT = None


def _byte_count_lut() -> np.ndarray:
    global _LUT
    if _LUT is None:
        b = np.arange(256, dtype=np.uint16)
        lut = np.zeros((256, 4), dtype=np.int16)
        for k in range(4):
            for p in range(4):
                lut[:, k] += ((b >> (2 * p)) & 3) == k
        _LUT = lut
    return _LUT


def sample_counts_numpy(packed: np.ndarray, num_samples: int) -> np.ndarray:
    """Vectorized: per bit-position p, shift/mask once and reduce over the
    variant axis for each code — no full code-matrix materialization."""
    packed = np.asarray(packed, dtype=np.uint8)
    nvar, rec = packed.shape
    out = np.zeros((4 * rec, 4), dtype=np.int64)
    chunk = max(1, (1 << 25) // max(rec, 1))
    for lo in range(0, nvar, chunk):
        blk = packed[lo : lo + chunk]
        for p in range(4):
            sub = (blk >> (2 * p)) & 3  # (vb, rec)
            for k in range(4):
                out[p::4, k] += (sub == k).sum(axis=0, dtype=np.int64)
    return out[:num_samples]


def sample_counts(
    packed: np.ndarray, num_samples: int, provider: str = "native"
) -> np.ndarray:
    """(V, rec) packed records -> (S, 4) per-sample code histogram."""
    if provider == "native":
        try:
            from pgen_tpu_torch.native import HAVE_NATIVE, native
        except ImportError:
            HAVE_NATIVE = False
        if HAVE_NATIVE and getattr(native, "has_sample_counts", False):
            return native.sample_counts(packed, num_samples)
        provider = "numpy"
    return sample_counts_numpy(packed, num_samples)


GT_VARIABLE_NAMES = (
    "GT_HOMREF",
    "GT_HET",
    "GT_HOMALT",
    "GT_MISSING",
    "GT_AC",
    "GT_NOBS",
    # derived float variables (bcftools'-tags flavor: AF/MAF/F_MISSING/HWE)
    "GT_AF",
    "GT_MAF",
    "GT_MISSING_RATE",
    "GT_HET_RATE",
    "GT_HWE_P",
    "GT_HWE_MIDP",
)


def gt_variables(counts: np.ndarray, num_samples: int, used=None) -> dict:
    """Derive the expression variables from a (V, 4) count matrix.

    Integer counts plus derived float64 rates:
      GT_AF           alt-allele frequency  AC / (2*NOBS)   (0.0 if no calls)
      GT_MAF          min(AF, 1-AF)
      GT_MISSING_RATE MISSING / row total
      GT_HET_RATE     HET / NOBS                            (0.0 if no calls)
      GT_HWE_P        exact Hardy-Weinberg p (ops/hwe.py); meaningful on
                      the variant axis (per-sample it is a mechanical
                      function of that sample's code histogram)

    ``used`` (a set of names or None=all) gates which derived variables
    are materialized — GT_HWE_P is the only one with nontrivial cost.
    """
    homref, het, homalt, missing = (counts[:, k].astype(np.int64) for k in range(4))
    ac = het + 2 * homalt
    nobs = num_samples - missing
    out = {
        "GT_HOMREF": homref,
        "GT_HET": het,
        "GT_HOMALT": homalt,
        "GT_MISSING": missing,
        "GT_AC": ac,
        "GT_NOBS": nobs,
    }

    def want(name):
        return used is None or name in used

    if want("GT_AF") or want("GT_MAF"):
        with np.errstate(divide="ignore", invalid="ignore"):
            af = np.where(nobs > 0, ac / np.maximum(2 * nobs, 1), 0.0)
        if want("GT_AF"):
            out["GT_AF"] = af
        if want("GT_MAF"):
            out["GT_MAF"] = np.minimum(af, 1.0 - af)
    if want("GT_MISSING_RATE"):
        total = num_samples if num_samples else 1
        out["GT_MISSING_RATE"] = missing / total
    if want("GT_HET_RATE"):
        out["GT_HET_RATE"] = np.where(nobs > 0, het / np.maximum(nobs, 1), 0.0)
    if want("GT_HWE_P"):
        from pgen_tpu_torch.ops.hwe import hwe_exact_p

        out["GT_HWE_P"] = hwe_exact_p(counts)
    if want("GT_HWE_MIDP"):
        from pgen_tpu_torch.ops.hwe import hwe_exact_p

        out["GT_HWE_MIDP"] = hwe_exact_p(counts, midp=True)
    return out
