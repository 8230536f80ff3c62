"""Banded linkage-disequilibrium r² and window-greedy pruning: the port of
``pgen_tpu/ops/ld.py``.

r²(i, j) for every variant pair with index distance <= band comes as a
dense (V, band) f64 matrix whose column d holds r²(i, i+1+d), from
mean-imputed centered dosages c (missing calls at the row's mean, 0):

    r(i, j) = <c_i, c_j> / (||c_i|| ||c_j||)

``banded_r2`` is pgen_tpu's ``banded_r2_device`` (:106) on one device. It
streams the records by blocks of ``BLOCK_ROWS`` output rows plus the band
rows after them, so a chromosome run's dosages never exist (pgen_tpu decodes
the whole run: 11 GB of f32 c at chr22's 1.1M x 2504, and twice that in its
windows). Per block, on ``device``:

  K5 ``subset_repack``  a cohort's samples re-packed, when there is one
  K15 ``ld_r2_band``    records -> the block's (rows, band) f64 r², in one
                        kernel: each pair's dot of centered dosages from
                        exact AND-POPC counts of the rows' bit planes, each
                        row's mean and norm from its code counts
                        (``csrc/genotype.cu:ld_r2_band_kernel``)
  one D2H of the band; rows past the end are all missing, so r² is 0 there

r² = <c_i, c_j>² / (||c_i||² ||c_j||²) with c the mean-imputed centered
dosage (m = ac / max(n, 1) in f32, as pgen_tpu's device mean). K15's first
form wrote c in f32 for fp32 ``torch.bmm`` tile Grams; its dot now comes from
integer counts in f64 (``ld_r2_band_plain`` gives the formula), so a pair's
r² no longer depends on the block it lies in. The wrapper dispatches on the
tensor's device with no fallback: a CUDA tensor launches K15, a CPU tensor
runs ``ld_r2_band_plain``.

``centered_dosage_np``, ``banded_r2_reference``, ``banded_r2_numpy``,
``_take_band`` and ``greedy_prune`` are copied from pgen_tpu (``:40``,
``:52``, ``:68``, ``:97``, ``:179``), whose module imports jax inside its
device function; only the imports differ. Their spec, from pgen_tpu:

Window-greedy prune (host, sequential by definition): plink's window/step
walk over the precomputed band. For each window start s (s = 0, step,
2*step, ...), candidate pairs are the in-band pairs (i, j) with s <= i <
j < s+window whose r² exceeds the threshold, visited in lexicographic
order; if both are still alive, the one with the LOWER MAF is removed
(tie: the later variant). Removal never changes other pairs' r², so
precomputed values stay valid. Monomorphic variants (zero variance) have
undefined r; they are never pruned (r treated as 0).
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.device import full_fp32, resolve_device
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.glm import code_hist, device_sel, scratch_view, select_codes
from pgen_tpu_torch.ops.pack import subset_repack
from pgen_tpu_torch.ops.unpack import check_packed, unpack_codes_plain

# Output rows of a block: 131 MB of r² at band 1,000, 1 GB at MAX_BAND
# (pipeline/prune.py), as the tile form before it held.
BLOCK_ROWS = 1 << 14
# Output rows of a chunk of the plain version's Grams: the band's width
# (so few off-band entries are computed), within these limits.
PLAIN_ROWS = (32, 256)


def centered_dosage_np(codes: np.ndarray):
    """(W, S) u8 codes -> (c, norm): mean-imputed centered dosage rows
    (f64) and their L2 norms. Missing entries sit at the mean (0)."""
    called = codes != 3
    g = codes.astype(np.float64) * called
    n_called = called.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p2 = np.where(n_called > 0, g.sum(axis=1) / np.maximum(n_called, 1), 0.0)
    c = (g - p2[:, None]) * called
    return c, np.sqrt((c * c).sum(axis=1))


def banded_r2_reference(codes: np.ndarray, band: int) -> np.ndarray:
    """Brute-force oracle: (V, band) with [i, d] = r²(i, i+1+d)."""
    nvar = codes.shape[0]
    c, norm = centered_dosage_np(codes)
    out = np.zeros((nvar, band), dtype=np.float64)
    for i in range(nvar):
        for d in range(band):
            j = i + 1 + d
            if j >= nvar:
                break
            den = norm[i] * norm[j]
            if den > 0:
                out[i, d] = (c[i] @ c[j]) ** 2 / (den * den)
    return out


def banded_r2_numpy(
    packed: np.ndarray, num_samples: int, band: int, sample_idx=None
) -> np.ndarray:
    """Tiled-gemm band: tile rows x their 2*band-row slice, f64."""
    from pgen_tpu_torch.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    out = np.zeros((nvar, band), dtype=np.float64)
    if nvar == 0 or band == 0:
        return out
    # one standardize pass per tile slice would recompute rows band/band
    # times; rows are cheap vs the gemm, so recompute per slice for
    # simplicity and O(band) working memory
    for t0 in range(0, nvar, band):
        hi = min(t0 + 2 * band, nvar)
        codes = unpack_codes_numpy(packed[t0:hi], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        c, norm = centered_dosage_np(codes)
        w = min(band, nvar - t0)
        gram = c[:w] @ c.T  # (w, hi-t0)
        den = norm[:w, None] * norm[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(den > 0, (gram / np.maximum(den, 1e-300)) ** 2, 0.0)
        out[t0 : t0 + w] = _take_band(r2, band)
    return out


def _take_band(r2: np.ndarray, band: int) -> np.ndarray:
    """(w, L) pairwise matrix -> (w, band) with [i, d] = r2[i, i+1+d]
    (0 past the matrix edge) — one fancy-index diagonal gather."""
    w, L = r2.shape
    cols = np.arange(w)[:, None] + 1 + np.arange(band)[None, :]
    valid = cols < L
    return np.where(valid, r2[np.arange(w)[:, None], np.minimum(cols, L - 1)], 0.0)


# ---- K15: records -> the banded r² ----


def _row_table(hist: torch.Tensor) -> tuple:
    """(V, 3 or 4) code counts -> the rows' (V,) f32 means m = ac / max(n, 1), the
    (V, 4) f32 tables {0 - m, 1 - m, 2 - m, 0} of c by code and the (V,) f64
    squared norms ||c||² = sum over codes 0-2 of count x t² in f64, each
    product and sum rounded on its own."""
    n_called = hist[:, 0] + hist[:, 1] + hist[:, 2]
    ac = hist[:, 1] + 2 * hist[:, 2]
    m = ac.float() / torch.clamp(n_called.float(), min=1.0)
    table = torch.stack([0.0 - m, 1.0 - m, 2.0 - m, torch.zeros_like(m)], 1)
    norm2 = torch.zeros(hist.shape[0], dtype=torch.float64, device=hist.device)
    for k in range(3):
        tk = table[:, k].double()
        norm2 = norm2 + hist[:, k].double() * (tk * tk)
    return m, table, norm2


def ld_centered_plain(packed: torch.Tensor, num_samples: int, sel=None) -> tuple:
    """(V, K) f32 centered dosages c of the selected samples and (V,) f64
    squared norms: c = table[code] of ``_row_table``, 0 on a missing call.
    K15's first form wrote this c; ``ld_r2_band_plain`` takes its m and
    norms."""
    codes = select_codes(packed, num_samples, sel)
    _, table, norm2 = _row_table(code_hist(codes))
    return table.gather(1, codes), norm2


def _band_view(x: torch.Tensor, lo: int, n: int, band: int) -> torch.Tensor:
    """(n, band) view of the 1-D x: [r, d] = x[lo + r + 1 + d]."""
    return x.as_strided((n, band), (1, 1), x.storage_offset() + lo + 1)


def _plane_rows(packed: torch.Tensor, num_samples: int, height: int) -> tuple:
    """(2, height, S) f32 planes of the records' rows, the dosage x = H + 2 A
    (0 where missing) and V (called), rows past the records' end all
    missing; and the rows' (height, 3) code counts of 0, 1 and 2, from the
    planes' exact sums (x² = H + 4 A)."""
    codes = unpack_codes_plain(packed[:height], num_samples)
    planes = torch.zeros((2, height, num_samples), dtype=torch.float32, device=packed.device)
    rows = codes.shape[0]
    called = codes != 3
    planes[1, :rows] = called
    planes[0, :rows] = codes * called
    sx, sxx, n = planes[0].sum(1), (planes[0] * planes[0]).sum(1), planes[1].sum(1)
    c2 = (sxx - sx) / 2
    c1 = sx - 2 * c2
    return planes, torch.stack([n - c1 - c2, c1, c2], 1).long()


def _band_sums(planes: torch.Tensor, band: int, n_out: int):
    """For each chunk of output rows of ``_plane_rows``' planes: (lo, hi,
    (hi - lo, band, 4) int64 sums S_xx, S_xi, S_xj and N of rows [lo, hi)
    against their band), from one f32 Gram of the stacked planes a chunk,
    exact: integer sums under 4 S < 2^24."""
    step = min(max(band, PLAIN_ROWS[0]), PLAIN_ROWS[1])
    for lo in range(0, n_out, step):
        hi = min(lo + step, n_out)
        n, w = hi - lo, hi - lo + band
        with full_fp32():
            gram = torch.matmul(planes[:, lo:hi].reshape(2 * n, -1),
                                planes[:, lo : hi + band].reshape(2 * w, -1).T)
        # [r, d] of plane pair (p, q) = gram[p n + r, q w + r + 1 + d]
        sums = [gram.as_strided((n, band), (2 * w + 1, 1), 2 * w * n * p + w * q + 1)
                for p in (0, 1) for q in (0, 1)]
        yield lo, hi, torch.stack(sums, -1).round().long()


def ld_band_sums_plain(packed: torch.Tensor, num_samples: int, band: int,
                       n_out: int | None = None) -> torch.Tensor:
    """(n_out, band, 4) int64: for the pair (i, j = i + 1 + d), with x = H +
    2 A the dosage (H code 1, A code 2) and V called, the sums over the
    samples S_xx = sum x_i x_j, S_xi = sum x_i V_j, S_xj = sum V_i x_j and
    N = sum V_i V_j (the nine plane-pair counts HH + 2 HA + 2 AH + 4 AA,
    HV + 2 AV, VH + 2 VA and VV); a row at or past the records' end is all
    missing."""
    n_out = packed.shape[0] if n_out is None else n_out
    planes, _ = _plane_rows(packed, num_samples, n_out + band)
    sums = [s for _, _, s in _band_sums(planes, band, n_out)]
    if not sums:
        return torch.zeros((0, band, 4), dtype=torch.int64, device=packed.device)
    return torch.cat(sums)


def ld_r2_band_plain(packed: torch.Tensor, num_samples: int, band: int,
                     n_out: int | None = None) -> torch.Tensor:
    """Plain PyTorch K15: (n_out, band) f64, [i, d] = r²(i, i + 1 + d) over
    the S samples of the records (n_out: all rows without it; a row at or
    past their end is all missing). From the sums of ``ld_band_sums_plain``
    and m, ||c||² of ``_row_table``:
        dot = S_xx - m_j S_xi - m_i S_xj + m_i m_j N,
        r² = dot² / (||c_i||² ||c_j||²), 0 where that product is 0,
    each f64 operation in this order, as the kernel rounds them (no square
    root: torch's f64 sqrt on the CPU is not correctly rounded)."""
    n_rows = packed.shape[0]
    n_out = n_rows if n_out is None else n_out
    out = torch.zeros((n_out, band), dtype=torch.float64, device=packed.device)
    if n_out == 0 or band == 0:
        return out
    planes, hist = _plane_rows(packed, num_samples, n_out + band)
    m, _, norm2 = _row_table(hist)  # 0 for the rows past the end
    m = m.double()
    for lo, hi, sums in _band_sums(planes, band, n_out):
        sxx, sxi, sxj, n = sums.double().unbind(-1)
        mi, ni = m[lo:hi, None], norm2[lo:hi, None]
        mj, nj = _band_view(m, lo, hi - lo, band), _band_view(norm2, lo, hi - lo, band)
        den = ni * nj
        dot = sxx - mj * sxi
        dot = dot - mi * sxj
        dot = dot + (mi * mj) * n
        out[lo:hi] = torch.where(den > 0, (dot * dot) / den, 0.0)
    return out


def ld_r2_band(packed: torch.Tensor, num_samples: int, band: int, n_out: int | None = None,
               out=None) -> torch.Tensor:
    """(n_rows, R) u8 records of ``num_samples`` samples -> (n_out, band) f64
    r²: [i, d] = r²(i, i + 1 + d), rows at or past n_rows all missing (r²
    0), on the input's device. ``out`` is an optional flat f64 device buffer
    for the band (allocated once by ``banded_r2``)."""
    n_rows, rec = check_packed(packed, num_samples)
    n_out = n_rows if n_out is None else int(n_out)
    if band < 0 or n_out < 0:
        raise ValueError(f"band={band} and n_out={n_out} must be >= 0")
    if packed.device.type == "cpu":
        return ld_r2_band_plain(packed, num_samples, band, n_out)
    r2 = scratch_view(out, (n_out, band), packed.device, torch.float64)
    if n_out == 0 or band == 0:
        return r2
    if num_samples == 0:  # no sample: every norm is 0
        return r2.zero_()
    launch(ld_r2_band, "pgen_ld_r2_band", packed,
           packed.data_ptr(), r2.data_ptr(), n_rows, n_out, rec, num_samples, band)
    return r2


ld_r2_band.launches = 0


# ---- the streamed band ----


def banded_r2(packed, num_samples: int, band: int, device, sample_idx=None,
              block_rows: int = BLOCK_ROWS) -> np.ndarray:
    """pgen_tpu's ``banded_r2_device`` on ``device`` (``"cuda"`` or
    ``"cpu"``, the kernels' plain versions): (V, R) u8 records (a memory map
    is read block by block) -> (V, band) f64, [i, d] = r²(i, i+1+d) over the
    samples of ``sample_idx`` (all S without it, any order, repeats
    allowed); 0 past the end and where either norm is 0. The staging, the
    re-packed cohort and the band on the card are allocated once a call."""
    nvar, rec = packed.shape
    out = np.zeros((nvar, band), dtype=np.float64)
    if nvar == 0 or band == 0:
        return out
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sel = device_sel(sample_idx, num_samples, dev)
    n_kept = num_samples if sel is None else sel.shape[0]
    rows = min(max(1, block_rows), nvar)
    staging = torch.empty((min(rows + band, nvar), rec), dtype=torch.uint8, pin_memory=cuda)
    staged = staging.numpy()
    r2 = torch.empty(rows * band, dtype=torch.float64, device=dev) if cuda else None
    repacked = (torch.empty(staging.shape[0] * ((n_kept + 3) // 4), dtype=torch.uint8, device=dev)
                if cuda and sel is not None else None)
    for lo in range(0, nvar, rows):
        n_out = min(rows, nvar - lo)
        hi = min(lo + n_out + band, nvar)  # the rows the block's pairs read
        np.copyto(staged[: hi - lo], packed[lo:hi])
        block = staging[: hi - lo].to(dev, non_blocking=True)
        if sel is not None:
            block = subset_repack(block, sel, out=repacked)
        # the D2H into the output synchronises, so the staging is free again
        torch.from_numpy(out[lo : lo + n_out]).copy_(ld_r2_band(block, n_kept, band, n_out, r2))
    return out


def greedy_prune(
    r2_band: np.ndarray,
    maf: np.ndarray,
    window_counts: np.ndarray,
    step: int,
    threshold: float,
) -> np.ndarray:
    """The window/step greedy walk; returns the alive bool mask.

    window_counts[i] = window extent (in variants) when the window starts
    at i — a constant array for count windows, position-derived for kb
    windows. Pairs beyond the precomputed band are never candidates
    (callers size the band to the max window extent).
    """
    nvar, band = r2_band.shape
    alive = np.ones(nvar, dtype=bool)
    if nvar == 0:
        return alive
    # sparse exceed-pairs, lexicographic by construction
    ii, dd = np.nonzero(r2_band > threshold)
    jj = ii + 1 + dd
    for s in range(0, nvar, max(step, 1)):
        e = min(s + int(window_counts[s]), nvar)
        lo, hi = np.searchsorted(ii, (s, e))
        for k in range(lo, hi):
            i, j = ii[k], jj[k]
            if j >= e or not (alive[i] and alive[j]):
                continue
            # remove the lower-MAF member; tie removes the later variant
            victim = i if maf[i] < maf[j] else j
            alive[victim] = False
        if e >= nvar:
            break
    return alive
