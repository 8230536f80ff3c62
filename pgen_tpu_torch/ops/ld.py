"""Banded linkage-disequilibrium r² and window-greedy pruning: the port of
``pgen_tpu/ops/ld.py``.

r²(i, j) for every variant pair with index distance <= band comes as a
dense (V, band) f64 matrix whose column d holds r²(i, i+1+d), from
mean-imputed centered dosages c (missing calls at the row's mean, 0):

    r(i, j) = <c_i, c_j> / (||c_i|| ||c_j||)

``banded_r2`` is pgen_tpu's ``banded_r2_device`` (:106) on one device. It
streams the records by blocks of whole tiles (``BLOCK_ROWS``, a multiple of
band) plus one tile of context, so a chromosome run's c never exists whole
(pgen_tpu decodes the whole run: 11 GB of f32 c at chr22's 1.1M x 2504, and
twice that in its windows). Per block, on ``device``:

  K15 ``ld_centered``  records -> (rows, K) f32 c and (rows,) f64 ||c||²
  tile Grams           tile t (band rows) against its window, the rows
                       [t band, t band + 2 band) of c: an overlapping
                       ``as_strided`` view, no copy; ``torch.bmm`` in full
                       fp32 (TF32 off), as pgen_tpu pins Precision.HIGHEST
  r² (f64)             the band entries of each Gram (a diagonal view),
                       den = norm_i norm_j, where(den > 0, (g / max(den,
                       1e-300))², 0): pgen_tpu's host elementwise operations
                       (:156-162), on the card
  past-the-end zeros   then one D2H of the block's (rows, band) f64 band

The last block pads with 0xFF rows (all missing: c and the norm are 0
there, so r² is 0). K15 (``csrc/genotype.cu:LdRows``, K11's three forms
with a per-row table {0 - m, 1 - m, 2 - m, 0}) replaces the Pallas unpack,
the cohort take and the centering of ``_tiles`` (:128-137); ||c||² comes
from the row's code counts in f64 (pgen_tpu's is an f32 sum of c²). Its
wrapper dispatches on the tensor's device with no fallback: a CUDA tensor
launches K15, a CPU tensor runs ``ld_centered_plain``.

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
from pgen_tpu_torch.ops.glm import code_hist, device_sel, kept_count, scratch_view, select_codes
from pgen_tpu_torch.ops.unpack import check_packed

# Output rows of a block, rounded down to a multiple of band (at least one
# tile); a block stages one more tile of context. At 2504 samples a block's
# c is 164 MB.
BLOCK_ROWS = 1 << 14
# f32 entries of the Grams one bmm makes: one 8,192-row tile (MAX_BAND) against
# its 16,384-row window, 512 MB. Smaller bands take several tiles a bmm.
GRAM_ENTRIES = 1 << 27


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


# ---- K15: records -> centered dosages and their squared norms ----


def ld_centered_plain(packed: torch.Tensor, num_samples: int, sel=None) -> tuple:
    """Plain PyTorch K15: (V, K) f32 centered dosages of the selected
    samples and (V,) f64 squared norms, in the kernel's arithmetic order:
    m = ac / max(n, 1) in f32, c = table[code] with table = {0 - m, 1 - m,
    2 - m, 0}, ||c||² = sum over codes 0-2 of count x t² in f64."""
    codes = select_codes(packed, num_samples, sel)
    hist = code_hist(codes)
    n_called = hist[:, 0] + hist[:, 1] + hist[:, 2]
    ac = hist[:, 1] + 2 * hist[:, 2]
    m = ac.float() / torch.clamp(n_called.float(), min=1.0)
    table = torch.stack([0.0 - m, 1.0 - m, 2.0 - m, torch.zeros_like(m)], 1)
    norm2 = torch.zeros(codes.shape[0], dtype=torch.float64, device=packed.device)
    for k in range(3):
        tk = table[:, k].double()
        norm2 = norm2 + hist[:, k].double() * (tk * tk)
    return table.gather(1, codes), norm2


def ld_centered(packed: torch.Tensor, num_samples: int, sel=None, out=None) -> tuple:
    """(V, R) u8 records -> (V, K) f32 mean-imputed centered dosages c of
    the selected samples (``sel``: a 1-D int32 tensor of ids in [0,
    num_samples); all S without it; missing calls 0) and (V,) f64 squared
    norms ||c||², on the input's device. ``out`` is an optional flat f32
    device buffer for c."""
    n_var, rec = check_packed(packed, num_samples)
    n_kept = kept_count(packed, num_samples, sel)
    if packed.device.type == "cpu":
        return ld_centered_plain(packed, num_samples, sel)
    c = scratch_view(out, (n_var, n_kept), packed.device)
    if n_var == 0 or n_kept == 0:
        return c, torch.zeros(n_var, dtype=torch.float64, device=packed.device)
    norm2 = torch.empty(n_var, dtype=torch.float64, device=packed.device)  # every row is written
    rows = torch.empty((3, n_var), dtype=torch.int32, device=packed.device)  # chunked-form sums
    launch(ld_centered, "pgen_ld_centered", packed,
           packed.data_ptr(), None if sel is None else sel.data_ptr(), c.data_ptr(),
           norm2.data_ptr(), rows.data_ptr(), n_var, rec, num_samples, n_kept)
    return c, norm2


ld_centered.launches = 0


# ---- the streamed band ----


def _tile_r2(c: torch.Tensor, norm: torch.Tensor, first: int, n_tiles: int,
             band: int) -> torch.Tensor:
    """(n_tiles, band, band) f64 r² of tiles [first, first + n_tiles) of a
    staged block: [t, i, d] = r²(row t band + i, row t band + i + 1 + d)."""
    n_kept = c.shape[1]
    base = first * band
    tiles = c[base : base + n_tiles * band].view(n_tiles, band, n_kept)
    # tile t's window: rows [t band, t band + 2 band), overlapping views of c
    windows = c.as_strided((n_tiles, 2 * band, n_kept), (band * n_kept, n_kept, 1),
                           c.storage_offset() + base * n_kept)
    with full_fp32():
        gram = torch.bmm(tiles, windows.transpose(1, 2))  # (n_tiles, band, 2 band)
    # [t, i, d] = gram[t, i, i + 1 + d]: a diagonal view, no gather
    g = gram.as_strided((n_tiles, band, band), (2 * band * band, 2 * band + 1, 1),
                        gram.storage_offset() + 1).double()
    norm_i = norm[base : base + n_tiles * band].view(n_tiles, band, 1)
    norm_j = norm.as_strided((n_tiles, band, band), (band, 1, 1), norm.storage_offset() + base + 1)
    den = norm_i * norm_j
    x = g / torch.clamp(den, min=1e-300)
    return torch.where(den > 0, x * x, 0.0)


def banded_r2(packed, num_samples: int, band: int, device, sample_idx=None,
              block_rows: int = BLOCK_ROWS) -> np.ndarray:
    """pgen_tpu's ``banded_r2_device`` on ``device`` (``"cuda"`` or
    ``"cpu"``, the kernels' plain versions): (V, R) u8 records (a memory map
    is read block by block) -> (V, band) f64, [i, d] = r²(i, i+1+d) over the
    samples of ``sample_idx`` (all S without it); 0 past the end and where
    either norm is 0."""
    nvar, rec = packed.shape
    out = np.zeros((nvar, band), dtype=np.float64)
    if nvar == 0 or band == 0:
        return out
    dev = resolve_device(device)
    sel = device_sel(sample_idx, num_samples, dev)
    n_kept = num_samples if sel is None else sel.shape[0]
    rows = max(1, block_rows // band) * band
    most = min(rows, -(-nvar // band) * band) + band  # staged rows of the largest block
    staging = torch.empty((most, rec), dtype=torch.uint8, pin_memory=dev.type == "cuda")
    staged = staging.numpy()
    scratch = (torch.empty(most * n_kept, dtype=torch.float32, device=dev)
               if dev.type == "cuda" else None)
    group = max(1, GRAM_ENTRIES // (2 * band * band))  # tiles a bmm
    offsets = 1 + torch.arange(band, device=dev)
    for lo in range(0, nvar, rows):
        n_out = min(rows, nvar - lo)
        n_tiles = -(-n_out // band)
        height = (n_tiles + 1) * band
        hi = min(lo + height, nvar)
        np.copyto(staged[: hi - lo], packed[lo:hi])
        staged[hi - lo : height] = 0xFF  # all missing: c and its norm 0
        block = staging[:height].to(dev, non_blocking=True)
        c, norm2 = ld_centered(block, num_samples, sel, out=scratch)
        norm = torch.sqrt(norm2)
        r2 = torch.empty((n_tiles, band, band), dtype=torch.float64, device=dev)
        for t in range(0, n_tiles, group):
            k = min(group, n_tiles - t)
            r2[t : t + k] = _tile_r2(c, norm, t, k, band)
        r2 = r2.view(n_tiles * band, band)[:n_out]
        past = (lo + torch.arange(n_out, device=dev)[:, None] + offsets[None, :]) >= nvar
        out[lo : lo + n_out] = r2.masked_fill(past, 0.0).cpu().numpy()
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
