"""Per-variant linear association (GWAS) on the GPU: the port of
``pgen_tpu/ops/glm.py``.

For each variant, ordinary least squares of the phenotype on [1,
covariates, dosage] over its complete cases (plink2 ``--glm``). Every
normal-equation entry is a masked sum over samples, so one block of
variants needs only products of (V, K) f32 planes with small (K, P)
column matrices, then batched f64 solves on the host:

  glm_moments       X1  mask @ P, dosage @ [y, C]        -> glm_solve
  glm_geno_moments  X2  mask @ P, het @ q2, hom @ q2     -> glm_solve_modifier
  glm_int_moments   X3  mask @ P, g @ P, g^2 @ P         -> glm_solve_interaction

Each is a blocked loop over a staged (V, R) record matrix (``stage_blocks``,
pinned when the device is CUDA). Per block K10 (``glm_planes``,
``csrc/genotype.cu:glm_planes_kernel``) decodes the records straight into
the planes and each row's code histogram, and ``torch.matmul`` in full fp32
(``matmul_fp32``; in f64 for X3, see ``glm_int_moments``) makes the
products, as pgen_tpu makes them with
``jnp.matmul(precision=HIGHEST)`` after its Pallas unpack. The planes'
device memory is allocated once per call. ``n``, ``sum g`` and ``sum g^2``
come from the histogram: integers, exact in both packages, so the
estimable gate and with it the NA pattern are pgen_tpu's. The wrapper
dispatches on the tensor's device with no fallback: a CUDA tensor launches
K10, a CPU tensor runs ``glm_planes_plain``.

``glm_moments_mesh`` and ``glm_geno_moments_mesh`` are pgen_tpu's mesh
steps (``build_glm_mesh_step``, :359, ``build_glm_geno_mesh_step``, :664)
over the ranks of a process group: each rank makes the moments of its own
rows, and where pgen_tpu leaves per-variant outputs sharded, one
all_gather a field brings every rank's rows in rank order, so the solve
and the table run as in one process.

The host half (the NamedTuples, ``_centered``, ``_moment_columns``,
``_geno_moment_inputs``, the modifier tables, the three solves and the
Student-t tail ``_lgamma``/``betainc_reg``/``t_sf2``) is carried over from
``pgen_tpu/ops/glm.py`` unchanged in substance. It is jax-free, but it lives
in a module that imports jax at module level, and the port must run where
jax is not installed, so it is copied rather than imported. The tests pin
each copy equal to pgen_tpu's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pgen_tpu_torch.device import matmul_fp32, resolve_device
from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.gt_stats import stage_blocks
from pgen_tpu_torch.ops.unpack import check_packed, check_sel, unpack_codes_plain
from pgen_tpu_torch.parallel.mesh import all_gather_rows

# Rows per staged block: pgen_tpu's device default (ops/glm.py:199, 739, 1051).
DEFAULT_BLOCK_VARIANTS = 1 << 14
# K10 and K11 count codes in 16-bit fields per thread and pgen_tpu's f32 sums
# of 0/1/2/4 are exact below 2^24; this many kept samples keeps both safe.
MAX_KEPT = 1 << 22

# K10 look-up tables, one row per plane, indexed by code (0/0, 0/1, 1/1, ./.).
# A missing call is 0 in every plane.
LUT_MOMENTS = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, 2.0, 0.0))  # mask, g (X1)
LUT_GENO = (  # mask, het, hom (X2)
    (1.0, 1.0, 1.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
)
LUT_INT = (  # mask, g, g^2 (X3)
    (1.0, 1.0, 1.0, 0.0), (0.0, 1.0, 2.0, 0.0), (0.0, 1.0, 4.0, 0.0),
)


class GlmMoments(NamedTuple):
    """Per-variant complete-case moments (all f64, host-side)."""

    n: np.ndarray  # (V,) called count
    mp: np.ndarray  # (V, P) masked sums M @ P  (P = moment columns)
    gq: np.ndarray  # (V, k+1) dosage sums G @ [y, C]
    sg: np.ndarray  # (V,) sum g
    sg2: np.ndarray  # (V,) sum g^2


class GlmResult(NamedTuple):
    n_obs: np.ndarray  # (V,) i64 complete-case count
    beta: np.ndarray  # (V,) f64, NaN where unestimable
    se: np.ndarray  # (V,) f64
    t_stat: np.ndarray  # (V,) f64
    p: np.ndarray  # (V,) f64


def _centered(y: np.ndarray, covars: np.ndarray):
    """Shift y and each covariate to cohort mean zero before building the
    moment columns. The dosage BETA/SE/T are invariant to these shifts
    (the intercept absorbs them, per-variant complete-case subsets
    included), while the moment magnitudes drop by orders of magnitude —
    this is what keeps the f32 device accumulation well conditioned for
    large-magnitude covariates (e.g. birth years ~2000). Applied in every
    provider so cross-provider moment-parity holds."""
    yc = y - y.mean() if y.size else y
    cc = covars - covars.mean(axis=0) if covars.size else covars
    return yc, cc


def _moment_columns(y: np.ndarray, covars: np.ndarray) -> np.ndarray:
    """(S, P) columns whose masked sums fill the normal equations:
    [1, c_1..c_k, y, y^2, y*c_i..., upper-tri c_i*c_j...]."""
    s = y.shape[0]
    k = covars.shape[1]
    cols = [np.ones(s), *(covars[:, i] for i in range(k)), y, y * y]
    cols += [y * covars[:, i] for i in range(k)]
    for i in range(k):
        for j in range(i, k):
            cols.append(covars[:, i] * covars[:, j])
    return np.stack(cols, axis=1)


# ---- K10: records -> the f32 operand planes and each row's code counts ----


def check_sample_ids(sample_idx, num_samples: int) -> None:
    """Raise IndexError for a sample id outside [0, num_samples): pgen_tpu
    cuts the codes to S before its take, so a pad slot is never a valid id
    (unlike K3/K5's ``check_sel_range``, which allows ids up to 4R)."""
    if sample_idx is None:
        return
    ids = sample_idx.cpu() if isinstance(sample_idx, torch.Tensor) else np.asarray(sample_idx)
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= num_samples):
        raise IndexError(f"sample ids must lie in [0, {num_samples})")


def select_codes(packed: torch.Tensor, num_samples: int, sel) -> torch.Tensor:
    """Plain PyTorch codes of the selected samples: (V, K) int64, K = S
    without ``sel``; duplicates allowed, as ``jnp.take`` allows them."""
    codes = unpack_codes_plain(packed, num_samples).long()
    if sel is None:
        return codes
    check_sample_ids(sel, num_samples)
    return codes[:, sel.long()]


def code_hist(codes: torch.Tensor) -> torch.Tensor:
    """(V, K) codes -> (V, 4) int32 counts of each code per row."""
    return torch.stack([(codes == c).sum(1, dtype=torch.int32) for c in range(4)], 1)


def glm_planes_plain(packed: torch.Tensor, num_samples: int, lut: torch.Tensor,
                     sel=None) -> tuple:
    """Plain PyTorch K10: (P, V, K) f32 planes lut[p][code] and (V, 4) int32
    code counts of the selected samples."""
    codes = select_codes(packed, num_samples, sel)
    return lut[:, codes].contiguous(), code_hist(codes)


def _check_lut(lut, packed: torch.Tensor) -> int:
    if not isinstance(lut, torch.Tensor) or lut.dtype != torch.float32:
        raise TypeError("lut must be a float32 torch.Tensor")
    if lut.dim() != 2 or lut.shape[0] not in (2, 3) or lut.shape[1] != 4:
        raise ValueError(f"lut must be (2 or 3, 4), got {tuple(lut.shape)}")
    if not lut.is_contiguous() or lut.device != packed.device:
        raise ValueError("lut must be contiguous and on packed's device")
    return lut.shape[0]


def kept_count(packed: torch.Tensor, num_samples: int, sel) -> int:
    """K, the selected samples of a K10/K11 call, checked against MAX_KEPT."""
    n_kept = num_samples if sel is None else check_sel(sel, packed)
    if n_kept > MAX_KEPT:
        raise ValueError(f"{n_kept} samples: at most {MAX_KEPT} per call")
    return n_kept


def scratch_view(out, shape: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A contiguous ``dtype`` tensor of ``shape``: the front of the flat
    buffer ``out`` when one is given (allocated once per call by the block
    loops), else a new one."""
    n = int(np.prod(shape))
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if out.dtype != dtype or out.device != device or out.numel() < n:
        raise ValueError(f"out must be {dtype} on {device} with at least {n} elements")
    return out.view(-1)[:n].view(shape)


def glm_planes(packed: torch.Tensor, num_samples: int, lut: torch.Tensor, sel=None,
               out=None) -> tuple:
    """(V, R) u8 records -> (P, V, K) f32 planes, planes[p][v][j] =
    lut[p][code of sample sel[j] (or j) in row v], and (V, 4) int32 counts
    of the K selected codes of each row, on the input's device. ``lut`` is
    (P, 4) f32, P = 2 or 3; ``sel`` a 1-D int32 tensor of ids in
    [0, num_samples); ``out`` an optional flat f32 device buffer for the
    planes. Each plane is a row-major (V, K) matrix, so planes[p] @ cols
    needs no copy."""
    n_var, rec = check_packed(packed, num_samples)
    n_planes = _check_lut(lut, packed)
    n_kept = kept_count(packed, num_samples, sel)
    if packed.device.type == "cpu":
        return glm_planes_plain(packed, num_samples, lut, sel)
    planes = scratch_view(out, (n_planes, n_var, n_kept), packed.device)
    if n_var == 0 or n_kept == 0:
        return planes, torch.zeros((n_var, 4), dtype=torch.int32, device=packed.device)
    hist = torch.empty((n_var, 4), dtype=torch.int32, device=packed.device)  # every row is written
    launch(glm_planes, "pgen_glm_planes", packed,
           packed.data_ptr(), None if sel is None else sel.data_ptr(), lut.data_ptr(),
           planes.data_ptr(), hist.data_ptr(), n_var, rec, num_samples, n_kept, n_planes)
    return planes, hist


glm_planes.launches = 0


def device_sel(sample_idx, num_samples: int, dev: torch.device):
    """The cohort's sample ids, range-checked, as an int32 tensor on dev
    (None for every sample)."""
    check_sample_ids(sample_idx, num_samples)
    if sample_idx is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(sample_idx, dtype=np.int32)).to(dev)


# Rows of a plane cast to f64 at a time for an f64 product: a bound scratch
# (2,048 x 2,504 x 8 B = 41 MB) instead of a second, twice as large plane.
F64_CHUNK_ROWS = 1 << 11


def _matmul_fp64(plane: torch.Tensor, cols: torch.Tensor, scratch: torch.Tensor) -> torch.Tensor:
    """``plane @ cols`` in f64: (V, K) f32 plane, (K, C) f64 columns ->
    (V, C) f64. The plane is cast in chunks of F64_CHUNK_ROWS rows through
    ``scratch`` (at least F64_CHUNK_ROWS * K f64 values on the plane's
    device)."""
    n_var, n_kept = plane.shape
    out = torch.empty((n_var, cols.shape[1]), dtype=torch.float64, device=plane.device)
    for r0 in range(0, n_var, F64_CHUNK_ROWS):
        r1 = min(r0 + F64_CHUNK_ROWS, n_var)
        wide = scratch[: (r1 - r0) * n_kept].view(r1 - r0, n_kept)
        wide.copy_(plane[r0:r1])
        torch.matmul(wide, cols, out=out[r0:r1])
    return out


def _plane_products(packed, num_samples: int, lut, products, device,
                    block_variants: int, sample_idx, fp64: bool = False) -> tuple:
    """The blocked scan shared by the three moment functions: per staged
    block, K10's planes and counts, then planes[p] @ cols for each
    (p, cols) of ``products``, in full fp32 or, with ``fp64``, in f64 (the
    planes hold 0/1/2/4 exactly, so an f64 product carries only the f64
    rounding of its sum). Returns the (V, 4) int64 code counts and the
    (V, cols) f64 products."""
    dev = resolve_device(device)
    n_var = packed.shape[0]
    sel = device_sel(sample_idx, num_samples, dev)
    n_kept = num_samples if sel is None else sel.shape[0]
    lut_t = torch.tensor(lut, dtype=torch.float32, device=dev)
    col_type = np.float64 if fp64 else np.float32
    cols = [(p, torch.from_numpy(np.ascontiguousarray(c, dtype=col_type)).to(dev))
            for p, c in products]
    rows = min(block_variants, n_var)
    scratch = (torch.empty(len(lut) * rows * n_kept, dtype=torch.float32, device=dev)
               if dev.type == "cuda" else None)
    wide = (torch.empty(min(rows, F64_CHUNK_ROWS) * n_kept, dtype=torch.float64, device=dev)
            if fp64 else None)
    hist = np.empty((n_var, 4), dtype=np.int64)
    outs = [np.empty((n_var, c.shape[1]), dtype=np.float64) for _, c in cols]
    for lo, hi, block in stage_blocks(packed, dev, block_variants):
        planes, h = glm_planes(block, num_samples, lut_t, sel, out=scratch)
        hist[lo:hi] = h.cpu().numpy()
        for o, (p, c) in zip(outs, cols):
            prod = _matmul_fp64(planes[p], c, wide) if fp64 else matmul_fp32(planes[p], c)
            o[lo:hi] = prod.cpu().numpy()
    return hist, outs


def _row_sums(hist: np.ndarray) -> tuple:
    """n, sum g and sum g^2 of each row from its code counts (exact)."""
    n = hist[:, :3].sum(axis=1).astype(np.float64)
    sg = (hist[:, 1] + 2 * hist[:, 2]).astype(np.float64)
    sg2 = (hist[:, 1] + 4 * hist[:, 2]).astype(np.float64)
    return n, sg, sg2


def _check_cohort(y: np.ndarray, covars: np.ndarray, num_samples: int, sample_idx) -> None:
    ns = num_samples if sample_idx is None else len(sample_idx)
    if y.shape != (ns,) or covars.ndim != 2 or covars.shape[0] != ns:
        raise ValueError(f"glm: y {y.shape} / covars {covars.shape} do not match {ns} samples")


def glm_moments(packed, num_samples: int, y, covars, device,
                block_variants: int = DEFAULT_BLOCK_VARIANTS, sample_idx=None) -> GlmMoments:
    """X1 on ``device``: pgen_tpu's ``glm_moments_device``. (V, R) u8
    records (a memory map is read block by block), y (K,), covars (K, k)
    over the K samples of ``sample_idx`` (all S without it) -> f64
    GlmMoments."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    _check_cohort(y, covars, num_samples, sample_idx)
    y, covars = _centered(y, covars)
    pcols = _moment_columns(y, covars)
    q = np.concatenate([y[:, None], covars], axis=1)
    if packed.shape[0] == 0:
        z = np.zeros(0)
        return GlmMoments(z, np.zeros((0, pcols.shape[1])), np.zeros((0, q.shape[1])), z, z)
    hist, (mp, gq) = _plane_products(packed, num_samples, LUT_MOMENTS, [(0, pcols), (1, q)],
                                     device, block_variants, sample_idx)
    n, sg, sg2 = _row_sums(hist)
    return GlmMoments(n, mp, gq, sg, sg2)


def glm_moments_mesh(packed, num_samples: int, y, covars, device,
                     block_variants: int = DEFAULT_BLOCK_VARIANTS, sample_idx=None,
                     timer=None) -> GlmMoments:
    """pgen_tpu's ``glm_moments_mesh`` over the ranks of the default process
    group: ``packed`` is this rank's shard of the rows (zero rows give zero
    rows), and every rank gets the moments of every rank's rows in rank
    order, one all_gather a field (``timer``'s)."""
    m = glm_moments(packed, num_samples, y, covars, device, block_variants, sample_idx)
    return GlmMoments(*all_gather_rows(m, resolve_device(device), timer))


def glm_solve(moments: GlmMoments, num_covars: int) -> GlmResult:
    """Assemble and solve the per-variant (k+2)-dim normal equations in
    f64; Student-t p-values via the regularized incomplete beta.

    Moment column layout (matches _moment_columns):
      mp[:, 0]            = n        (== moments.n, kept for symmetry)
      mp[:, 1 : 1+k]      = sum c_i
      mp[:, 1+k]          = sum y
      mp[:, 2+k]          = sum y^2
      mp[:, 3+k : 3+2k]   = sum y c_i
      mp[:, 3+2k : ]      = sum c_i c_j  (upper triangle, row-major)
    """
    k = num_covars
    n = moments.n
    nvar = n.shape[0]
    d = k + 2  # [1, c_1..c_k, g]
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 2), dtype=np.float64)  # [X^T y | e_g]
    mp, gq, sg, sg2 = moments.mp, moments.gq, moments.sg, moments.sg2
    sc = mp[:, 1 : 1 + k]
    sy = mp[:, 1 + k]
    syy = mp[:, 2 + k]
    syc = mp[:, 3 + k : 3 + 2 * k]
    a[:, 0, 0] = n
    a[:, 0, 1 : 1 + k] = sc
    a[:, 1 : 1 + k, 0] = sc
    pos = 3 + 2 * k
    for i in range(k):
        for j in range(i, k):
            a[:, 1 + i, 1 + j] = mp[:, pos]
            a[:, 1 + j, 1 + i] = mp[:, pos]
            pos += 1
    a[:, 0, d - 1] = sg
    a[:, d - 1, 0] = sg
    a[:, 1 : 1 + k, d - 1] = gq[:, 1:].reshape(nvar, k)
    a[:, d - 1, 1 : 1 + k] = gq[:, 1:].reshape(nvar, k)
    a[:, d - 1, d - 1] = sg2
    rhs[:, 0, 0] = sy
    rhs[:, 1 : 1 + k, 0] = syc
    rhs[:, d - 1, 0] = gq[:, 0]
    rhs[:, d - 1, 1] = 1.0

    df = n - d
    # estimable gate: enough complete cases + complete-case dosage variance
    with np.errstate(invalid="ignore", divide="ignore"):
        gvar = sg2 - np.where(n > 0, sg * sg / np.maximum(n, 1), 0.0)
    ok = (df >= 1) & (gvar > 1e-9 * np.maximum(n, 1))
    beta = np.full(nvar, np.nan)
    se = np.full(nvar, np.nan)
    t = np.full(nvar, np.nan)
    p = np.full(nvar, np.nan)
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 2), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs, zg = sol[..., 0], sol[..., 1]
        bsel = coefs[:, d - 1]
        # residual SS = y'y - beta' X'y;  Var(beta_g) = sigma^2 (A^-1)_gg
        rss = syy[idx] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            var_g = sigma2 * zg[:, d - 1]
            s = np.sqrt(var_g)
            tt = bsel / s
            pp = t_sf2(tt, df[idx])
        # s > 0 NA's exact fits (rss == 0 -> SE 0, T inf) like plink2
        good = ok[idx] & np.isfinite(s) & (s > 0) & (zg[:, d - 1] > 0)
        beta[idx] = np.where(good, bsel, np.nan)
        se[idx] = np.where(good, s, np.nan)
        t[idx] = np.where(good, tt, np.nan)
        p[idx] = np.where(good, pp, np.nan)
    return GlmResult(n.astype(np.int64), beta, se, t, p)


def glm_linear(packed, num_samples: int, y, covars, device, **kw) -> GlmResult:
    """Full per-variant OLS: X1 moments on ``device``, batched f64 solve and
    t-test on the host."""
    y = np.asarray(y, dtype=np.float64)
    covars = (
        np.zeros((y.shape[0], 0)) if covars is None
        else np.asarray(covars, dtype=np.float64)
    )
    if covars.ndim != 2 or covars.shape[0] != y.shape[0]:
        raise ValueError(f"glm: covars must be (S, k), got {covars.shape}")
    m = glm_moments(packed, num_samples, y, covars, device, **kw)
    return glm_solve(m, covars.shape[1])


# ---- model modifiers: dominant / recessive / genotypic / hethom ----
#
# plink2 `--glm genotypic|hethom|dominant|recessive` analogs. Every
# modified design's genotype columns are linear combinations of the HET
# (g==1) and HOM-ALT (g==2) indicator columns, and indicators satisfy
# het^2 = het, hom^2 = hom, het*hom = 0 — so ONE extra masked-moment
# block pair (HET @ q2, HOM @ q2 with q2 = [1, y, C]) supplies every
# normal-equation entry of every modifier, including the 2-df designs.
# The (het, hom) weights per genotype column:

MODIFIER_COLS = {
    "dominant": ((1.0, 1.0),),              # DOM  = 1{g >= 1}
    "recessive": ((0.0, 1.0),),             # REC  = 1{g == 2}
    "genotypic": ((1.0, 2.0), (1.0, 0.0)),  # ADD  + DOMDEV (het)
    "hethom": ((0.0, 1.0), (1.0, 0.0)),     # HOM  + HET
}
MODIFIER_TESTS = {
    "dominant": ("DOM",),
    "recessive": ("REC",),
    "genotypic": ("ADD", "DOMDEV"),
    "hethom": ("HOM", "HET"),
}
JOINT_TEST_NAME = "GENO_2DF"


def _geno_moment_inputs(y, covars, dtype=np.float64):
    """Shared preamble for every geno-moments provider: centered y/C,
    the M-block moment columns, and the het/hom-block columns
    q2 = [1, y, C]. The q2 LAYOUT is load-bearing — glm_solve_modifier
    indexes hetq/homq as [:,0]=sum, [:,1]=*y, [:,2:]=@C."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    yc, cc = _centered(y, covars)
    pcols = _moment_columns(yc, cc).astype(dtype)
    q2 = np.concatenate(
        [np.ones((yc.shape[0], 1)), yc[:, None], cc], axis=1
    ).astype(dtype)
    return pcols, q2


class GlmGenoMoments(NamedTuple):
    """Indicator-decomposed per-variant moments (f64, host-side).

    q2 layout: [1, y, c_1..c_k] so hetq[:, 0] = sum het,
    hetq[:, 1] = sum het*y, hetq[:, 2:] = het @ C (same for homq)."""

    n: np.ndarray    # (V,) called count
    mp: np.ndarray   # (V, P) masked sums M @ moment columns
    hetq: np.ndarray  # (V, k+2) het-indicator sums
    homq: np.ndarray  # (V, k+2) hom-indicator sums


class GlmModResult(NamedTuple):
    """Per-variant modifier fit; test axis follows MODIFIER_TESTS."""

    n_obs: np.ndarray    # (V,) i64
    beta: np.ndarray     # (V, T) f64, NaN where unestimable
    se: np.ndarray       # (V, T)
    t_stat: np.ndarray   # (V, T)
    p: np.ndarray        # (V, T)
    joint_stat: np.ndarray | None  # (V,) F statistic (2-df designs)
    joint_p: np.ndarray | None     # (V,)

def glm_geno_moments(packed, num_samples: int, y, covars, device,
                     block_variants: int = DEFAULT_BLOCK_VARIANTS,
                     sample_idx=None) -> GlmGenoMoments:
    """X2 on ``device``: pgen_tpu's ``glm_geno_moments(provider="device")``,
    the mask, het and hom indicator moments of the modifier designs."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    _check_cohort(y, covars, num_samples, sample_idx)
    pcols, q2 = _geno_moment_inputs(y, covars)
    if packed.shape[0] == 0:
        z = np.zeros(0)
        return GlmGenoMoments(z, np.zeros((0, pcols.shape[1])),
                              np.zeros((0, q2.shape[1])), np.zeros((0, q2.shape[1])))
    hist, (mp, hetq, homq) = _plane_products(
        packed, num_samples, LUT_GENO, [(0, pcols), (1, q2), (2, q2)],
        device, block_variants, sample_idx,
    )
    return GlmGenoMoments(_row_sums(hist)[0], mp, hetq, homq)


def glm_geno_moments_mesh(packed, num_samples: int, y, covars, device,
                          block_variants: int = DEFAULT_BLOCK_VARIANTS, sample_idx=None,
                          timer=None) -> GlmGenoMoments:
    """pgen_tpu's ``glm_geno_moments_mesh``, the modifier designs' moments
    over the ranks as ``glm_moments_mesh``'s."""
    m = glm_geno_moments(packed, num_samples, y, covars, device, block_variants, sample_idx)
    return GlmGenoMoments(*all_gather_rows(m, resolve_device(device), timer))


def glm_solve_modifier(
    moments: GlmGenoMoments, num_covars: int, modifier: str
) -> GlmModResult:
    """Assemble and solve the per-variant modified-design normal
    equations in f64 ([1, C, g_1(, g_2)]); for the 2-df designs also
    run the covariate-only fit per variant and report the joint F test
    (plink2 GENO_2DF)."""
    cols = MODIFIER_COLS[modifier]
    k = num_covars
    nt = len(cols)
    d = k + 1 + nt
    n = moments.n
    nvar = n.shape[0]
    mp, hetq, homq = moments.mp, moments.hetq, moments.homq
    sc = mp[:, 1 : 1 + k]
    sy = mp[:, 1 + k]
    syy = mp[:, 2 + k]
    syc = mp[:, 3 + k : 3 + 2 * k]
    sh, sho = hetq[:, 0], homq[:, 0]
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 1 + nt), dtype=np.float64)
    a[:, 0, 0] = n
    a[:, 0, 1 : 1 + k] = sc
    a[:, 1 : 1 + k, 0] = sc
    pos = 3 + 2 * k
    for i in range(k):
        for j in range(i, k):
            a[:, 1 + i, 1 + j] = mp[:, pos]
            a[:, 1 + j, 1 + i] = mp[:, pos]
            pos += 1
    rhs[:, 0, 0] = sy
    rhs[:, 1 : 1 + k, 0] = syc
    gsum = []
    for t, (a1, a2) in enumerate(cols):
        j = k + 1 + t
        sg_t = a1 * sh + a2 * sho
        gsum.append(sg_t)
        a[:, 0, j] = sg_t
        a[:, j, 0] = sg_t
        gc_t = a1 * hetq[:, 2:] + a2 * homq[:, 2:]
        a[:, 1 : 1 + k, j] = gc_t
        a[:, j, 1 : 1 + k] = gc_t
        rhs[:, j, 0] = a1 * hetq[:, 1] + a2 * homq[:, 1]
        rhs[:, j, 1 + t] = 1.0
        for u, (b1, b2) in enumerate(cols):
            # indicator algebra: het*hom == 0, het^2 == het, hom^2 == hom
            a[:, j, k + 1 + u] = a1 * b1 * sh + a2 * b2 * sho

    df = n - d
    ok = df >= 1
    # each genotype column needs complete-case variance
    with np.errstate(invalid="ignore", divide="ignore"):
        for t, (a1, a2) in enumerate(cols):
            sq_t = a1 * a1 * sh + a2 * a2 * sho
            gv = sq_t - np.where(n > 0, gsum[t] ** 2 / np.maximum(n, 1), 0.0)
            ok &= gv > 1e-9 * np.maximum(n, 1)
    if nt == 2:
        # non-collinear columns (e.g. no hom-ref calls makes ADD ~ const
        # + DOMDEV): Gram determinant of the centered pair
        with np.errstate(invalid="ignore", divide="ignore"):
            c00 = a[:, k + 1, k + 1] - gsum[0] ** 2 / np.maximum(n, 1)
            c11 = a[:, k + 2, k + 2] - gsum[1] ** 2 / np.maximum(n, 1)
            c01 = a[:, k + 1, k + 2] - gsum[0] * gsum[1] / np.maximum(n, 1)
        ok &= (c00 * c11 - c01 * c01) > 1e-9 * np.maximum(n, 1)
    beta = np.full((nvar, nt), np.nan)
    se = np.full((nvar, nt), np.nan)
    tt_out = np.full((nvar, nt), np.nan)
    p = np.full((nvar, nt), np.nan)
    joint_f = np.full(nvar, np.nan) if nt == 2 else None
    joint_p = np.full(nvar, np.nan) if nt == 2 else None
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 1 + nt), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs = sol[..., 0]
        rss = syy[idx] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            for t in range(nt):
                j = k + 1 + t
                zjj = sol[:, j, 1 + t]
                b = coefs[:, j]
                s = np.sqrt(sigma2 * zjj)
                tv = b / s
                pv = t_sf2(tv, df[idx])
                good = ok[idx] & np.isfinite(s) & (s > 0) & (zjj > 0)
                beta[idx, t] = np.where(good, b, np.nan)
                se[idx, t] = np.where(good, s, np.nan)
                tt_out[idx, t] = np.where(good, tv, np.nan)
                p[idx, t] = np.where(good, pv, np.nan)
        if nt == 2:
            # covariate-only RSS for the joint 2-df F test
            d0 = k + 1
            a0 = a[idx][:, :d0, :d0]
            r0 = rhs[idx][:, :d0, :1]
            try:
                sol0 = np.linalg.solve(a0, r0)[..., 0]
            except np.linalg.LinAlgError:
                sol0 = np.full((idx.size, d0), np.nan)
                for r in range(idx.size):
                    try:
                        sol0[r] = np.linalg.solve(a0[r], r0[r, :, 0])
                    except np.linalg.LinAlgError:
                        pass
            rss0 = syy[idx] - np.einsum("vi,vi->v", sol0, r0[..., 0])
            rss0 = np.maximum(rss0, 0.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                f = ((rss0 - rss) / 2.0) / sigma2
                f = np.maximum(f, 0.0)
                x = df[idx] / (df[idx] + 2.0 * f)
                pj = np.asarray(betainc_reg(df[idx] / 2.0, 1.0, x))
            good = ok[idx] & np.isfinite(f) & (sigma2 > 0)
            joint_f[idx] = np.where(good, f, np.nan)
            joint_p[idx] = np.where(good, pj, np.nan)
    return GlmModResult(
        n.astype(np.int64), beta, se, tt_out, p, joint_f, joint_p
    )


def glm_linear_modifier(packed, num_samples: int, y, covars, modifier: str, device,
                        **kw) -> GlmModResult:
    """Full per-variant modified-design OLS (plink2 --glm
    genotypic/hethom/dominant/recessive, linear model)."""
    if modifier not in MODIFIER_COLS:
        raise ValueError(f"glm: unknown modifier {modifier!r}")
    y = np.asarray(y, dtype=np.float64)
    covars = (
        np.zeros((y.shape[0], 0)) if covars is None
        else np.asarray(covars, dtype=np.float64)
    )
    m = glm_geno_moments(packed, num_samples, y, covars, device, **kw)
    return glm_solve_modifier(m, covars.shape[1], modifier)


# ---- interaction model: [1, C, g, g*C] (plink2 --glm interaction) ----


class GlmIntMoments(NamedTuple):
    """Per-variant complete-case moments for the interaction design.

    Three (V, P) masked-moment blocks over the SAME column set P =
    _moment_columns(y, covars) = [1, c, y, y^2, y*c, c_i*c_j]:
      mp  = M  @ P   (mask-weighted sums)
      gp  = G  @ P   (dosage-weighted)
      g2p = G^2 @ P  (dosage^2-weighted)
    Together these hold every entry of the (2k+2)-dim normal equations —
    one extra gemm per block vs the plain model."""

    n: np.ndarray
    mp: np.ndarray
    gp: np.ndarray
    g2p: np.ndarray


class GlmIntResult(NamedTuple):
    """Per-variant, per-test arrays; test axis = [ADD, ADDxC1..ADDxCk]."""

    n_obs: np.ndarray   # (V,) i64
    beta: np.ndarray    # (V, 1+k) f64, NaN where unestimable
    se: np.ndarray      # (V, 1+k)
    t_stat: np.ndarray  # (V, 1+k)
    p: np.ndarray       # (V, 1+k)

def glm_int_moments(packed, num_samples: int, y, covars, device,
                    block_variants: int = DEFAULT_BLOCK_VARIANTS,
                    sample_idx=None) -> GlmIntMoments:
    """X3 on ``device``: pgen_tpu's ``glm_int_moments(provider="device")``,
    the mask, dosage and dosage^2 moments of the interaction design.

    The three products run in f64, unlike X1's and X2's fp32. The ADD term
    is reported at covariates 0: beta_g minus the covariate means times the
    ADDxC betas, a difference of terms up to the means' size larger than
    itself, so the f32 rounding of the moment columns and of the sums over
    the cohort (about 2,500 terms) left BETA outside pgen_tpu's rtol 2e-4
    on the card at 50,000 variants. The f64 sums cost three more passes
    over the planes per block and hold it on both devices."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    _check_cohort(y, covars, num_samples, sample_idx)
    yc, cc = _centered(y, covars)
    pcols = _moment_columns(yc, cc)
    if packed.shape[0] == 0:
        z = np.zeros(0)
        zp = np.zeros((0, pcols.shape[1]))
        return GlmIntMoments(z, zp, zp.copy(), zp.copy())
    hist, (mp, gp, g2p) = _plane_products(
        packed, num_samples, LUT_INT, [(0, pcols), (1, pcols), (2, pcols)],
        device, block_variants, sample_idx, fp64=True,
    )
    return GlmIntMoments(_row_sums(hist)[0], mp, gp, g2p)


def glm_solve_interaction(
    moments: GlmIntMoments, num_covars: int, covar_means=None
) -> GlmIntResult:
    """Assemble and solve the per-variant (2k+2)-dim normal equations
    for the design [1, c_1..c_k, g, g*c_1..g*c_k]; report each dosage
    term (ADD and every ADDxC_i) with its own SE / t / p.

    covar_means: the cohort means subtracted by _centered() before the
    moments were built. Centering c changes the ADD coefficient's
    MEANING (g*(c - m) = g*c - m*g, and g is in the design, so the fit
    is identical but beta_g shifts by sum_i m_i * beta_gci); plink2
    reports the RAW parameterization, so ADD's beta and SE are
    recovered through the linear map w = e_g - sum_i m_i e_gci using
    the already-solved A^-1 unit columns (interaction coefficients and
    their SEs are invariant to the shift). Pass None when the moments
    were built from already-raw covariates."""
    k = num_covars
    n = moments.n
    nvar = n.shape[0]
    d = 2 * k + 2
    ntest = k + 1

    # P-column index helpers (layout of _moment_columns)
    def ic(i):
        return 1 + i

    iy = k + 1
    iyy = k + 2

    def iyc(i):
        return k + 3 + i

    def icc(i, j):
        if i > j:
            i, j = j, i
        return 2 * k + 3 + i * k - i * (i - 1) // 2 + (j - i)

    mp, gp, g2p = moments.mp, moments.gp, moments.g2p
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 1 + ntest), dtype=np.float64)
    a[:, 0, 0] = n
    a[:, 0, k + 1] = gp[:, 0]
    a[:, k + 1, k + 1] = g2p[:, 0]
    rhs[:, 0, 0] = mp[:, iy]
    rhs[:, k + 1, 0] = gp[:, iy]
    for i in range(k):
        a[:, 0, 1 + i] = mp[:, ic(i)]
        a[:, 0, k + 2 + i] = gp[:, ic(i)]
        a[:, 1 + i, k + 1] = gp[:, ic(i)]
        a[:, k + 1, k + 2 + i] = g2p[:, ic(i)]
        rhs[:, 1 + i, 0] = mp[:, iyc(i)]
        rhs[:, k + 2 + i, 0] = gp[:, iyc(i)]
        for j in range(k):
            if j >= i:
                a[:, 1 + i, 1 + j] = mp[:, icc(i, j)]
                a[:, k + 2 + i, k + 2 + j] = g2p[:, icc(i, j)]
            a[:, 1 + i, k + 2 + j] = gp[:, icc(i, j)]
    # symmetrize: only the upper triangle + diagonal were filled, so add
    # the transpose with its diagonal zeroed (entries can be negative —
    # covariates are centered — so an elementwise max would be wrong)
    at = np.transpose(a, (0, 2, 1)).copy()
    di = np.arange(d)
    at[:, di, di] = 0.0
    a = a + at
    # unit columns select the tested coefficients' (A^-1)_jj
    for t in range(ntest):
        rhs[:, k + 1 + t, 1 + t] = 1.0

    df = n - d
    sg, sg2 = gp[:, 0], g2p[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        gvar = sg2 - np.where(n > 0, sg * sg / np.maximum(n, 1), 0.0)
    ok = (df >= 1) & (gvar > 1e-9 * np.maximum(n, 1))
    beta = np.full((nvar, ntest), np.nan)
    se = np.full((nvar, ntest), np.nan)
    tt_out = np.full((nvar, ntest), np.nan)
    p = np.full((nvar, ntest), np.nan)
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 1 + ntest), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs = sol[..., 0]
        rss = mp[idx, iyy] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        means = (
            np.zeros(k) if covar_means is None
            else np.asarray(covar_means, dtype=np.float64)
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            for t in range(ntest):
                j = k + 1 + t
                if t == 0 and means.any():
                    # raw-parameterization ADD: beta_raw = w' beta,
                    # var = sigma^2 * w' A^-1 w with
                    # w = e_g - sum_i m_i e_gci
                    acol = sol[:, :, 1].copy()  # A^-1 e_g
                    for i in range(k):
                        acol -= means[i] * sol[:, :, 2 + i]
                    zjj = acol[:, k + 1].copy()
                    b = coefs[:, k + 1].copy()
                    for i in range(k):
                        zjj -= means[i] * acol[:, k + 2 + i]
                        b -= means[i] * coefs[:, k + 2 + i]
                else:
                    zjj = sol[:, j, 1 + t]
                    b = coefs[:, j]
                s = np.sqrt(sigma2 * zjj)
                tv = b / s
                pv = t_sf2(tv, df[idx])
                good = ok[idx] & np.isfinite(s) & (s > 0) & (zjj > 0)
                beta[idx, t] = np.where(good, b, np.nan)
                se[idx, t] = np.where(good, s, np.nan)
                tt_out[idx, t] = np.where(good, tv, np.nan)
                p[idx, t] = np.where(good, pv, np.nan)
    return GlmIntResult(n.astype(np.int64), beta, se, tt_out, p)


def glm_linear_interaction(packed, num_samples: int, y, covars, device,
                           **kw) -> GlmIntResult:
    """Full per-variant interaction OLS (plink2 --glm interaction, linear):
    X3 moments on ``device``, batched f64 solves."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if covars.ndim != 2 or covars.shape[0] != y.shape[0]:
        raise ValueError(f"glm: covars must be (S, k), got {covars.shape}")
    if covars.shape[1] == 0:
        raise ValueError(
            "glm --interaction needs at least one covariate (the "
            "interaction terms are dosage x covariate)"
        )
    m = glm_int_moments(packed, num_samples, y, covars, device, **kw)
    return glm_solve_interaction(
        m, covars.shape[1], covar_means=covars.mean(axis=0)
    )


# ---- Student-t survival function (exact, f64, no scipy dependency) ----

# Lanczos g=7, n=9 coefficients (Boost/GSL-standard; ~1e-15 relative)
_LANCZOS = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def _lgamma(z):
    """Vectorized log-gamma for z > 0 (Lanczos approximation, f64)."""
    z = np.asarray(z, dtype=np.float64)
    zm1 = z - 1.0
    x = np.full(z.shape, _LANCZOS[0])
    for i in range(1, 9):
        x = x + _LANCZOS[i] / (zm1 + i)
    t = zm1 + 7.5
    return 0.5 * np.log(2.0 * np.pi) + (zm1 + 0.5) * np.log(t) - t + np.log(x)


def betainc_reg(a, b, x, max_iter: int = 300, eps: float = 3e-16):
    """Regularized incomplete beta I_x(a, b), vectorized f64.

    Continued fraction (Lentz), with the standard symmetry switch at
    x > (a+1)/(a+b+2) for convergence. Matches jax.scipy.special.betainc
    to ~1e-14 (asserted in tests)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, b, x = np.broadcast_arrays(a, b, x)
    out = np.empty(x.shape, dtype=np.float64)
    flat_a, flat_b, flat_x = a.ravel(), b.ravel(), x.ravel()
    res = np.empty(flat_x.shape)
    lo = flat_x <= 0
    hi = flat_x >= 1
    res[lo] = 0.0
    res[hi] = 1.0
    mid = ~(lo | hi)
    if mid.any():
        aa, bb, xx = flat_a[mid], flat_b[mid], flat_x[mid]
        swap = xx > (aa + 1.0) / (aa + bb + 2.0)
        a_ = np.where(swap, bb, aa)
        b_ = np.where(swap, aa, bb)
        x_ = np.where(swap, 1.0 - xx, xx)
        front = np.exp(
            _lgamma(a_ + b_) - _lgamma(a_) - _lgamma(b_)
            + a_ * np.log(x_) + b_ * np.log1p(-x_)
        ) / a_
        # Lentz's algorithm, active-set compressed: converged elements are
        # retired each iteration so the per-iteration work tracks only the
        # slow tail (most entries converge in << max_iter iterations)
        tiny = 1e-300
        c = np.ones_like(x_)
        d = 1.0 - (a_ + b_) * x_ / (a_ + 1.0)
        d = np.where(np.abs(d) < tiny, tiny, d)
        d = 1.0 / d
        h = d.copy()
        h_final = np.empty_like(h)
        idx = np.arange(h.size)
        for m_i in range(1, max_iter + 1):
            m2 = 2 * m_i
            num = m_i * (b_ - m_i) * x_ / ((a_ + m2 - 1.0) * (a_ + m2))
            d = 1.0 + num * d
            d = np.where(np.abs(d) < tiny, tiny, d)
            c = 1.0 + num / c
            c = np.where(np.abs(c) < tiny, tiny, c)
            d = 1.0 / d
            h *= d * c
            num = -(a_ + m_i) * (a_ + b_ + m_i) * x_ / (
                (a_ + m2) * (a_ + m2 + 1.0)
            )
            d = 1.0 + num * d
            d = np.where(np.abs(d) < tiny, tiny, d)
            c = 1.0 + num / c
            c = np.where(np.abs(c) < tiny, tiny, c)
            d = 1.0 / d
            delta = d * c
            h *= delta
            conv = np.abs(delta - 1.0) < eps
            if conv.any():
                h_final[idx[conv]] = h[conv]
                if conv.all():
                    break
                keep = ~conv
                idx, h, c, d = idx[keep], h[keep], c[keep], d[keep]
                a_, b_, x_ = a_[keep], b_[keep], x_[keep]
        else:
            h_final[idx] = h  # unconverged tail: best effort
        val = front * h_final
        res[mid] = np.where(swap, 1.0 - val, val)
    out.ravel()[:] = res
    return out


def t_sf2(t, df):
    """Two-sided Student-t p-value: P(|T_df| >= |t|) =
    I_{df/(df+t^2)}(df/2, 1/2).

    At df >= 1e8 the continued fraction's argument x = df/(df+t^2) sits
    within ~1e-8 of 1 and the Lentz iteration loses ~7 digits, while the
    normal limit's relative error is O(t^4/df) <= ~1e-6 at t <= 100 —
    strictly tighter there, so switch to erfc(|t|/sqrt(2))."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    x = df / (df + t * t)
    out = np.asarray(betainc_reg(df / 2.0, 0.5, x))
    big = np.broadcast_to(df >= 1e8, out.shape)
    if big.any():
        from pgen_tpu_torch.ops.logistic_host import normal_sf2

        tb = np.broadcast_to(t, out.shape)
        out = np.where(big, normal_sf2(tb), out)
    return out
