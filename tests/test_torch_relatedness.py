"""The port's relatedness and PCA (pgen_tpu_torch.ops.relatedness, ops.king,
ops.ibd, ops.pca, pipeline.king/genome/pca and their CLI) against
pgen_tpu's device provider.

The port runs with device="cpu", where K12's and K13's plain PyTorch
versions make the planes and the standardized dosages (and K12's bits and
Grams, beside a numpy model of its two kernels); pgen_tpu runs its
device functions with the Pallas unpack in interpret mode, JAX on the CPU
(tests/test_king.py:48, tests/test_genome.py:47, tests/test_pca.py:63).
Filesets have planted structure: two populations with shifted allele
frequencies, two close relative pairs and 5% missing calls, so the top
eigenvectors are well separated. Tolerances: the king and ibd counts and
their tables exact (byte for byte); the GRM sums at rtol/atol 2e-5 with
m_used exact (tests/test_pca.py:65: pgen_tpu's f32 device GRM against its
f64 host one; the port's GRM is f64); --approx eigenvalues at rtol 1e-3
(tests/test_pca.py:265); .eigenvec/.eigenval at atol 5e-5
(tests/test_pca.py:176). The .rel.bin matrices are held at the GRM's 2e-5
too, pgen_tpu's being an f32 sum; the port's text and binary matrices
agree at 1e-9, as pgen_tpu's own do (tests/test_pca.py:197). z is held to ``_standardize_block_jnp`` at rtol
1e-6: XLA's rsqrt on the CPU is 1 ulp off a correctly rounded 1/sqrt in
about a third of values.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.cli import main as tpu_main
from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops import ibd as tpu_ibd
from pgen_tpu.ops import king as tpu_king
from pgen_tpu.ops import pca as tpu_pca
from pgen_tpu.ops.unpack import unpack_codes as tpu_unpack_codes
from pgen_tpu.pipeline import king as tpu_king_pipeline
from pgen_tpu_torch.cli import main as port_main
from pgen_tpu_torch.ops import ibd as port_ibd
from pgen_tpu_torch.ops import king as port_king
from pgen_tpu_torch.ops import pca as port_pca
from pgen_tpu_torch.ops.pack import subset_repack_plain
from pgen_tpu_torch.ops.relatedness import (
    GRAM_SETS,
    bits_shape,
    mirror_symmetric,
    plane_shape,
    relatedness_bits,
    relatedness_bits_plain,
    relatedness_gram,
    relatedness_gram_plain,
    relatedness_grams,
    relatedness_planes_plain,
)
from pgen_tpu_torch.pipeline import king as port_king_pipeline
from pgen_tpu_torch.pipeline.pca import pca as port_pca_entry
from test_torch_standalone import ARGV_TABLE

# S % 4 = 1, 2, 3, 0 and 1 again, one of them below 8
WIDTHS = [5, 14, 15, 16, 37]
COHORTS = ["all", "gap_dup", "reversed"]


def _planted_codes(n_var, n_samples, seed):
    """(V, S) codes: two populations (even and odd samples) with allele
    frequencies shifted apart, sample 1 a near copy of sample 0 and sample 3
    sharing half its calls with sample 2, then 5% of calls missing."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.85, n_var)
    shift = rng.uniform(-0.3, 0.3, n_var)
    p = np.clip(np.stack([base + shift, base - shift]), 0.02, 0.98)
    codes = rng.binomial(2, p[np.arange(n_samples) % 2].T).astype(np.uint8)
    if n_samples > 1:
        copy = rng.random(n_var) < 0.9
        codes[copy, 1] = codes[copy, 0]
    if n_samples > 3:
        half = rng.random(n_var) < 0.5
        codes[half, 3] = codes[half, 2]
    codes[rng.random(codes.shape) < 0.05] = 3
    return codes


def _fileset(tmp_path, n_var, n_samples, seed, name="rel"):
    codes = _planted_codes(n_var, n_samples, seed)
    pvar = [f"1\t{100 + 10 * i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(n_var)]
    psam = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(n_samples)]
    return build_fileset(tmp_path, name, codes, pvar, psam), codes


def _packed(codes, tmp_path):
    """The records of ``codes`` as written to a .pgen (pad slots zero),
    then 256 rows that each repeat one byte value (pad slots included)."""
    path = tmp_path / "pk.pgen"
    write_pgen(str(path), codes)
    rec = (codes.shape[1] + 3) // 4
    body = np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)
    return np.concatenate([body, np.repeat(np.arange(256, dtype=np.uint8)[:, None], rec, 1)])


def _cohort(kind, n_samples):
    if kind == "all":
        return None
    if kind == "reversed":
        return np.arange(n_samples - 1, -1, -1, dtype=np.int32)
    ids = np.flatnonzero(np.arange(n_samples) % 3 != 1)  # a gap, then a duplicate
    return np.concatenate([ids, ids[:1]]).astype(np.int32)


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_king_and_ibd_counts_match_pgen_tpu_device(tmp_path, n_samples, kind):
    """Every Gram exactly pgen_tpu's, in ragged blocks (300 + 256 rows in
    blocks of 64 here, 128 there)."""
    packed = _packed(_planted_codes(300, n_samples, n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    got = port_king.king_counts_device(packed, n_samples, "cpu", block_variants=64,
                                       sample_idx=idx)
    want = tpu_king.king_counts_device(packed, n_samples, block_variants=128, interpret=True,
                                       sample_idx=idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = port_ibd.ibd_counts_device(packed, n_samples, "cpu", block_variants=64,
                                     sample_idx=idx)
    want = tpu_ibd.ibd_counts_device(packed, n_samples, block_variants=128, interpret=True,
                                     sample_idx=idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_grm_device_matches_pgen_tpu_device(tmp_path, n_samples, kind):
    packed = _packed(_planted_codes(300, n_samples, 50 + n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    got = port_pca.grm_device(packed, n_samples, "cpu", block_variants=100, sample_idx=idx)
    want = tpu_pca.grm_device(packed, n_samples, block_variants=64, interpret=True,
                              sample_idx=idx)
    assert got.m_used == want.m_used
    np.testing.assert_allclose(got.grm_sum, want.grm_sum, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_samples", [16, 37])
def test_pca_approx_matches_pgen_tpu_device(tmp_path, n_samples):
    """The same seeded start subspace, the same iterations: eigenvalues at
    rtol 1e-3, leading eigenvectors aligned."""
    packed = _packed(_planted_codes(400, n_samples, 7), tmp_path)
    got = port_pca.pca_approx(packed, n_samples, 2, "cpu", block_variants=128, iters=8, seed=3)
    want = tpu_pca.pca_approx(packed, n_samples, 2, provider="device", block_variants=128,
                              iters=8, seed=3)
    assert got.m_used == want.m_used
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-3)
    for c in range(2):
        assert abs(float(got.eigenvectors[:, c] @ want.eigenvectors[:, c])) > 1 - 1e-4


def _approx_pass_pair(packed, n_samples, kind):
    """pgen_tpu's _approx_pass_jit (interpret mode) and the port's pass,
    block by block (a cohort re-packed by K5's plain version first, as the
    pass loop does), on the same records and q, from y = 0: (the port's y
    and used, pgen_tpu's, the re-packed records, n_kept, q)."""
    import jax.numpy as jnp

    idx = _cohort(kind, n_samples)
    n_kept = n_samples if idx is None else len(idx)
    q = np.random.default_rng(n_samples).standard_normal((n_kept, 6)).astype(np.float32)
    want_y, want_m = tpu_pca._approx_pass_jit(
        jnp.asarray(packed), jnp.asarray(q), None if idx is None else jnp.asarray(idx),
        n_samples, 128, True)
    records = torch.from_numpy(packed)
    if idx is not None:
        records = subset_repack_plain(records, torch.from_numpy(idx))
    y = torch.zeros((n_kept, 6), dtype=torch.float32)
    used = torch.zeros((), dtype=torch.int64)
    qt = torch.from_numpy(q)
    for lo in range(0, packed.shape[0], 128):
        port_pca.pca_approx_pass(records[lo : lo + 128], n_kept, qt, y, used)
    return (y, used), (torch.from_numpy(np.array(want_y)), int(want_m)), records, n_kept, qt


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_pca_approx_pass_plain_matches_approx_pass_jit(tmp_path, n_samples, kind):
    """K13's plain pass against pgen_tpu's _approx_pass_jit: the used count
    exact, y within approx_pass_tolerance with z_ulps = 1 (XLA's rsqrt on
    the CPU is 1 ulp off the port's correctly rounded 1/sqrt in a third of
    the rows)."""
    packed = _packed(_planted_codes(300, n_samples, n_samples + 2), tmp_path)
    (y, used), (want_y, want_m), records, n_kept, q = _approx_pass_pair(packed, n_samples, kind)
    assert int(used) == want_m > 0
    tol = port_pca.approx_pass_tolerance(records, n_kept, q, torch.zeros_like(y), z_ulps=1)
    assert bool(((y.double() - want_y.double()).abs() <= tol).all())


@pytest.mark.parametrize("fault", ["half the rows", "a block of rows", "y0 dropped",
                                   "a column shifted"])
def test_approx_pass_tolerance_fails_planted_faults(tmp_path, fault):
    """The tolerance is tight enough to see a wrong pass: against pgen_tpu's
    y, from a y0 at the scale of y, a pass that dropped half the rows, one
    128-row block, or y0, or shifted its columns by one, lies outside it;
    the right pass lies inside."""
    packed = _packed(_planted_codes(512, 37, 41), tmp_path)
    (y, _), (want_y, _), records, n_kept, q = _approx_pass_pair(packed, 37, "all")
    y0 = torch.from_numpy(np.random.default_rng(5).standard_normal(y.shape).astype(np.float32))
    y0 *= float(want_y.std())
    want = (y0.double() + want_y.double())
    tol = port_pca.approx_pass_tolerance(records, n_kept, q, y0, z_ulps=1)
    got = y0 + y
    assert bool(((got.double() - want).abs() <= tol).all())
    used = torch.zeros((), dtype=torch.int64)
    rows = {"half the rows": records[:256],
            "a block of rows": torch.cat([records[:128], records[256:]])}.get(fault)
    if rows is not None:
        got = y0.clone()
        port_pca.pca_approx_pass(rows, n_kept, q, got, used)
    elif fault == "y0 dropped":
        got = y.clone()
    else:
        got = got.roll(1, 1)
    assert bool(((got.double() - want).abs() > tol).any())


def _tpu_codes(packed, n_samples, idx):
    import jax.numpy as jnp

    codes = np.asarray(tpu_unpack_codes(jnp.asarray(packed), n_samples, interpret=True))
    return codes if idx is None else codes[:, idx]


@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_relatedness_planes_plain_match_pgen_tpu_planes(tmp_path, n_samples, kind):
    """K12's plain planes, transposed, are pgen_tpu's bf16 indicator planes
    H, R, A, C of the cohort (king.py:163-166), and 0 past them."""
    packed = _packed(_planted_codes(41, n_samples, n_samples), tmp_path)
    idx = _cohort(kind, n_samples)
    codes = _tpu_codes(packed, n_samples, idx)
    sel = None if idx is None else torch.from_numpy(idx)
    planes = relatedness_planes_plain(torch.from_numpy(packed), n_samples, sel).numpy()
    n_var, n_kept = codes.shape
    assert planes.shape == (4, *plane_shape(n_var, n_kept)) and planes.dtype == np.int8
    assert planes.shape[1] > 16 and planes.shape[1] % 8 == 0 and planes.shape[2] % 16 == 0
    for p, want in enumerate((codes == 1, codes == 0, codes == 2, codes != 3)):
        np.testing.assert_array_equal(planes[p, :n_kept, :n_var], want.T.astype(np.int8))
    assert not planes[:, n_kept:].any() and not planes[:, :, n_var:].any()


# -- K12's two kernels: a numpy model of each, held to pgen_tpu --------------

K12_SOURCE = Path(port_king.__file__).resolve().parent.parent / "csrc" / "genotype.cu"
K12_STEP, K12_PAD = 256, 128
# csrc's Gram kernel's block: warps 2 (rows) x kRelWC (columns), a warp
# kRelMT m-tiles of 16 by kRelNT n-tiles of 8, two products a block
K12_WR, K12_WC, K12_MT, K12_NT, K12_G = 2, 4, 4, 4, 2
UPPER, STORE, SWAP = range(3)
H_, R_, A_, C_ = range(4)
# csrc's rel_product: (x, y, gram, mode) of king's (0) and genome's (1) set
K12_PRODUCTS = (
    ((H_, H_, 0, UPPER), (C_, C_, 3, UPPER), (R_, A_, 1, STORE), (A_, R_, 1, SWAP),
     (H_, C_, 2, STORE), (C_, H_, 2, SWAP)),
    ((H_, H_, 0, UPPER), (C_, C_, 4, UPPER), (R_, A_, 1, STORE), (A_, R_, 1, SWAP),
     (R_, R_, 2, UPPER), (A_, A_, 3, UPPER)),
)
LANES = np.arange(32)
G_OF, T_OF = LANES // 4, LANES % 4


def test_k12_constants_match_the_source():
    source = K12_SOURCE.read_text()
    assert f"constexpr int kRelStep = {K12_STEP};" in source
    assert f"constexpr int kRelPad = {K12_PAD};" in source
    assert f"constexpr int kRelWC = {K12_WC}, kRelMT = {K12_MT}, kRelNT = {K12_NT};" in source
    assert f"constexpr int kRelThreads = {K12_WR} * kRelWC * kWarp;" in source
    assert f"constexpr int kRelTile = 16 * {K12_WR} * kRelMT;" in source
    # a block's products: the pair kFirst, kFirst + 1 of blockIdx.y
    assert f"constexpr int kRelPairs = kRelProducts / {K12_G};" in source
    assert f"constexpr int kCount = {K12_G}," in source
    for y in range(6 // K12_G):
        assert f"rel_gram_tile<kSet, {K12_G * y}>(a, ti, tj, smem);" in source
    names = {UPPER: "kRelUpper", STORE: "kRelStore", SWAP: "kRelSwap"}
    planes = "HRAC"
    for products in K12_PRODUCTS:
        for i, (x, y, gram, mode) in enumerate(products):
            case = f"case {i}" if i < 5 else "default"
            assert (f"{case}: return {{{planes[x]}, {planes[y]}, {gram}, {names[mode]}}};"
                    in source)
    assert GRAM_SETS == (port_king.KING_GRAMS, port_ibd.IBD_GRAMS)


def _transpose32(x):
    """transpose32 of csrc in numpy: x (..., 32 lanes) u32 -> lane c's bit r
    is bit c of lane r, by five swaps of off-diagonal blocks."""
    x = x.astype(np.uint32)
    for j, keep in zip((16, 8, 4, 2, 1), (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                                          0x55555555)):
        y = x[..., LANES ^ j]
        keep, drop = np.uint32(keep), np.uint32(~keep & 0xFFFFFFFF)
        x = np.where(LANES & j, (x & drop) | ((y & drop) >> np.uint32(j)),
                     (x & keep) | ((y & keep) << np.uint32(j)))
    return x


def _model_bits(packed, n_samples, seed=0):
    """relatedness_bits_kernel in numpy: a warp a group of 16 samples and a
    k-step; lane l's record word of row 256 k + 32 w + l at byte 4 grp (the
    bytes past its row whatever follows there: random here; rows past V
    0xFF), each word of rows transposed (lane 2 r + p: plane p of sample r),
    lane (g, t) taking by shuffles words t and t + 4 of samples g and g + 8
    in each plane; samples at or past S set to code 3 by count."""
    n_var, rec = packed.shape
    _, groups, steps, _ = bits_shape(n_var, n_samples)
    buf = np.random.default_rng(seed).integers(0, 256, (steps * K12_STEP, 4 * groups + 4),
                                               dtype=np.uint8)
    buf[n_var:] = 0xFF
    buf[:n_var, :rec] = packed
    x = np.ascontiguousarray(buf[:, : 4 * groups]).view("<u4")  # (V_pad, groups)
    out = np.zeros((2, groups, steps, 32, 4), dtype=np.uint32)
    for k in range(steps):
        for w in range(8):
            rows = x[k * K12_STEP + 32 * w : k * K12_STEP + 32 * w + 32]  # (lanes, groups)
            col = _transpose32(rows.T)  # (groups, lanes)
            keep = T_OF == w % 4
            for half in range(2):
                for p in range(2):
                    word = col[:, 2 * (G_OF + 8 * half) + p]  # the shuffle
                    dst = out[p, :, k]  # (groups, lanes, entries)
                    dst[:, keep, half + 2 * (w // 4)] = word[:, keep]
    sample = 16 * np.arange(groups)[:, None, None] + G_OF[None, :, None] + 8 * (
        np.arange(4)[None, None, :] & 1)  # (groups, lanes, e)
    out[:, np.broadcast_to((sample >= n_samples)[:, None], (groups, steps, 32, 4))] = 0xFFFFFFFF
    return out.reshape(2, groups, steps, 128)


def _decoded(bits):
    """(2, S_pad, V_pad) 0/1 of the model's or the plain version's bits."""
    b = np.asarray(bits).view(np.uint32)
    _, groups, steps, _ = b.shape
    words = b.reshape(2, groups, steps, 8, 4, 2, 2).transpose(0, 1, 6, 3, 2, 5, 4)
    words = words.reshape(2, groups * 16, steps * 8)
    return ((words[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        2, groups * 16, steps * K12_STEP)


def _cohort_records(packed, n_samples, kind):
    """The records K12 sees: all samples, or the cohort's re-packed by K5's
    plain version (pad bits zero: code 0, hom-ref, unless counted out)."""
    idx = _cohort(kind, n_samples)
    if idx is None:
        return packed, n_samples, idx
    return subset_repack_plain(torch.from_numpy(packed), torch.from_numpy(idx)).numpy(), len(idx), idx


@pytest.mark.parametrize("n_var", [1, 255, 256, 257, 297])
@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_relatedness_bits_plain_match_numpy_model(tmp_path, n_samples, kind, n_var):
    """K12's plain bits equal the numpy model of its transposer, at V = 1,
    255, 256, 257 and 297 (the byte-value rows, 0xFF among them, from row
    41 on), the cohort's records re-packed; each sample's planes are its
    codes, and every pad slot, pad sample and pad row reads code 3."""
    packed = _packed(_planted_codes(41, n_samples, n_samples), tmp_path)[:n_var]
    rows, n_kept, idx = _cohort_records(packed, n_samples, kind)
    got = relatedness_bits_plain(torch.from_numpy(rows), n_kept)
    assert tuple(got.shape) == bits_shape(n_var, n_kept) and got.dtype == torch.int32
    want = _model_bits(rows, n_kept, n_var)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    planes = _decoded(want)
    codes = _tpu_codes(packed, n_samples, idx)
    np.testing.assert_array_equal(planes[0, :n_kept, :n_var] + 2 * planes[1, :n_kept, :n_var],
                                  codes.T)
    assert planes[:, n_kept:].all() and planes[:, :, n_var:].all()
    assert relatedness_bits(torch.from_numpy(rows), n_kept).equal(got)  # the CPU route


def _plane(p, lo, hi):
    """Indicator plane p (H, R, A, C) of lo and hi words."""
    return (lo & ~hi, ~(lo | hi), hi & ~lo, ~(lo & hi))[p]


def _mma_and_popc(a, b0, b1):
    """mma.sync m16n8k256 .b1 AND-POPC of a warp, by its fragment layout:
    a (32, 4) (a0, a2 row g, a1, a3 row g + 8; words t and t + 4), b0, b1
    (32,) (column g, words t and t + 4) -> d (32, 4) (rows g, g + 8 x
    columns 2 t, 2 t + 1)."""
    rows = np.zeros((16, 8), dtype=np.uint32)
    rows[G_OF, T_OF], rows[G_OF + 8, T_OF] = a[:, 0], a[:, 1]
    rows[G_OF, T_OF + 4], rows[G_OF + 8, T_OF + 4] = a[:, 2], a[:, 3]
    cols = np.zeros((8, 8), dtype=np.uint32)
    cols[G_OF, T_OF], cols[G_OF, T_OF + 4] = b0, b1
    both = rows[:, None, :] & cols[None, :, :]
    d = np.unpackbits(both.view(np.uint8), axis=-1).reshape(16, 8, -1).sum(-1, dtype=np.int64)
    return np.stack([d[G_OF, 2 * T_OF], d[G_OF, 2 * T_OF + 1], d[G_OF + 8, 2 * T_OF],
                     d[G_OF + 8, 2 * T_OF + 1]], 1)


def _model_grams(bits, set_, fault=None):
    """relatedness_gram_kernel in numpy: the upper triangle of tiles of 16
    kWR kMT (128) samples, J-major, each with its pairs of products; a
    block's warps, kWR (rows) x kWC (columns), a warp kMT m-tiles (a group
    each) by kNT n-tiles of 8 (two a group); each product's indicator fragments from lo
    and hi, its sums by _mma_and_popc over every k-step, and its tile added
    into its Gram: as it is, on and above the diagonal only for a symmetric
    Gram, or (a swapped product) transposed, and left out on the diagonal.
    ``fault`` plants one error of the kind a fragment or store can hold."""
    bits = np.asarray(bits).view(np.uint32)
    _, groups, steps, _ = bits.shape
    k_wr, k_wc, k_mt, k_nt, k_g = K12_WR, K12_WC, K12_MT, K12_NT, K12_G
    tile = 16 * k_wr * k_mt
    assert tile == 8 * k_wc * k_nt
    sides = 16 * groups // tile
    products = K12_PRODUCTS[set_]
    grams = np.zeros((len(GRAM_SETS[set_]), 16 * groups, 16 * groups), dtype=np.int64)
    frag = bits.reshape(2, groups, steps, 32, 4)
    for tj in range(sides):
        for ti in range(tj + 1):
            diag = ti == tj
            for first in range(0, len(products), k_g):
                group = [pr for pr in products[first : first + k_g]
                         if not (pr[3] == SWAP and diag)]
                for warp in range(k_wr * k_wc):
                    wm, wn = warp // k_wc, warp % k_wc
                    acc = np.zeros((len(group), k_mt, k_nt, 32, 4), dtype=np.int64)
                    for k in range(steps):
                        for m in range(k_mt):
                            r = ti * tile // 16 + wm * k_mt + m
                            alo, ahi = frag[0, r, k], frag[1, r, k]
                            for i, (x, y, _, _) in enumerate(group):
                                ax = _plane(x, alo, ahi)
                                for n in range(k_nt):
                                    c = tj * tile // 16 + wn * (k_nt // 2) + n // 2
                                    h = n % 2
                                    if fault == "B halves swapped":
                                        h = 1 - h
                                    blo, bhi = frag[0, c, k], frag[1, c, k]
                                    b0 = _plane(y, blo[:, h], bhi[:, h])
                                    b1 = _plane(y, blo[:, h + 2], bhi[:, h + 2])
                                    if fault == "b0 and b1 swapped":
                                        b0, b1 = b1, b0
                                    a_ = ax[:, [1, 0, 3, 2]] if fault == "A rows swapped" else ax
                                    acc[i, m, n] += _mma_and_popc(a_, b0, b1)
                    for i, (_, _, gram, mode) in enumerate(group):
                        for m in range(k_mt):
                            for n in range(k_nt):
                                for e in range(4):
                                    row = ti * tile + 16 * (wm * k_mt + m) + G_OF + 8 * (e >> 1)
                                    col = tj * tile + 8 * (wn * k_nt + n) + 2 * T_OF + (e & 1)
                                    d = acc[i, m, n, :, e]
                                    if mode == SWAP and fault == "swap stored untransposed":
                                        mode = STORE
                                    if mode == SWAP:
                                        grams[gram, col, row] += d
                                    else:
                                        keep = (row <= col) | (mode != UPPER) | (not diag)
                                        grams[gram, row[keep], col[keep]] += d[keep]
    return grams


def _tpu_block_grams(packed, n_samples, idx, set_):
    """pgen_tpu's Grams of one block: _device_block_grams (king: of the bf16
    indicators H, R, A, C that its scan's body makes, king.py:163-166) or
    _block_grams (genome) of the interpret-mode codes of the cohort."""
    import jax.numpy as jnp

    codes = jnp.asarray(_tpu_codes(packed, n_samples, idx))
    if set_ == 1:
        return [np.asarray(g) for g in tpu_ibd._block_grams(codes)]
    ind = [(codes == k).astype(jnp.bfloat16) for k in (1, 0, 2)]
    return [np.asarray(g) for g in tpu_king._device_block_grams(
        (*ind, (codes != 3).astype(jnp.bfloat16)))]


@pytest.mark.parametrize("n_var", [1, 256, 297])
@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", [*WIDTHS, 131])
def test_gram_model_matches_pgen_tpu_block_grams(tmp_path, n_samples, kind, n_var):
    """The numpy model of the Gram kernel, on the model's bits of 1, 256 or
    297 rows (one k-step almost all pad rows, one whole k-step, two k-steps
    the last one part pad rows; the byte-value rows from row 41 on), equals
    relatedness_gram_plain on the plain bits, and gives every Gram of king's
    and genome's set, mirrored, exactly as pgen_tpu's _device_block_grams and
    _block_grams: nothing below a symmetric Gram's diagonal, and the pad
    samples' rows and columns 0. Up to 37 samples every sample lies in the
    first tile; at 131 (S_pad 256) the tile off the diagonal holds samples
    on both sides."""
    packed = _packed(_planted_codes(41, n_samples, n_samples + 3), tmp_path)[:n_var]
    rows, n_kept, idx = _cohort_records(packed, n_samples, kind)
    bits = _model_bits(rows, n_kept)
    plain_bits = relatedness_bits_plain(torch.from_numpy(rows), n_kept)
    for set_, pairs in enumerate(GRAM_SETS):
        want = _tpu_block_grams(packed, n_samples, idx, set_)
        got = _model_grams(bits, set_)
        s_pad = 16 * bits.shape[1]
        plain = relatedness_gram(plain_bits, pairs,
                                 torch.zeros((len(pairs), s_pad, s_pad), dtype=torch.int32))
        np.testing.assert_array_equal(got, plain.numpy())
        for i, (x, y) in enumerate(pairs):
            if x == y:  # below the diagonal nothing is added
                assert not np.tril(got[i], -1).any()
        whole = mirror_symmetric(torch.from_numpy(got), pairs).numpy()
        for g, w in zip(whole, want):
            np.testing.assert_array_equal(g[:n_kept, :n_kept], w)
            assert not g[n_kept:].any() and not g[:, n_kept:].any()


@pytest.mark.parametrize("fault", ["B halves swapped", "b0 and b1 swapped", "A rows swapped",
                                   "swap stored untransposed"])
def test_gram_model_catches_fragment_faults(tmp_path, fault):
    """The data tells a fragment read from the wrong place or a swapped
    product stored untransposed: R^T A and H^T C are not symmetric, 131
    samples fill the tile off the diagonal of two 128-sample tiles on both
    sides, and each planted fault moves some Gram off pgen_tpu's."""
    packed = _packed(_planted_codes(41, 131, 40), tmp_path)
    bits = _model_bits(packed, 131)
    want = _tpu_block_grams(packed, 131, None, 0)
    assert (want[1] != want[1].T).any() and (want[2] != want[2].T).any()
    got = mirror_symmetric(torch.from_numpy(_model_grams(bits, 0, fault)), GRAM_SETS[0])
    assert any((g.numpy()[:131, :131] != w).any() for g, w in zip(got, want))


def test_relatedness_gram_plain_adds_into_grams():
    """relatedness_gram adds the block's Grams into the ones it is given
    (the scan's sums across blocks), and takes only (2, G, steps, 128)
    int32 bits with Grams of their S_pad."""
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.integers(0, 256, (300, 5), dtype=np.uint8))
    bits = relatedness_bits_plain(packed, 19)
    pairs = GRAM_SETS[0]
    start = torch.from_numpy(rng.integers(-1000, 1000, (4, 128, 128)).astype(np.int32))
    got = relatedness_gram(bits, pairs, start.clone())
    want = relatedness_gram_plain(bits, pairs, torch.zeros_like(start)) + start
    assert got.equal(want)
    with pytest.raises(ValueError, match="grams must be"):
        relatedness_gram(bits, pairs, torch.zeros((4, 64, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="bits must be"):
        relatedness_gram(bits.long(), pairs, start.clone())


# pairs of Grams that neither king nor genome takes
OTHER_PAIRS = {
    "king reordered": (GRAM_SETS[0][1], GRAM_SETS[0][0], *GRAM_SETS[0][2:]),
    "king without C^T C": GRAM_SETS[0][:3],
    "king with A^T R": ((H_, H_), (A_, R_), (H_, C_), (C_, C_)),
    "genome and H^T C": (*GRAM_SETS[1], (H_, C_)),
    "none": (),
}


@pytest.mark.parametrize("fn", ["relatedness_gram", "relatedness_grams"])
@pytest.mark.parametrize("case", list(OTHER_PAIRS))
def test_relatedness_grams_refuse_other_pairs(case, fn):
    """The Gram kernel makes king's and genome's sets only, so the scan
    and its Gram wrapper refuse any other pairs on the CPU too, where the
    plain version could make them; the two sets, as lists, are taken."""
    pairs = OTHER_PAIRS[case]
    packed = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (40, 5), dtype=np.uint8))
    bits = relatedness_bits_plain(packed, 19)

    def call(pairs):
        if fn == "relatedness_grams":
            return relatedness_grams(packed.numpy(), 19, "cpu", pairs, 16)
        return relatedness_gram(bits, pairs, torch.zeros((len(pairs), 128, 128),
                                                         dtype=torch.int32))

    with pytest.raises(ValueError, match="GRAM_SETS"):
        call(pairs)
    for pairs in GRAM_SETS:
        assert len(call([list(p) for p in pairs])) == len(pairs)


@pytest.mark.parametrize("operand", ["grams", "bits"])
def test_relatedness_gram_refuses_unaligned_operands(operand):
    """Grams and bits must start on 16 B, as the kernel's bulk reductions
    and copies need, on the CPU as on the card: a contiguous view 8 B on is
    refused."""
    packed = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (40, 5), dtype=np.uint8))
    bits = relatedness_bits_plain(packed, 19)
    grams = torch.zeros((4, 128, 128), dtype=torch.int32)
    if operand == "grams":
        grams = torch.zeros(grams.numel() + 2, dtype=torch.int32)[2:].view(4, 128, 128)
    else:
        bits = torch.zeros(bits.numel() + 2, dtype=torch.int32)[2:].view(bits.shape).copy_(bits)
    assert grams.is_contiguous() and bits.is_contiguous()
    with pytest.raises(ValueError, match="16 B"):
        relatedness_gram(bits, GRAM_SETS[0], grams)

@pytest.mark.parametrize("kind", COHORTS)
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_grm_z_plain_matches_standardize_block_jnp(tmp_path, n_samples, kind):
    """K13's plain z against pgen_tpu's _standardize_block_jnp on the same
    codes (the 256 byte-value rows hold monomorphic and all-missing rows);
    the used flags exact."""
    import jax.numpy as jnp

    packed = _packed(_planted_codes(41, n_samples, n_samples + 1), tmp_path)
    idx = _cohort(kind, n_samples)
    z_want, used_want = tpu_pca._standardize_block_jnp(
        jnp.asarray(_tpu_codes(packed, n_samples, idx)))
    sel = None if idx is None else torch.from_numpy(idx)
    z, used = port_pca.grm_z(torch.from_numpy(packed), n_samples, sel)
    assert z.dtype == torch.float32 and used.dtype == torch.int32
    np.testing.assert_array_equal(used.numpy(), np.asarray(used_want).astype(np.int32))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=1e-6, atol=0)


def test_copied_host_functions_match_pgen_tpu():
    """The copies of pgen_tpu's jax-free host functions give pgen_tpu's
    results: king_kinship, ibd_estimates, ibs_from_counts, pca_from_grm,
    king_cutoff_mask and the brute-force oracles."""
    rng = np.random.default_rng(3)
    codes = _planted_codes(60, 9, 3)
    for port_fn, tpu_fn in ((port_king.king_counts_reference, tpu_king.king_counts_reference),
                            (port_ibd.ibd_counts_reference, tpu_ibd.ibd_counts_reference)):
        for g, w in zip(port_fn(codes), tpu_fn(codes)):
            np.testing.assert_array_equal(g, w)
    counts = tpu_king.king_counts_reference(codes)
    for g, w in zip(port_king.king_kinship(port_king.KingCounts(*counts)),
                    tpu_king.king_kinship(counts)):
        np.testing.assert_array_equal(g, w)
    ibd = tpu_ibd.ibd_counts_reference(codes)
    af = np.concatenate([rng.uniform(0, 1, 59), [np.nan]])
    got = port_ibd.ibd_estimates(port_ibd.IbdCounts(*ibd), af)
    want = tpu_ibd.ibd_estimates(ibd, af)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    a = rng.normal(size=(9, 9))
    for g, w in zip(port_pca.pca_from_grm(a @ a.T, 7, 3), tpu_pca.pca_from_grm(a @ a.T, 7, 3)):
        np.testing.assert_array_equal(g, w)
    kin = rng.uniform(-0.2, 0.3, (30, 30))
    kin = (kin + kin.T) / 2
    kin[2, 5] = kin[5, 2] = np.nan
    for cutoff in (0.1, 0.2, 0.5):
        np.testing.assert_array_equal(port_king_pipeline.king_cutoff_mask(kin, cutoff),
                                      tpu_king_pipeline.king_cutoff_mask(kin, cutoff))


def _spd_with_top(n, k, seed):
    """(n, n) f64 GRM sum over 7 used variants: a random orthonormal basis,
    k top eigenvalues 10 apart from 100 down, the rest in [0.01, 1], and an
    asymmetry of 1e-9 for the symmetrization to take out."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    lam = np.concatenate([100.0 - 10.0 * np.arange(k), rng.uniform(0.01, 1.0, n - k)])
    return 7 * (q * lam) @ q.T + 1e-9 * rng.normal(size=(n, n))


@pytest.mark.parametrize("n, k, seed", [(9, 3, 1), (40, 10, 2), (257, 10, 3), (64, 1, 4)])
def test_pca_from_grm_on_a_tensor_matches_its_numpy_path(n, k, seed):
    """A tensor is decomposed by torch's eigh in f64 on its device (here the
    CPU's): the numpy path's eigenvalues at rtol 1e-12 in the same
    descending order, its sign-fixed eigenvectors at atol 1e-10, f64 numpy
    arrays back, the input left as it was, one tensor call counted."""
    grm_sum = _spd_with_top(n, k, seed)
    tensor = torch.from_numpy(grm_sum.copy())
    calls = port_pca.pca_from_grm.tensor_calls
    vals, vecs = port_pca.pca_from_grm(tensor, 7, k)
    assert port_pca.pca_from_grm.tensor_calls == calls + 1
    want_vals, want_vecs = port_pca.pca_from_grm(grm_sum, 7, k)
    assert port_pca.pca_from_grm.tensor_calls == calls + 1
    assert isinstance(vals, np.ndarray) and isinstance(vecs, np.ndarray)
    assert vals.dtype == vecs.dtype == np.float64
    assert vals.shape == (k,) and vecs.shape == (n, k)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-12, atol=0)
    np.testing.assert_allclose(vecs, want_vecs, rtol=0, atol=1e-10)
    assert np.all(np.diff(vals) < 0)
    np.testing.assert_array_equal(tensor.numpy(), grm_sum)


@pytest.mark.parametrize("grm_sum", [np.eye(3), torch.eye(3, dtype=torch.float64)],
                         ids=["numpy", "tensor"])
def test_pca_from_grm_refuses_no_used_variants(grm_sum):
    calls = port_pca.pca_from_grm.tensor_calls
    for m_used in (0, -1):
        with pytest.raises(ValueError, match="no polymorphic variants"):
            port_pca.pca_from_grm(grm_sum, m_used, 2)
    assert port_pca.pca_from_grm.tensor_calls == calls


def _records(prefix, n_samples):
    return np.fromfile(f"{prefix}.pgen", dtype=np.uint8)[12:].reshape(-1, (n_samples + 3) // 4)


def test_pca_decomposes_the_grm_where_it_was_summed(tmp_path):
    """Exact pca keeps the GRM on its device and decomposes it there: one
    tensor call a job, none for --approx or -k 0, and the pairs of
    pca_from_grm's numpy path on grm_device's host GRM of the same records
    at rtol 1e-12 (eigenvalues) and atol 1e-10 (sign-fixed eigenvectors)."""
    prefix, _ = _fileset(tmp_path, 300, 16, 4)
    host = port_pca.grm_device(_records(prefix, 16), 16, "cpu")
    want_vals, want_vecs = port_pca.pca_from_grm(host.grm_sum, host.m_used, 4)
    calls = port_pca.pca_from_grm.tensor_calls
    for job in range(2):
        res = port_pca_entry(prefix, k=4, out_prefix=str(tmp_path / f"j{job}"), device="cpu")
        assert port_pca.pca_from_grm.tensor_calls == calls + job + 1
        assert res.num_used == host.m_used
        np.testing.assert_allclose(res.eigenvalues, want_vals, rtol=1e-12, atol=0)
        np.testing.assert_allclose(res.eigenvectors, want_vecs, rtol=0, atol=1e-10)
    port_pca_entry(prefix, k=2, approx=True, out_prefix=str(tmp_path / "a"), device="cpu")
    port_pca_entry(prefix, k=0, make_rel="bin", out_prefix=str(tmp_path / "r"), device="cpu")
    assert port_pca.pca_from_grm.tensor_calls == calls + 2


@pytest.mark.parametrize("argv, calls", [(["-k", "3"], 1), (["-k", "2", "--approx"], 0)],
                         ids=["exact", "approx"])
def test_cli_stats_count_the_decompositions_on_the_device(tmp_path, capsys, argv, calls):
    """pca --stats prints K13's launches (none on the CPU) and the GRMs that
    pca_from_grm decomposed as tensors: one for exact pca, none for
    --approx."""
    prefix, _ = _fileset(tmp_path, 60, 9, 5)
    assert port_main(["pca", prefix, *argv, "-o", str(tmp_path / "o"), "--device", "cpu",
                      "--stats"]) == 0
    lines = capsys.readouterr().err.splitlines()
    assert (f"launches: grm_z 0, pca_approx_pass 0; pca_from_grm.tensor_calls {calls}"
            in lines)


@pytest.mark.parametrize("fmt", ["bin", "text"])
def test_make_rel_writes_the_grm_as_before(tmp_path, fmt):
    """--make-rel copies the whole GRM back in its emit_rel span and writes
    the bytes it wrote from grm_device's host GRM: grm_sum / m_used as
    little-endian f64, or each row's %.10g text."""
    prefix, _ = _fileset(tmp_path, 300, 15, 6)
    host = port_pca.grm_device(_records(prefix, 15), 15, "cpu")
    rel = host.grm_sum / float(host.m_used)
    res = port_pca_entry(prefix, k=2, make_rel=fmt, out_prefix=str(tmp_path / "o"),
                         device="cpu")
    assert res.timer.stages["emit_rel"].bytes_moved == rel.nbytes
    if fmt == "bin":
        assert (tmp_path / "o.rel.bin").read_bytes() == rel.astype("<f8").tobytes()
    else:
        want = "".join("\t".join(f"{v:.10g}" for v in row) + "\n" for row in rel)
        assert (tmp_path / "o.rel").read_text() == want


def test_device_calls_refuse_2_to_the_24_rows():
    """pgen_tpu's guard and message: one call stays below 2^24 rows."""
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), (1 << 24, 2), (0, 0))
    for fn in (port_king.king_counts_device, port_ibd.ibd_counts_device):
        with pytest.raises(ValueError, match="2\\^24"):
            fn(big, 5, "cpu")


# -- the CLI against pgen_tpu's ----------------------------------------------

def _run_both(tmp_path, argv, out_flag="-o"):
    """argv through pgen_tpu's CLI (--provider device) and the port's (on
    the CPU), each into its own output; returns the two output paths."""
    tpu_out, port_out = tmp_path / "tpu", tmp_path / "port"
    assert tpu_main([*argv, out_flag, str(tpu_out), "--provider", "device"]) == 0
    assert port_main([*argv, out_flag, str(port_out), "--device", "cpu"]) == 0
    return tpu_out, port_out


KING_CASES = {
    "table": [],
    "min_kinship": ["--min-kinship", "0.05"],
    "cutoff": ["--cutoff", "0.1"],
    "cohort": ["--samples", "s0,s1,s3,s4,s6,s8,s9,s10,s12"],
    "cohort_cutoff": ["--samples", "s0,s1,s2,s3,s5,s7,s11", "--cutoff", "0.05"],
    "region_exclude": ["-r", "1:500-2500", "--exclude-sam", 'IID == "s2"'],
    "maf": ["--include-var", "GT_MAF >= 0.2", "--block-variants", "32"],
}


@pytest.mark.parametrize("case", list(KING_CASES))
def test_cli_king_byte_equal_to_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 250, 14, 1)
    argv = ["king", prefix, *KING_CASES[case]]
    tpu_out, port_out = _run_both(tmp_path, argv)
    if "--cutoff" in argv:
        for end in ("in", "out"):
            want = open(f"{tpu_out}.king.cutoff.{end}.id").read()
            assert open(f"{port_out}.king.cutoff.{end}.id").read() == want
        assert open(f"{tpu_out}.king.cutoff.out.id").read()  # samples dropped
    else:
        assert port_out.read_bytes() == tpu_out.read_bytes()


GENOME_CASES = {
    "table": [],
    "min_pi_hat": ["--min-pi-hat", "0.1"],
    "cohort": ["--samples", "s0,s1,s2,s3,s5,s8,s13"],
    "region_maf": ["-r", "1:300-2000", "--include-var", "GT_MAF >= 0.1"],
}


@pytest.mark.parametrize("case", list(GENOME_CASES))
def test_cli_genome_byte_equal_to_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 250, 14, 2)
    tpu_out, port_out = _run_both(tmp_path, ["genome", prefix, *GENOME_CASES[case]])
    assert port_out.read_bytes() == tpu_out.read_bytes()
    if case == "min_pi_hat":  # the planted relatives pass the threshold
        assert len(port_out.read_text().splitlines()) >= 3


def _table(path):
    lines = open(path).read().splitlines()
    return lines[0], [ln.split("\t")[0] for ln in lines[1:]], np.array(
        [[float(x) for x in ln.split("\t")[1:]] for ln in lines[1:]])


PCA_CASES = {
    "exact": ["-k", "3"],
    "cohort": ["-k", "2", "--samples", "s0,s2,s3,s5,s6,s9,s11,s14"],
    "approx": ["-k", "2", "--approx", "--approx-iters", "12", "--seed", "5"],
}


@pytest.mark.parametrize("case", list(PCA_CASES))
def test_cli_pca_matches_pgen_tpu(tmp_path, case):
    prefix, _ = _fileset(tmp_path, 300, 16, 4)
    tpu_out, port_out = _run_both(tmp_path, ["pca", prefix, *PCA_CASES[case]])
    head, iids, vecs = _table(f"{port_out}.eigenvec")
    want_head, want_iids, want_vecs = _table(f"{tpu_out}.eigenvec")
    assert (head, iids) == (want_head, want_iids)
    np.testing.assert_allclose(vecs, want_vecs, atol=5e-5)
    vals = np.loadtxt(f"{port_out}.eigenval")
    np.testing.assert_allclose(vals, np.loadtxt(f"{tpu_out}.eigenval"), atol=5e-5)


def test_cli_make_rel_matches_pgen_tpu(tmp_path):
    prefix, _ = _fileset(tmp_path, 300, 15, 6)
    tpu_out, port_out = _run_both(tmp_path, ["pca", prefix, "-k", "0", "--make-rel"])
    assert open(f"{port_out}.rel.id").read() == open(f"{tpu_out}.rel.id").read()
    rel = np.fromfile(f"{port_out}.rel.bin", dtype="<f8").reshape(15, 15)
    np.testing.assert_allclose(rel, np.fromfile(f"{tpu_out}.rel.bin", dtype="<f8").reshape(15, 15),
                               rtol=2e-5, atol=2e-5)
    assert not os.path.exists(f"{port_out}.eigenvec")
    assert port_main(["pca", prefix, "-k", "2", "--make-rel", "text", "-o",
                      str(tmp_path / "text"), "--device", "cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "text.rel", delimiter="\t"), rel,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("argv", [["king", "-o", "-"], ["genome", "-o", "-"],
                                  ["pca", "-k", "0"], ["pca", "--approx", "--make-rel"],
                                  ["king", "--samples", "s3"]])
def test_cli_exits_and_reports_as_pgen_tpu(tmp_path, capsys, argv):
    """stdout tables, the stderr summary line and the ValueError exits equal
    pgen_tpu's."""
    prefix, _ = _fileset(tmp_path, 40, 9, 8)
    full = [argv[0], prefix, *argv[1:]]
    rc = port_main([*full, "--device", "cpu"])
    got = capsys.readouterr()
    assert tpu_main([*full, "--provider", "device"]) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert rc == (0 if argv[-1] == "-" else 1)


@pytest.mark.parametrize("command", ["king", "genome", "pca"])
def test_cli_refuses_host_providers_and_ranks(tmp_path, capsys, monkeypatch, command):
    """pgen_tpu's host providers are refused (exit 2). Under WORLD_SIZE > 1
    king, genome and pca are served (their mesh steps, ROADMAP §1 item 17;
    a WORLD_SIZE without RANK makes no group, so this process runs as the
    one rank, byte-equal to its run alone); tests/test_torch_mesh.py runs
    the ranks."""
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    for provider in ("native", "numpy"):
        with pytest.raises(SystemExit) as e:
            port_main([command, prefix, "--provider", provider, "--device", "cpu"])
        assert e.value.code == 2
        assert "(item 10, done)" in capsys.readouterr().err
    out = {"king": "", "genome": "", "pca": ".eigenvec"}[command]
    assert port_main([command, prefix, "--device", "cpu", "-o", str(tmp_path / "alone")]) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert port_main([command, prefix, "--device", "cpu", "-o", str(tmp_path / "ranks")]) == 0
    assert (Path(f"{tmp_path / 'ranks'}{out}").read_bytes()
            == Path(f"{tmp_path / 'alone'}{out}").read_bytes())


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch, capsys):
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("king", "genome", "pca"):
        assert port_main([command, prefix, "-o", str(tmp_path / command)]) == 1
        err = capsys.readouterr().err
        assert err.startswith("pgen-tpu: error: ") and "is_available" in err
    assert not list(tmp_path.glob("king*")) and not list(tmp_path.glob("genome*"))


# ROADMAP §1 item 13's subcommands, served since it landed: each parses and
# runs through the port's CLI (tests/test_torch_host_subcommands.py holds
# their outputs against pgen_tpu's)
UNSERVED = {}
ITEM_13 = ("describe", "index", "view", "export", "split", "concat", "merge", "sort",
           "annotate", "isec", "diff", "roh")


# the first argument vector of each subcommand in the parser's table
FIRST_ARGV = {argv[0]: argv for argv in reversed(ARGV_TABLE)}


@pytest.mark.parametrize("command", ITEM_13)
def test_cli_serves_each_item_13_subcommand(tmp_path, capsys, command):
    """Each of item 13's subcommands is served: its first argument vector of
    the parser's table, pointed at a fileset, runs through the port's CLI
    with no refusal (exit 0, or pgen_tpu's own exit 1 for a missing input)."""
    prefix, _ = _fileset(tmp_path, 20, 6, 9)
    gz = tmp_path / "x.vcf.gz"
    assert port_main(["filter", prefix, "-o", str(gz), "--index", "--device", "cpu"]) == 0
    names = {"P": prefix, "a": prefix, "b": prefix, "x.vcf.gz": str(gz),
             "x.pgen": f"{prefix}.pgen"}
    argv = [names.get(a, str(tmp_path / a) if a in ("s", "c", "m", "i", "x") else a)
            for a in FIRST_ARGV[command]]
    if command == "annotate":
        argv += ["--fill-info", "AC", "-o", str(tmp_path / "an")]
    if command in ("diff", "export", "roh", "sort"):
        argv += ["-o", str(tmp_path / f"{command}.out")]
    if command in ("merge", "diff", "annotate", "export", "roh"):
        argv += ["--device", "cpu"]
    if command == "merge":  # one cohort (the same sample twice is refused)
        argv = ["merge", prefix, "-o", str(tmp_path / "m"), "--device", "cpu"]
    capsys.readouterr()
    assert port_main(argv) == 0, capsys.readouterr().err
    assert "ROADMAP" not in capsys.readouterr().err


def test_unserved_table_covers_every_subcommand_not_served():
    from pgen_tpu_torch.cli import SERVED

    assert set(UNSERVED) | set(SERVED) == set(FIRST_ARGV)
    assert not set(UNSERVED) & set(SERVED)
    assert set(ITEM_13) <= set(SERVED)
