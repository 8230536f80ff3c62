"""The port's CUDA kernels on a card, against their plain PyTorch versions
and against pgen_tpu's numpy oracles (``unpack_codes_reference``,
``emit_rows_numpy``, ``formats.writer.pack_codes``, ``gt_counts_reference``
and ``sample_counts_reference``), so the kernels are
held to the reference package directly, not only through their twins. The
GWAS moments on the card are held against an f64 numpy product here.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports no jax (these oracles are numpy only), so
on a machine with a card and without jax it runs on its own, all but the
interaction test, which holds the card's BETA against pgen_tpu's numpy GWAS
provider and imports it (and with it jax, kept on the CPU) when it runs:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(chip_smoke.py runs the same comparisons at the paths' block shapes.)
"""

import numpy as np
import pytest
import torch

from pgen_tpu.formats.writer import pack_codes as writer_pack_codes
from pgen_tpu.ops.gt_stats import gt_counts_reference, gt_counts_subset, sample_counts_reference
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu.pipeline.vcf import emit_rows_numpy
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
from pgen_tpu_torch import kernels
from pgen_tpu_torch.ops.gt_stats import (
    gt_counts_device,
    gt_counts_masked,
    gt_counts_masked_plain,
    gt_counts_plain,
    gt_counts_subsets,
    sample_counts_device,
    sample_counts_plain,
    kept_counts,
)
from pgen_tpu_torch.ops.gt_stats_host import sample_byte_masks
from pgen_tpu_torch.ops.pack import (
    pack_codes,
    pack_codes_plain,
    subset_repack,
    subset_repack_plain,
)
from pgen_tpu_torch.ops.glm import (
    LUT_GENO,
    LUT_INT,
    LUT_MOMENTS,
    _centered,
    _moment_columns,
    glm_moments,
    glm_planes,
    glm_planes_plain,
)
from pgen_tpu_torch.ops.pca import (
    approx_pass_tolerance,
    grm_device,
    grm_z,
    grm_z_plain,
    pca_approx_pass,
    pca_approx_pass_plain,
)
from pgen_tpu_torch.ops.relatedness import (
    GRAM_SETS,
    mirror_symmetric,
    relatedness_bits,
    relatedness_bits_plain,
    relatedness_gram,
    relatedness_gram_plain,
    relatedness_grams,
    relatedness_planes_plain,
)
from pgen_tpu_torch.ops.ibd import ibd_counts_device
from pgen_tpu_torch.ops.king import king_counts_device
from pgen_tpu_torch.ops.ld import banded_r2, banded_r2_numpy, ld_r2_band, ld_r2_band_plain
from pgen_tpu_torch.ops.score import score_dosage, score_dosage_plain
from pgen_tpu_torch.ops.unpack import unpack_codes, unpack_codes_plain

WIDTHS = [1, 2, 3, 4, 5, 2503, 2504]
WRAPPERS = (unpack_codes, genotype_text, subset_text_from_packed)
NEW_WRAPPERS = (pack_codes, subset_repack, genotype_text_transposed, genotype_text_from_codes)
COUNT_WRAPPERS = (gt_counts_device, sample_counts_device)
OPERAND_WRAPPERS = (glm_planes, score_dosage)
RELATEDNESS_WRAPPERS = (relatedness_bits, relatedness_gram, grm_z)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _packed(n_var, n_samples, seed, device):
    """Random records whose last 256 rows each repeat one byte value, so
    every byte value sits at every position, pad bits included."""
    rec = (2 * n_samples + 7) // 8
    packed = np.random.default_rng(seed).integers(0, 256, size=(n_var + 256, rec), dtype=np.uint8)
    packed[n_var:] = np.arange(256, dtype=np.uint8)[:, None]
    return torch.from_numpy(packed).to(device)


def _oracle_text(packed, sample_idx, n_samples):
    """pgen_tpu's numpy row emitter with empty prefixes: each row is the GT
    text then a newline, which is dropped."""
    n_var = packed.shape[0]
    n_kept = n_samples if sample_idx is None else len(sample_idx)
    out = np.empty(n_var * (4 * n_kept + 1), dtype=np.uint8)
    total = emit_rows_numpy(packed, np.empty(0, np.uint8), np.zeros(n_var + 1, np.int64),
                            sample_idx, n_samples, out)
    assert total == out.size
    return out.reshape(n_var, 4 * n_kept + 1)[:, :-1]


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_kernels_match_plain(cuda_device, n_samples):
    packed = _packed(300, n_samples, n_samples, cuda_device)
    order = np.random.default_rng(n_samples).permutation(n_samples)
    host = packed.cpu().numpy()
    counts = [w.launches for w in WRAPPERS]
    codes = unpack_codes(packed, n_samples)
    assert torch.equal(codes, unpack_codes_plain(packed, n_samples))
    np.testing.assert_array_equal(codes.cpu().numpy(), unpack_codes_reference(host, n_samples))
    text = genotype_text(packed, n_samples)
    assert torch.equal(text, genotype_text_plain(packed, n_samples))
    np.testing.assert_array_equal(text.cpu().numpy(), _oracle_text(host, None, n_samples))
    for k in sorted({min(2, n_samples), min(1000, n_samples)}):
        sel = torch.from_numpy(order[:k].astype(np.int32)).to(cuda_device)
        text = subset_text_from_packed(packed, sel)
        assert torch.equal(text, subset_text_plain(packed, sel))
        np.testing.assert_array_equal(text.cpu().numpy(), _oracle_text(host, order[:k], n_samples))
    torch.cuda.synchronize()
    n_subsets = len({min(2, n_samples), min(1000, n_samples)})
    assert [w.launches for w in WRAPPERS] == [counts[0] + 1, counts[1] + 1, counts[2] + n_subsets]


def _launch_at_offset(wrapper, symbol, packed, sel, width, offset):
    """Run ``wrapper``'s launcher with its (V, width) u8 output starting
    ``offset`` bytes into a buffer (the wrappers allocate 16-B aligned
    outputs themselves); returns that output."""
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


@pytest.mark.parametrize("n_samples", [2504, 2503, 8, 5, 4, 1])
def test_keep_all_text_both_forms(cuda_device, n_samples):
    """K2 in its 16-B form (S % 4 == 0, aligned output) and its word form
    (any other S, or an output 4 or 12 bytes past a 16-B boundary), on more
    rows than one launch holds in flight, all equal to the plain version."""
    packed = _packed(20_000, n_samples, n_samples + 1, cuda_device)
    want = genotype_text_plain(packed, n_samples)
    assert torch.equal(genotype_text(packed, n_samples), want)
    for offset in (4, 12):
        got = _launch_at_offset(genotype_text, "pgen_genotype_text", packed, None,
                                4 * n_samples, offset)
        assert torch.equal(got, want)


def test_text_launchers_refuse_an_unaligned_output(cuda_device):
    packed = _packed(3, 17, 0, cuda_device)
    sel = torch.tensor([3, 1], dtype=torch.int32, device=cuda_device)
    counts = [genotype_text.launches, subset_text_from_packed.launches]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch_at_offset(genotype_text, "pgen_genotype_text", packed, None, 68, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch_at_offset(subset_text_from_packed, "pgen_subset_text", packed, sel, 8, 2)
    assert [genotype_text.launches, subset_text_from_packed.launches] == counts


@pytest.mark.parametrize("n_kept", [2, 3, 1000, 1001, 20_000])
def test_subset_text_any_ids(cuda_device, n_kept):
    """K3 with ids in reversed order, repeated, and (at K = 20,000) past
    2^14, more than one tile of kept samples holds; in its 16-B form (K % 4
    == 0) and its word form (odd K, or an output 4 bytes past a 16-B
    boundary)."""
    n_samples = 2503
    packed = _packed(3000, n_samples, n_kept, cuda_device)
    rng = np.random.default_rng(n_kept)
    ids = np.concatenate([np.arange(n_samples)[::-1], rng.integers(0, n_samples, n_kept)])
    sel = torch.from_numpy(ids[:n_kept].astype(np.int32)).to(cuda_device)
    want = subset_text_plain(packed, sel)
    assert torch.equal(subset_text_from_packed(packed, sel), want)
    got = _launch_at_offset(subset_text_from_packed, "pgen_subset_text", packed, sel,
                            4 * n_kept, 4)
    assert torch.equal(got, want)


def _all_byte_codes(n_samples):
    """256 rows of codes in which column s of row r holds (r + s) % 256, so
    every byte value sits at every position of a packed word."""
    r = np.arange(256)[:, None] + np.arange(n_samples)[None, :]
    return (r % 256).astype(np.uint8)


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_pack_kernels_match_plain_and_oracles(cuda_device, n_samples):
    rng = np.random.default_rng(n_samples)
    codes_np = rng.integers(0, 4, size=(300, n_samples), dtype=np.uint8)
    codes = torch.from_numpy(codes_np).to(cuda_device)
    wild = torch.from_numpy(_all_byte_codes(n_samples)).to(cuda_device)
    packed = _packed(300, n_samples, n_samples, cuda_device)
    host = packed.cpu().numpy()
    rec = host.shape[1]
    counts = [w.launches for w in NEW_WRAPPERS]

    got = pack_codes(codes)
    assert torch.equal(got, pack_codes_plain(codes))
    np.testing.assert_array_equal(got.cpu().numpy(), writer_pack_codes(codes_np))
    assert torch.equal(pack_codes(wild), pack_codes_plain(wild))

    sizes = sorted({min(k, n_samples) for k in (1, 2, 3, 5, 1001)} | {n_samples})
    for k in sizes:
        sel_np = rng.permutation(n_samples)[:k].astype(np.int32)
        sel = torch.from_numpy(sel_np).to(cuda_device)
        got = subset_repack(packed, sel)
        assert torch.equal(got, subset_repack_plain(packed, sel))
        want = writer_pack_codes(unpack_codes_reference(host, 4 * rec)[:, sel_np])
        np.testing.assert_array_equal(got.cpu().numpy(), want)

    packed_t = packed.T.contiguous()
    got = genotype_text_transposed(packed_t)
    assert torch.equal(got, genotype_text_transposed_plain(packed_t))
    np.testing.assert_array_equal(got.cpu().numpy(), _oracle_text(host, None, 4 * rec).T)

    got = genotype_text_from_codes(codes)
    assert torch.equal(got, text_from_codes_plain(codes))
    np.testing.assert_array_equal(
        got.cpu().numpy(), _oracle_text(writer_pack_codes(codes_np), None, n_samples)
    )
    assert torch.equal(genotype_text_from_codes(wild), text_from_codes_plain(wild))
    torch.cuda.synchronize()
    assert [w.launches for w in NEW_WRAPPERS] == [
        counts[0] + 2, counts[1] + len(sizes), counts[2] + 1, counts[3] + 2,
    ]


@pytest.mark.parametrize("n_var", [300, 1, 16_384, 65_536 + 5])
@pytest.mark.parametrize("n_samples", [2504, 2503, 2497, 2505, 5, 1])
def test_count_kernels_match_plain_and_oracles(cuda_device, n_samples, n_var):
    """K8 and K9 on random records whose pad slots hold random codes, with
    every byte value at every position: R % 4 = 0, 1, 2 and 3 (K9's rows
    start off a word boundary), and row counts that are no multiple of K9's
    warps, its 4-row loads or its row chunks, at score's and filter's block
    shapes."""
    packed = _packed(n_var, n_samples, n_samples, cuda_device)
    host = packed.cpu().numpy()
    counts = [w.launches for w in COUNT_WRAPPERS]
    got = gt_counts_device(packed, n_samples)
    assert torch.equal(got, gt_counts_plain(packed, n_samples))
    np.testing.assert_array_equal(got.cpu().numpy(), gt_counts_reference(host, n_samples))
    got = sample_counts_device(packed, n_samples)
    assert got.shape == (n_samples, 4)
    assert torch.equal(got, sample_counts_plain(packed, n_samples))
    np.testing.assert_array_equal(got.cpu().numpy(), sample_counts_reference(host, n_samples))
    torch.cuda.synchronize()
    assert [w.launches for w in COUNT_WRAPPERS] == [counts[0] + 1, counts[1] + 1]


def test_count_kernels_count_fewer_samples_than_slots(cuda_device):
    """num_samples below 4R - 3: whole trailing bytes are pad, as in the
    unpack's [:, :S] cut."""
    packed = _packed(40, 40, 3, cuda_device)
    for s in (0, 1, 17, 37, 40):
        assert torch.equal(gt_counts_device(packed, s), gt_counts_plain(packed, s))
        assert torch.equal(sample_counts_device(packed, s), sample_counts_plain(packed, s))


def _records_at(host, offset, device):
    """``host``'s records on the card, starting ``offset`` bytes past a 16-B
    boundary and ending at the last byte of their buffer's storage."""
    buf = torch.empty(offset + host.size, dtype=torch.uint8, device=device)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:].view(host.shape)
    view.copy_(torch.from_numpy(host))
    assert view.data_ptr() + view.numel() == buf.data_ptr() + buf.untyped_storage().nbytes()
    return view


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("n_samples", [2504, 2503, 2497, 2505, 5, 1])
def test_repack_and_counts_at_every_row_offset(cuda_device, n_samples, offset):
    """K5 and K8 on records whose rows start at every byte offset from a
    16-B boundary, R % 4 = 0..3 and S of 1 and 5 (a row shorter than one
    word), in a tensor that ends at the end of its storage (its last row,
    alone and among the others); K8 also at S < 4R - 3; K5 at K = 2 and
    1,001 sorted, into records at an offset too, nothing written outside
    them."""
    host = _packed(300, n_samples, 16 * n_samples + offset, "cpu").numpy()
    packed = _records_at(host, offset, cuda_device)
    rec = host.shape[1]
    for rows in (packed, packed[-1:]):
        for s in sorted({n_samples, max(1, 4 * rec - 7), max(1, n_samples // 3)}):
            got = gt_counts_device(rows, s)
            assert torch.equal(got, gt_counts_plain(rows, s))
            np.testing.assert_array_equal(got.cpu().numpy(), gt_counts_reference(
                rows.cpu().numpy(), s))
    ids = np.sort(np.random.default_rng(offset).permutation(n_samples)[: min(1001, n_samples)])
    for k in sorted({min(2, n_samples), len(ids)}):
        sel = torch.from_numpy(ids[:k].astype(np.int32)).to(cuda_device)
        for rows in (packed, packed[-1:]):
            want = subset_repack_plain(rows, sel)
            assert torch.equal(subset_repack(rows, sel), want)
            out_rec = want.shape[1]
            guard = torch.full((rows.shape[0] * out_rec + 32,), 0xA5, dtype=torch.uint8,
                               device=cuda_device)
            out = guard[offset : offset + rows.shape[0] * out_rec].view(-1, out_rec)
            kernels.launch(subset_repack, "pgen_subset_repack", rows, rows.data_ptr(),
                           sel.data_ptr(), out.data_ptr(), rows.shape[0], rec, k)
            assert torch.equal(out, want)
            assert bool((guard[:offset] == 0xA5).all())
            assert bool((guard[offset + out.numel():] == 0xA5).all())


@pytest.mark.parametrize("kind", ["sorted", "reversed", "repeated", "unsorted"])
@pytest.mark.parametrize("n_kept", [1, 2, 5, 16, 40, 78, 79, 200, 1001, 2503, 4100, 9001])
def test_subset_repack_any_ids_both_forms(cuda_device, n_kept, kind):
    """K5 with ids sorted, reversed, repeated and unsorted, at K from 1 to
    past S: few ids (the direct form), many (the staged form: one thread a
    byte, two and four bytes a thread), past the 4,096 ids a staged block
    holds (the direct form's column tiles), on rows of 2503 samples, more
    rows than one pass of the staged form's blocks; against the plain
    version and pgen_tpu's host pack of the unpacked columns."""
    n_samples = 2503
    rng = np.random.default_rng(n_kept)
    packed = _packed(20_000, n_samples, n_kept, cuda_device)
    host = packed.cpu().numpy()
    if kind == "repeated" or n_kept > n_samples:
        ids = rng.integers(0, n_samples, n_kept)
    else:
        ids = {"sorted": np.sort(rng.permutation(n_samples)[:n_kept]),
               "reversed": np.sort(rng.permutation(n_samples)[:n_kept])[::-1],
               "unsorted": rng.permutation(n_samples)[:n_kept]}[kind]
    sel_np = np.ascontiguousarray(ids, dtype=np.int32)
    sel = torch.from_numpy(sel_np).to(cuda_device)
    got = subset_repack(packed, sel)
    assert torch.equal(got, subset_repack_plain(packed, sel))
    want = writer_pack_codes(unpack_codes_reference(host, 4 * host.shape[1])[:, sel_np])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("n_samples,n_kept", [(40_003, 40_000), (40_003, 300), (61_447, 61_447),
                                              (8_003, 8_000)])
def test_subset_repack_wide_rows(cuda_device, n_samples, n_kept):
    """Rows past the staged form's 15 KB tile (61,447 samples: 15,362 B),
    and wide rows of many ids in the direct form's column tiles (40,000 and
    8,000 ids) or few (300), sorted and repeated ids: equal to the plain
    version."""
    rng = np.random.default_rng(n_samples)
    packed = _packed(40, n_samples, n_kept, cuda_device)
    for ids in (np.sort(rng.permutation(n_samples)[:n_kept]), rng.integers(0, n_samples, n_kept)):
        sel = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
        assert torch.equal(subset_repack(packed, sel), subset_repack_plain(packed, sel))


def test_count_kernel_launch_error_raises(cuda_device, monkeypatch):
    """A launcher that reports a CUDA error raises and is not counted."""

    class RefusingLibrary:
        def __getattr__(self, name):
            if name == "pgen_cuda_error_string":
                return lambda status: b"invalid argument"
            return lambda *args: 1  # cudaErrorInvalidValue

    packed = _packed(3, 17, 0, cuda_device)
    counts = [w.launches for w in COUNT_WRAPPERS]
    monkeypatch.setattr(kernels, "load", RefusingLibrary)
    for wrapper in COUNT_WRAPPERS:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            wrapper(packed, 17)
    assert [w.launches for w in COUNT_WRAPPERS] == counts


@pytest.mark.parametrize("n_var", [1, 31, 33, 1000])
@pytest.mark.parametrize("rec", [1, 2, 626])
def test_transposed_text_ragged_shapes(cuda_device, rec, n_var):
    """K6 at variant counts that are not a multiple of a warp, and R = 1."""
    packed_t = torch.from_numpy(
        np.random.default_rng(rec + n_var).integers(0, 256, size=(rec, n_var), dtype=np.uint8)
    ).to(cuda_device)
    got = genotype_text_transposed(packed_t)
    assert got.shape == (16 * rec, n_var)
    assert torch.equal(got, genotype_text_transposed_plain(packed_t))


def _keep_masks(n_samples, n_masks, seed, device):
    """(id sets, their (P, R) keep masks on device): the first set every
    sample, then sets with gaps, a duplicate and unsorted ids, one of them
    empty when P > 2."""
    rng = np.random.default_rng(seed)
    rec = (n_samples + 3) // 4
    sets = [np.arange(n_samples)]
    for p in range(1, n_masks):
        k = 0 if p == 2 else int(rng.integers(1, n_samples + 1))
        ids = rng.permutation(n_samples)[:k]
        sets.append(np.concatenate([ids, ids[:1]]))
    masks = np.stack([sample_byte_masks(ids.astype(np.int32), rec) for ids in sets])
    return sets, torch.from_numpy(masks).to(device)


@pytest.mark.parametrize("n_masks", [1, 5, 8, 9, 26])
@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("n_samples", [2504, 2503, 2497, 5, 1, 2560, 2561, 4101])
def test_masked_counts_at_every_row_offset(cuda_device, n_samples, offset, n_masks):
    """K14 on records whose rows start at every byte offset from a 16-B
    boundary, S % 4 = 0, 3 and 1 (S of 1 and 5: a row shorter than one
    word; S of 2560: rows of 640 B, the longest staged whole; S of 2561 and
    4101: rows of 641 and 1,026 B, counted in two and three chunks), in a
    tensor that ends at the end of its storage (its last row alone too), P
    = 1, 5, 8, 9 and 26 keep masks (one to four eights of masks in the
    products): equal to its plain version and to pgen_tpu's
    gt_counts_subset."""
    host = _packed(300, n_samples, 16 * n_samples + offset + n_masks, "cpu").numpy()
    packed = _records_at(host, offset, cuda_device)
    sets, masks = _keep_masks(n_samples, n_masks, offset, cuda_device)
    before = gt_counts_masked.launches
    for rows in (packed[-1:], packed):
        got = gt_counts_masked(rows, masks)
        assert got.shape == (rows.shape[0], n_masks, 4)
        assert torch.equal(got, gt_counts_masked_plain(rows, masks))
    torch.cuda.synchronize()
    assert gt_counts_masked.launches == before + 2
    for p, ids in enumerate(sets):
        np.testing.assert_array_equal(got[:, p].cpu().numpy(),
                                      gt_counts_subset(host, ids.astype(np.int32), "numpy"))


@pytest.mark.parametrize("n_samples", [2504, 40_003])
def test_masked_counts_stream_many_sets(cuda_device, n_samples):
    """gt_counts_subsets on the card: 35 sets (two launches a block, past
    MAX_MASKS), blocks of 1,000 rows, wide rows too; equal to the plain
    counts and to pgen_tpu's."""
    host = _packed(2_100, n_samples, 7, "cpu").numpy()
    sets, masks = _keep_masks(n_samples, 35, 35, "cpu")
    got = gt_counts_subsets(host, sets, cuda_device, block_rows=1000)
    want = gt_counts_masked_plain(torch.from_numpy(host), masks).numpy()
    np.testing.assert_array_equal(got, want)
    for p in (0, 2, 34):
        np.testing.assert_array_equal(got[:, p], gt_counts_subset(host, sets[p], "numpy"))


@pytest.mark.parametrize("n_masks", [1, 26])
@pytest.mark.parametrize("n_samples, n_var", [(4101, 65_536), (40_003, 4_096), (40_003, 16_384)])
def test_masked_counts_rows_in_chunks(cuda_device, n_samples, n_var, n_masks):
    """K14 on rows counted in chunks at sizes where a tile's chunks are one
    item (65,536 rows of 1,026 B; 16,384 of 10,001 B: plain stores) and
    where they are split over items that add their counts (4,096 rows of
    10,001 B: atomics): equal to its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(n_samples + n_var)
    packed = torch.randint(0, 256, (n_var, (n_samples + 3) // 4), dtype=torch.uint8,
                           device=cuda_device, generator=gen)
    _, masks = _keep_masks(n_samples, n_masks, n_var, cuda_device)
    assert torch.equal(gt_counts_masked(packed, masks), gt_counts_masked_plain(packed, masks))


def test_masked_counts_refuse_a_wrong_operand(cuda_device):
    packed = _packed(3, 17, 0, cuda_device)
    _, masks = _keep_masks(17, 3, 0, cuda_device)
    with pytest.raises(ValueError, match="kept_counts"):
        gt_counts_masked(packed, masks, kept_counts(masks[:2]))
    with pytest.raises(ValueError, match="at most 32"):
        gt_counts_masked(packed, masks[[0] * 33])
    with pytest.raises(ValueError, match="masks are on"):
        gt_counts_masked(packed, masks.cpu())


def test_zero_sized_launch_nothing(cuda_device):
    counts = [w.launches for w in WRAPPERS]
    empty = torch.empty((0, 5), dtype=torch.uint8, device=cuda_device)
    assert unpack_codes(empty, 17).shape == (0, 17)
    assert genotype_text(empty, 17).shape == (0, 68)
    packed = _packed(3, 17, 0, cuda_device)
    assert genotype_text(packed, 0).shape == (259, 0)
    sel = torch.empty(0, dtype=torch.int32, device=cuda_device)
    assert subset_text_from_packed(packed, sel).shape == (259, 0)
    assert [w.launches for w in WRAPPERS] == counts
    new_counts = [w.launches for w in NEW_WRAPPERS]
    assert pack_codes(empty).shape == (0, 2)
    assert subset_repack(packed, sel).shape == (259, 0)
    assert genotype_text_transposed(empty).shape == (0, 5)
    assert genotype_text_from_codes(empty).shape == (0, 20)
    assert [w.launches for w in NEW_WRAPPERS] == new_counts
    count_launches = [w.launches for w in COUNT_WRAPPERS]
    assert gt_counts_device(empty, 17).shape == (0, 4)
    assert sample_counts_device(empty, 17).shape == (17, 4)
    assert gt_counts_device(packed, 0).shape == (259, 4)
    assert sample_counts_device(packed, 0).shape == (0, 4)
    assert [w.launches for w in COUNT_WRAPPERS] == count_launches
    masked = gt_counts_masked.launches
    _, masks = _keep_masks(17, 2, 0, cuda_device)
    assert gt_counts_masked(packed[:0], masks).shape == (0, 2, 4)
    assert gt_counts_masked(packed, masks[:0]).shape == (259, 0, 4)
    assert gt_counts_masked.launches == masked


def test_operand_kernels_launch_nothing_when_empty(cuda_device):
    counts = [w.launches for w in OPERAND_WRAPPERS]
    lut = torch.tensor(LUT_MOMENTS, dtype=torch.float32, device=cuda_device)
    empty = torch.empty((0, 5), dtype=torch.uint8, device=cuda_device)
    planes, hist = glm_planes(empty, 17, lut)
    assert planes.shape == (2, 0, 17) and hist.shape == (0, 4)
    packed = _packed(3, 17, 0, cuda_device)
    sel = torch.empty(0, dtype=torch.int32, device=cuda_device)
    planes, hist = glm_planes(packed, 17, lut, sel)
    assert planes.shape == (2, 259, 0) and not hist.any()
    flip = torch.zeros(259, dtype=torch.uint8, device=cuda_device)
    db, n_called = score_dosage(packed, 17, flip, True, sel)
    assert db.shape == (259, 0) and not n_called.any()
    assert [w.launches for w in OPERAND_WRAPPERS] == counts


def test_sel_on_another_device_is_refused(cuda_device):
    packed = _packed(3, 17, 0, cuda_device)
    for wrapper in (subset_text_from_packed, subset_repack):
        with pytest.raises(ValueError):
            wrapper(packed, torch.tensor([1, 2], dtype=torch.int32))


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two CUDA cards")
def test_launch_on_a_card_that_is_not_current():
    """Each wrapper launches on its tensor's card, on that card's current
    stream, while another card is current."""
    dev = torch.device("cuda", 1)
    packed = _packed(40, 2503, 1, dev)
    sel = torch.tensor([2502, 0, 7], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    codes = unpack_codes_plain(packed, 2503).contiguous()
    _, masks = _keep_masks(2503, 5, 1, dev)
    with torch.cuda.stream(side), torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        got = [
            unpack_codes(packed, 2503),
            genotype_text(packed, 2503),
            subset_text_from_packed(packed, sel),
            pack_codes(codes),
            subset_repack(packed, sel),
            gt_counts_device(packed, 2503),
            sample_counts_device(packed, 2503),
            gt_counts_masked(packed, masks),
        ]
    side.synchronize()
    want = [
        unpack_codes_plain(packed, 2503),
        genotype_text_plain(packed, 2503),
        subset_text_plain(packed, sel),
        pack_codes_plain(codes),
        subset_repack_plain(packed, sel),
        gt_counts_plain(packed, 2503),
        sample_counts_plain(packed, 2503),
        gt_counts_masked_plain(packed, masks),
    ]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cohorts(n_samples, rng, device):
    """No sel, and a sel with a gap, a duplicate and the last sample."""
    ids = rng.permutation(n_samples)[: max(1, (9 * n_samples) // 10)]
    ids = np.concatenate([ids, ids[:1], [n_samples - 1]]).astype(np.int32)
    return [None, torch.from_numpy(ids).to(device)]


def _score_at_offset(packed, n_samples, flip, mean_impute, offset):
    """K11's launcher, without sel, into dosages ``offset`` bytes past a
    16-B boundary: its tiled form where the flat form would run."""
    n_var, rec = packed.shape
    buf = torch.full((n_var * n_samples + 8,), float("nan"), device=packed.device)
    db = buf[offset // 4 : offset // 4 + n_var * n_samples].view(n_var, n_samples)
    called = torch.full((2, n_var), -1, dtype=torch.int32, device=packed.device)
    kernels.launch(score_dosage, "pgen_score_dosage", packed, packed.data_ptr(), None,
                   flip.data_ptr(), db.data_ptr(), called.data_ptr(), n_var, rec, n_samples,
                   n_samples, int(mean_impute))
    return db, called[0]


@pytest.mark.parametrize("flips", ["random", "none", "all"])
@pytest.mark.parametrize("n_samples", [2504, 2503, 2502, 2501, 8, 5, 1, 9_001])
def test_operand_kernels_match_plain(cuda_device, n_samples, flips):
    """K10 (P = 2 and 3, each LUT) and K11 (flip random, none and all, with
    and without mean imputation; without sel also in its tiled form, its
    output 4 B past a 16-B boundary), with and without sel, on random
    records whose pad slots hold random codes, every byte value at every
    position (0xFF: a row with no called sample): K11's flat form (S % 4 ==
    0), its tiled form at every S % 4, and past 8,192 ids its column chunks
    after a count pass."""
    rng = np.random.default_rng(n_samples)
    packed = _packed(300, n_samples, n_samples, cuda_device)
    host = packed.cpu().numpy()
    flip = {"random": torch.from_numpy(rng.integers(0, 2, packed.shape[0], dtype=np.uint8)),
            "none": torch.zeros(packed.shape[0], dtype=torch.uint8),
            "all": torch.ones(packed.shape[0], dtype=torch.uint8)}[flips].to(cuda_device)
    counts = [w.launches for w in OPERAND_WRAPPERS]
    runs = 0
    score_runs = 0
    for sel in _cohorts(n_samples, rng, cuda_device):
        for table in (LUT_MOMENTS, LUT_GENO, LUT_INT):
            lut = torch.tensor(table, dtype=torch.float32, device=cuda_device)
            planes, hist = glm_planes(packed, n_samples, lut, sel)
            want_planes, want_hist = glm_planes_plain(packed, n_samples, lut, sel)
            assert torch.equal(planes, want_planes) and torch.equal(hist, want_hist)
            if sel is None:
                np.testing.assert_array_equal(hist.cpu().numpy(),
                                              gt_counts_reference(host, n_samples))
            runs += 1
        for mean_impute in (True, False):
            db, n_called = score_dosage(packed, n_samples, flip, mean_impute, sel)
            want_db, want_called = score_dosage_plain(packed, n_samples, flip, mean_impute, sel)
            assert torch.equal(db, want_db) and torch.equal(n_called, want_called)
            score_runs += 1
            if sel is None:
                db, n_called = _score_at_offset(packed, n_samples, flip, mean_impute, 4)
                assert torch.equal(db, want_db) and torch.equal(n_called, want_called)
                score_runs += 1
    torch.cuda.synchronize()
    assert [w.launches for w in OPERAND_WRAPPERS] == [counts[0] + runs, counts[1] + score_runs]


@pytest.mark.parametrize("n_samples", [2503, 2504])
def test_operand_kernels_write_into_out(cuda_device, n_samples):
    """A flat buffer given as out holds the planes (dosages) of a smaller
    block at its front, as the block loops reuse it (K11's tiled form at
    2503 samples, its flat form at 2504)."""
    packed = _packed(40, n_samples, 4, cuda_device)
    lut = torch.tensor(LUT_INT, dtype=torch.float32, device=cuda_device)
    buf = torch.full((3 * 400 * n_samples,), float("nan"), device=cuda_device)
    planes, _ = glm_planes(packed, n_samples, lut, out=buf)
    assert planes.data_ptr() == buf.data_ptr()
    assert torch.equal(planes, glm_planes_plain(packed, n_samples, lut)[0])
    flip = torch.zeros(packed.shape[0], dtype=torch.uint8, device=cuda_device)
    launches = score_dosage.launches
    db, n_called = score_dosage(packed, n_samples, flip, out=buf)
    assert db.data_ptr() == buf.data_ptr()
    want_db, want_called = score_dosage_plain(packed, n_samples, flip)
    assert torch.equal(db, want_db) and torch.equal(n_called, want_called)
    assert score_dosage.launches == launches + 1


def test_glm_moments_with_tf32_on_match_f64(cuda_device):
    """With TF32 switched on for the whole process, the port's moment
    products still run in full fp32: the moments of 2,504 samples agree
    with an f64 numpy product at 2e-5 (TF32's ~1e-3 would not)."""
    rng = np.random.default_rng(7)
    n_samples = 2504
    host = _packed(600, n_samples, 7, "cpu").numpy()
    y = rng.normal(size=n_samples) * 3.0 + 1.0
    covars = rng.normal(size=(n_samples, 2)) * [1.0, 10.0]
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = glm_moments(host, n_samples, y, covars, "cuda", block_variants=256)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    codes = unpack_codes_reference(host, n_samples)
    mask = (codes != 3).astype(np.float64)
    g = np.where(codes == 3, 0, codes).astype(np.float64)
    yc, cc = _centered(y, covars)
    for moments, a, b in ((got.mp, mask, _moment_columns(yc, cc)),
                          (got.gq, g, np.column_stack([yc, cc]))):
        # 2e-5 of each sum, or of its terms' l2 norm where the signed terms
        # cancel: f32 accumulation stays near 1e-6 of that norm, while TF32's
        # 10-bit rounding of the columns puts it near 3e-4. A row with no
        # called sample (byte 0xFF) has no terms: its sums must be 0 exactly.
        want = a @ b
        scale = np.maximum(np.abs(want), np.sqrt((a * a) @ (b * b)))
        err = np.abs(moments - want) / np.maximum(scale, np.finfo(np.float64).tiny)
        assert err.max() <= 2e-5, f"max error {err.max():.3g} of the sums' scale"
    np.testing.assert_array_equal(got.sg2, (g * g).sum(axis=1))


# -- K4 and K10 in their tiled forms ----------------------------------------


def _codes(n_var, n_samples, seed, device):
    """Codes of any byte value (the pack masks each to two bits)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n_var, n_samples), dtype=np.uint8)).to(device)


def _pack_at_offset(codes, in_offset, out_offset):
    """pack_codes' launcher on a copy of ``codes`` that starts ``in_offset``
    bytes past a 16-B boundary, into records ``out_offset`` bytes past one."""
    n_var, n_samples = codes.shape
    rec = (n_samples + 3) // 4
    src = torch.zeros(codes.numel() + in_offset + 16, dtype=torch.uint8, device=codes.device)
    view = src[in_offset : in_offset + codes.numel()].view(n_var, n_samples)
    view.copy_(codes)
    # guard bytes around the records: the kernel must leave them alone
    buf = torch.full((n_var * rec + out_offset + 16,), 0xA5, dtype=torch.uint8,
                     device=codes.device)
    out = buf[out_offset : out_offset + n_var * rec].view(n_var, rec)
    kernels.launch(pack_codes, "pgen_pack_codes", view, view.data_ptr(), out.data_ptr(), n_var,
                   n_samples)
    torch.cuda.synchronize()
    assert bool((buf[:out_offset] == 0xA5).all()) and bool((buf[out_offset + n_var * rec:] == 0xA5).all())
    return out


@pytest.mark.parametrize("n_samples", [2504, 2503, 2502, 2501, 5, 1])
def test_pack_codes_every_row_end(cuda_device, n_samples):
    """K4's flat form (S % 4 == 0) and its staged form at every S % 4: a
    row's last record byte holds zeros past S, never the next row's codes;
    against the plain version and pgen_tpu's host pack of the masked
    codes."""
    codes = _codes(700, n_samples, n_samples, cuda_device)
    got = pack_codes(codes)
    assert torch.equal(got, pack_codes_plain(codes))
    np.testing.assert_array_equal(got.cpu().numpy(), writer_pack_codes(codes.cpu().numpy() & 3))


@pytest.mark.parametrize("in_offset,out_offset", [(1, 0), (4, 0), (8, 0), (0, 1), (0, 4), (3, 7)])
@pytest.mark.parametrize("n_samples", [2504, 2503, 5])
def test_pack_codes_unaligned_spans(cuda_device, n_samples, in_offset, out_offset):
    """Codes or records that start off a 16-B boundary (a view into a larger
    buffer) take the staged form: equal to the plain version, nothing
    written outside the records."""
    codes = _codes(300, n_samples, 7 * n_samples + in_offset, cuda_device)
    assert torch.equal(_pack_at_offset(codes, in_offset, out_offset), pack_codes_plain(codes))


@pytest.mark.parametrize("n_var", [1, 5, 6, 7, 63, 64, 65, 65_537])
@pytest.mark.parametrize("n_samples", [2504, 2503, 5, 1])
def test_pack_codes_ragged_tiles(cuda_device, n_samples, n_var):
    """Row counts around the staged form's tile (6 rows at S = 2503, 64 at
    S <= 256) and past one pass of its blocks; the flat form's last bytes
    when V * R is no multiple of 4."""
    codes = _codes(n_var, n_samples, n_var + n_samples, cuda_device)
    assert torch.equal(pack_codes(codes), pack_codes_plain(codes))


@pytest.mark.parametrize("n_samples,in_offset", [(16_385, 0), (16_387, 0), (32_768, 4),
                                                 (40_003, 3)])
def test_pack_codes_rows_wider_than_a_tile(cuda_device, n_samples, in_offset):
    """S past the staged form's tile (16,384 codes) goes in column tiles of
    one row each: a last tile of 1 and of 3 codes, whole tiles off a 16-B
    boundary (where S % 4 == 0 cannot take the flat form), and three tiles."""
    codes = _codes(9, n_samples, 3, cuda_device)
    assert torch.equal(_pack_at_offset(codes, in_offset, 0), pack_codes_plain(codes))


def _ids(kind, n_kept, n_samples, rng):
    if kind == "sorted":
        return np.sort(rng.permutation(n_samples)[:n_kept])
    if kind == "reversed":
        return np.sort(rng.permutation(n_samples)[:n_kept])[::-1]
    return rng.integers(0, n_samples, n_kept)  # repeats


@pytest.mark.parametrize("kind", ["sorted", "reversed", "repeated"])
@pytest.mark.parametrize("n_kept", [1, 2, 3, 5, 2453, 2454, 2455, 2456])
def test_glm_planes_selected_any_width_and_order(cuda_device, n_kept, kind):
    """K10's tiled form with ``sel`` at every K % 4 (each plane's span of a
    tile starts at any of four alignments), ids sorted, reversed and
    repeated, P = 2 and 3: planes and counts equal to the plain version."""
    rng = np.random.default_rng(n_kept)
    packed = _packed(300, 2504, n_kept, cuda_device)
    sel = torch.from_numpy(np.ascontiguousarray(_ids(kind, n_kept, 2504, rng), dtype=np.int32))
    sel = sel.to(cuda_device)
    for table in (LUT_MOMENTS, LUT_INT):
        lut = torch.tensor(table, dtype=torch.float32, device=cuda_device)
        planes, hist = glm_planes(packed, 2504, lut, sel)
        want_planes, want_hist = glm_planes_plain(packed, 2504, lut, sel)
        assert torch.equal(planes, want_planes) and torch.equal(hist, want_hist)


@pytest.mark.parametrize("n_var", [1, 7, 8, 9, 15, 16, 17, 16_385])
@pytest.mark.parametrize("n_samples", [2504, 2503, 5, 1])
def test_glm_planes_ragged_tiles(cuda_device, n_samples, n_var):
    """Row counts around K10's tile (8 rows at K = 2504, 16 at small K) and
    past one row per block, without ``sel``; a V * K that leaves the second
    and third plane off a 16-B boundary."""
    packed = _packed(n_var, n_samples, n_var, cuda_device)[:n_var]
    lut = torch.tensor(LUT_GENO, dtype=torch.float32, device=cuda_device)
    planes, hist = glm_planes(packed, n_samples, lut)
    want_planes, want_hist = glm_planes_plain(packed, n_samples, lut)
    assert torch.equal(planes, want_planes) and torch.equal(hist, want_hist)
    np.testing.assert_array_equal(hist.cpu().numpy(),
                                  gt_counts_reference(packed.cpu().numpy(), n_samples))


@pytest.mark.parametrize("sel", [False, True])
def test_glm_planes_wide_cohorts(cuda_device, sel):
    """K past one block's 8,192 columns goes in column chunks of one row
    each (a last chunk of 1 column, then of many), the chunks' counts added
    in hist; from 2,561 columns on a tile has fewer rows than the block has
    warps, and several warps share a row."""
    for n_samples in (2_561 + 7, 5_121 + 7, 8_193 + 7, 21_001, 30_003, 120_001):
        packed = _packed(20, n_samples, n_samples, cuda_device)[:37]
        ids = None
        if sel:
            ids = torch.from_numpy(np.random.default_rng(1).permutation(n_samples)[: n_samples - 7]
                                   .astype(np.int32)).to(cuda_device)
        lut = torch.tensor(LUT_MOMENTS, dtype=torch.float32, device=cuda_device)
        planes, hist = glm_planes(packed, n_samples, lut, ids)
        want_planes, want_hist = glm_planes_plain(packed, n_samples, lut, ids)
        assert torch.equal(planes, want_planes) and torch.equal(hist, want_hist)


def _k12_grams_equal_plain(bits, pairs, gen=None):
    """K12's Gram kernel against its plain version on the same bits: each
    set's Grams added into the same random int32 Grams (zeros without
    ``gen``, one Gram at a time, which a wide cohort's memory needs)."""
    s_pad = 16 * bits.shape[1]
    if gen is not None:
        start = torch.randint(-(1 << 20), 1 << 20, (len(pairs), s_pad, s_pad), dtype=torch.int32,
                              device=bits.device, generator=gen)
        got = relatedness_gram(bits, pairs, start.clone())
        assert torch.equal(got, relatedness_gram_plain(bits, pairs, start))
        return got
    got = relatedness_gram(bits, pairs, torch.zeros((len(pairs), s_pad, s_pad),
                                                    dtype=torch.int32, device=bits.device))
    for i, pair in enumerate(pairs):
        want = relatedness_gram_plain(bits, [pair], torch.zeros((1, s_pad, s_pad),
                                                                dtype=torch.int32,
                                                                device=bits.device))
        assert torch.equal(got[i], want[0])
        del want
    return got


def _relatedness_pairs(packed, n_samples, sel, grm=True, gen=True):
    """K12's two kernels and K13 against their plain versions on the same
    records: K12's bits of the records (the cohort's re-packed by K5 first,
    as the scan runs them) and king's and genome's Grams from those bits;
    K13's z and flags. Returns the bits."""
    rows, kept = (packed, n_samples) if sel is None else (subset_repack(packed, sel), sel.shape[0])
    bits = relatedness_bits(rows, kept)
    assert torch.equal(bits, relatedness_bits_plain(rows, kept))
    gen = torch.Generator(device=packed.device).manual_seed(kept) if gen else None
    for pairs in GRAM_SETS:
        _k12_grams_equal_plain(bits, pairs, gen)
    if grm:
        z, used = grm_z(packed, n_samples, sel)
        want_z, want_used = grm_z_plain(packed, n_samples, sel)
        assert torch.equal(z, want_z) and torch.equal(used, want_used)
    return bits


@pytest.mark.parametrize("n_samples", [2509, 2497, 2504, 2503, 2502, 2501, 2505, 17, 8, 5, 1,
                                       9_001])
def test_relatedness_kernels_match_plain(cuda_device, n_samples):
    """K12 and K13 at R % 4 = 0 (2509), 1 (2497, 17, 1), 2 (2501-2504, 8, 5)
    and 3 (2505, 9,001), every S % 4, S below 8 and past K13's 8,192-column
    tiles, without and with a sel holding a
    gap, a duplicate and the last sample, on records whose pad slots hold
    random codes and every byte value sits at every position (0xFF: a row
    with no called sample); V = 556 is no multiple of 8 or 256. K12 launches
    its bits once and its Gram kernel twice (king's and genome's) a case."""
    rng = np.random.default_rng(n_samples)
    packed = _packed(300, n_samples, n_samples, cuda_device)
    counts = [w.launches for w in RELATEDNESS_WRAPPERS]
    cohorts = _cohorts(n_samples, rng, cuda_device)
    for sel in cohorts:
        _relatedness_pairs(packed, n_samples, sel)
    torch.cuda.synchronize()
    n = len(cohorts)
    assert [w.launches for w in RELATEDNESS_WRAPPERS] == [counts[0] + n, counts[1] + 2 * n,
                                                          counts[2] + n]


@pytest.mark.parametrize("n_var", [1, 255, 256, 257, 32_768])
@pytest.mark.parametrize("n_samples", [2504, 2503, 5])
def test_relatedness_kernels_at_row_counts(cuda_device, n_samples, n_var):
    """K12's bits and Grams at V = 1, 255, 256, 257 and 32,768 (the scan's
    block): the rows past V in the last k-step of 256 are code 3, in no
    Gram; the byte-value rows come first."""
    packed = _packed(max(0, n_var - 256), n_samples, n_var, cuda_device).roll(1, 0)[:n_var]
    _relatedness_pairs(packed.contiguous(), n_samples, None, grm=False)


@pytest.mark.parametrize("offset", [1, 3, 4, 8, 15])
@pytest.mark.parametrize("n_samples", [2509, 2504, 2503, 2505, 5])
def test_relatedness_kernels_at_row_offsets(cuda_device, n_samples, offset):
    """K12 and K13 on records 1-15 B past a 16-B boundary, ending at the end
    of their storage; K13 also into z 4 B past a 16-B boundary (its tiled
    form where its flat form would run), nothing written outside it."""
    host = _packed(200, n_samples, 7 * n_samples + offset, "cpu").numpy()
    packed = _records_at(host, offset, cuda_device)
    for rows in (packed, packed[-1:], packed[:9]):
        _relatedness_pairs(rows, n_samples, None)
    n_var = packed.shape[0]
    guard = torch.full((n_var * n_samples + 8,), float("nan"), device=cuda_device)
    z = guard[1 : 1 + n_var * n_samples].view(n_var, n_samples)
    rows = torch.full((3, n_var), -1, dtype=torch.int32, device=cuda_device)
    kernels.launch(grm_z, "pgen_grm_z", packed, packed.data_ptr(), None, z.data_ptr(),
                   rows.data_ptr(), n_var, host.shape[1], n_samples, n_samples)
    want_z, want_used = grm_z_plain(packed, n_samples)
    assert torch.equal(z, want_z) and torch.equal(rows[0], want_used)
    assert torch.isnan(guard[0]) and bool(torch.isnan(guard[1 + z.numel():]).all())


@pytest.mark.parametrize("kind", ["sorted", "reversed", "repeated"])
@pytest.mark.parametrize("n_kept", [1, 2, 17, 1001, 2504, 8_200])
def test_relatedness_kernels_any_ids(cuda_device, n_kept, kind):
    """K12 and K13 with sel sorted, reversed and repeated, K from 1 (one
    sample) to past K13's 8,192-column tiles; K12 on K5's re-packed
    records, whose pad bits are zero (code 0) and count as missing."""
    rng = np.random.default_rng(n_kept)
    packed = _packed(90, 2504, n_kept, cuda_device)
    sel = torch.from_numpy(np.ascontiguousarray(_ids(kind, n_kept, 2504, rng), dtype=np.int32))
    _relatedness_pairs(packed, 2504, sel.to(cuda_device))


@pytest.mark.parametrize("sel", [False, True])
def test_relatedness_kernels_wide_cohorts(cuda_device, sel):
    """40,003 samples, all of them or 40,000 repeated ids (fewer rows than a
    block; each Gram 6.4 GB, held to its plain version one at a time)."""
    packed = _packed(1000, 40_003, 4, cuda_device)
    ids = None
    if sel:
        ids = torch.from_numpy(np.random.default_rng(2).integers(0, 40_003, 40_000)
                               .astype(np.int32)).to(cuda_device)
    _relatedness_pairs(packed, 40_003, ids, gen=False)


@pytest.mark.parametrize("n_samples", [2504, 37, 5])
def test_int_mm_grams_equal_f64_grams(cuda_device, n_samples):
    """torch._int_mm of the CPU scan's int8 planes (a row-major plane by a
    column-major view of another, no copy; at 5 samples the planes' 24
    rows, past the 16 it requires), made on the card, equals the f64
    product of the planes and K12's Grams of the same records, mirrored; and
    king_counts_device and ibd_counts_device on the card equal them on the
    CPU, in blocks, for every sample and for a cohort."""
    packed = _packed(3000, n_samples, 11, cuda_device)
    planes = relatedness_planes_plain(packed, n_samples)
    plain = planes.double()
    bits = relatedness_bits(packed, n_samples)
    for pairs in GRAM_SETS:
        grams = mirror_symmetric(_k12_grams_equal_plain(bits, pairs), pairs)
        for gram, (x, y) in zip(grams, pairs):
            int_mm = torch._int_mm(planes[x], planes[y].t())
            assert torch.equal(int_mm.double(), plain[x] @ plain[y].T)
            assert torch.equal(gram[:n_samples, :n_samples], int_mm[:n_samples, :n_samples])
    host = packed.cpu().numpy()
    idx = np.random.default_rng(3).integers(0, n_samples, max(1, n_samples - 2))
    for fn in (king_counts_device, ibd_counts_device):
        for sample_idx in (None, idx):
            got = fn(host, n_samples, "cuda", block_variants=1024, sample_idx=sample_idx)
            want = fn(host, n_samples, "cpu", block_variants=1024, sample_idx=sample_idx)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_grm_on_the_card_matches_f64(cuda_device):
    """grm_device on the card (K13, z'z and the sums over blocks of 1,000
    rows in f64) against numpy's f64 product of the plain z: within 1e-9 of
    the largest entry (a diagonal one); m_used exact."""
    packed = _packed(3000, 2503, 12, cuda_device)
    host = packed.cpu().numpy()
    got = grm_device(host, 2503, "cuda", block_variants=1000)
    z, used = grm_z_plain(packed.cpu(), 2503)
    z = z.double().numpy()
    assert got.m_used == int(used.sum())
    want = z.T @ z
    assert np.abs(got.grm_sum - want).max() <= 1e-9 * np.abs(want).max()


def test_relatedness_kernels_launch_nothing_when_empty(cuda_device):
    counts = [w.launches for w in RELATEDNESS_WRAPPERS]
    packed = _packed(3, 17, 0, cuda_device)
    sel = torch.empty(0, dtype=torch.int32, device=cuda_device)
    z, used = grm_z(packed, 17, sel)
    assert z.shape == (259, 0) and not used.any()
    z, used = grm_z(packed[:0], 17)
    assert z.shape == (0, 17) and used.shape == (0,)
    bits = relatedness_bits(packed[:0], 17)  # no row: no k-step
    assert bits.shape == (2, 8, 0, 128)
    grams = torch.zeros((4, 128, 128), dtype=torch.int32, device=cuda_device)
    assert not relatedness_gram(bits, GRAM_SETS[0], grams).any()
    got = king_counts_device(packed.cpu().numpy(), 17, "cuda", sample_idx=np.empty(0, np.int32))
    assert all(g.shape == (0, 0) for g in got)
    assert [w.launches for w in RELATEDNESS_WRAPPERS] == counts


def test_relatedness_gram_refuses_unaligned_grams_and_other_pairs(cuda_device):
    """On the card, as on the CPU, relatedness_gram takes Grams and bits
    that start on 16 B (the bulk reductions' addresses) and king's or
    genome's pairs only; the library refuses a Gram 8 B past 16 B by itself
    too (cudaErrorMisalignedAddress); nothing launches."""
    bits = relatedness_bits(_packed(40, 17, 6, cuda_device), 17)
    pairs = GRAM_SETS[0]
    counts = [w.launches for w in RELATEDNESS_WRAPPERS]
    flat = torch.zeros(len(pairs) * 128 * 128 + 4, dtype=torch.int32, device=cuda_device)
    for offset in (1, 2, 3):
        grams = flat[offset : offset + len(pairs) * 128 * 128].view(len(pairs), 128, 128)
        with pytest.raises(ValueError, match="16 B"):
            relatedness_gram(bits, pairs, grams)
    grams = flat[2 : 2 + len(pairs) * 128 * 128]
    status = kernels.load().pgen_relatedness_gram(
        bits.data_ptr(), grams.data_ptr(), bits.shape[1], bits.shape[2], 0,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    assert status == 716  # cudaErrorMisalignedAddress
    with pytest.raises(ValueError, match="GRAM_SETS"):
        relatedness_gram(bits, pairs[::-1], flat[:len(pairs) * 128 * 128].view(len(pairs), 128, 128))
    with pytest.raises(ValueError, match="GRAM_SETS"):
        relatedness_grams(_packed(40, 17, 6, "cpu").numpy(), 17, "cuda", pairs[:3], 1024)
    torch.cuda.synchronize()
    assert not flat.any()
    assert [w.launches for w in RELATEDNESS_WRAPPERS] == counts


def test_interaction_beta_on_the_card_within_pgen_tpu_tolerance(cuda_device, monkeypatch):
    """X3 on the card (f64 products) against pgen_tpu's numpy provider (f64
    host moments) on the same inputs: BETA and SE inside pgen_tpu's rtol
    2e-4, atol 1e-6 alone, with a covariate near 50."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # before pgen_tpu.ops.glm imports jax
    from pgen_tpu.ops.glm import glm_linear_interaction as tpu_interaction
    from pgen_tpu_torch.ops.glm import glm_linear_interaction

    rng = np.random.default_rng(50)
    n_var, n_samples = 4000, 2504
    host = _packed(n_var, n_samples, 50, "cpu").numpy()[:n_var]
    c1, c2 = rng.normal(size=n_samples), rng.normal(50.0, 8.0, size=n_samples)
    y = 0.3 * c1 + 0.02 * c2 + rng.normal(size=n_samples)
    covars = np.column_stack([c1, c2])
    got = glm_linear_interaction(host, n_samples, y, covars, "cuda")
    want = tpu_interaction(host, n_samples, y, covars, provider="numpy")
    np.testing.assert_array_equal(got.n_obs, want.n_obs)
    assert (np.abs(want.beta[:, 0]) < 0.01 * want.se[:, 0]).sum() >= 5
    np.testing.assert_allclose(got.beta, want.beta, rtol=2e-4, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.se, want.se, rtol=2e-4, atol=1e-6, equal_nan=True)


# ---- K15 ld_r2_band, the streamed band, and K13's --approx pass ----


def _ld_equal(packed, n_samples, band, n_out=None):
    """K15 against its plain version on the same records: bit for bit."""
    got = ld_r2_band(packed, n_samples, band, n_out)
    want = ld_r2_band_plain(packed, n_samples, band, n_out)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    return got


def _ld_records(n_var, n_samples, seed, device):
    """_packed's records with every third row a copy of the one before, a
    few bytes redrawn, so the band holds r² near 1 beside random ones."""
    host = _packed(n_var, n_samples, seed, "cpu").numpy()
    host[1:-256:3] = host[0:-257:3][: len(host[1:-256:3])]
    width = min(2, host.shape[1])
    host[1:-256:3, :width] = np.random.default_rng(seed).integers(
        0, 256, (len(host[1:-256:3]), width))
    return torch.from_numpy(host).to(device)


@pytest.mark.parametrize("band", [1, 9, 49, 50, 420])
@pytest.mark.parametrize("n_samples", [2504, 2503, 2497, 95, 33, 5, 1])
def test_ld_r2_band_matches_plain(cuda_device, n_samples, band):
    """K15 at every n-tile count it is built for (band 1: 2, 9: 3, 49 and
    past it: 8, in tiles of 49 offsets), S % 32 = 0, 1, 8, 31 and S < 8,
    on records whose every byte value sits at every position (0xFF rows; pad
    slots random): all rows, then 300 output rows (the pairs past the
    records' end missing); one launch a call."""
    packed = _ld_records(700, n_samples, n_samples + band, cuda_device)
    before = ld_r2_band.launches
    got = _ld_equal(packed, n_samples, band)
    _ld_equal(packed, n_samples, band, 300)
    _ld_equal(packed[:40], n_samples, band, 60)
    assert ld_r2_band.launches == before + 3
    if n_samples > 2000:  # 8 samples redrawn
        assert got[0:600:3, 0].min() > 0.5  # the planted copies


def test_ld_r2_band_max_band(cuda_device):
    """MAX_BAND (pipeline/prune.py) on 300 output rows of 2504 samples."""
    from pgen_tpu_torch.pipeline.prune import MAX_BAND

    packed = _ld_records(300 + MAX_BAND - 256, 2504, 8, cuda_device)
    _ld_equal(packed, 2504, MAX_BAND, 300)


@pytest.mark.parametrize("offset", range(1, 16))
def test_ld_r2_band_at_row_offsets(cuda_device, offset):
    """Records 1-15 B past a 16-B boundary, ending at the end of their
    storage (a row's last chunk copies the aligned words that hold it and
    nothing past the allocation), whole, one row and nine."""
    host = _packed(200, 2503, offset, "cpu").numpy()
    packed = _records_at(host, offset, cuda_device)
    for rows in (packed, packed[-1:], packed[:9]):
        for band in (9, 49):
            _ld_equal(rows, 2503, band)


@pytest.mark.parametrize("n_samples", [40_003, 9_001])
def test_ld_r2_band_wide_rows(cuda_device, n_samples):
    packed = _ld_records(300, n_samples, 4, cuda_device)
    for band in (9, 49):
        _ld_equal(packed, n_samples, band)


def test_ld_r2_band_launches_nothing_when_empty(cuda_device):
    before = ld_r2_band.launches
    packed = _packed(3, 17, 0, cuda_device)
    assert ld_r2_band(packed, 17, 0).shape == (259, 0)
    assert ld_r2_band(packed, 17, 5, 0).shape == (0, 5)
    assert not ld_r2_band(packed, 0, 5).any()
    assert ld_r2_band(packed[:0], 17, 5).shape == (0, 5)
    assert ld_r2_band.launches == before


@pytest.mark.parametrize("band,block_rows", [(9, 1000), (49, 500), (1, 64), (300, 700)])
def test_banded_r2_on_the_card_matches_cpu(cuda_device, band, block_rows):
    """The streamed band on the card (K5 under a cohort, K15) against the
    same on the CPU (the plain versions) bit for bit, and against numpy's
    f64 band at pgen_tpu's device tolerance (rtol 1e-4, atol 1e-6), all
    samples and cohorts sorted, unsorted and repeated; 2,999 rows with
    every 3rd a near copy of the one before, no block a multiple of the
    band."""
    rng = np.random.default_rng(band)
    host = _packed(2999 - 256, 2503, band, "cpu").numpy()
    host[1::3] = host[0:-1:3][: len(host[1::3])]
    host[1::3, :7] = rng.integers(0, 256, (len(host[1::3]), 7), dtype=np.uint8)
    for idx in (None, np.sort(rng.choice(2503, 1001, replace=False)),
                rng.permutation(2503)[:1001], rng.integers(0, 2503, 1200)):
        idx = None if idx is None else idx.astype(np.int32)
        before, repacks = ld_r2_band.launches, subset_repack.launches
        got = banded_r2(host, 2503, band, "cuda", sample_idx=idx, block_rows=block_rows)
        blocks = -(-host.shape[0] // block_rows)
        assert ld_r2_band.launches == before + blocks
        assert subset_repack.launches == repacks + (0 if idx is None else blocks)
        want = banded_r2(host, 2503, band, "cpu", sample_idx=idx, block_rows=block_rows)
        np.testing.assert_array_equal(got, want)
        oracle = banded_r2_numpy(host[:600], 2503, band, sample_idx=idx)
        np.testing.assert_allclose(got[: 600 - band], oracle[: 600 - band], rtol=1e-4, atol=1e-6)
        assert got[: 2999 - 256 : 3, 0].min() > 0.5  # the planted copies of random rows


def _pass_pair(packed, n_samples, q):
    """K13's pass against its plain version on the card, each from the same
    y0 at the scale of y (so that a pass that lost y0 shows): used exact, y
    within approx_pass_tolerance; the kernel's y again from y0 equal to its
    first bit for bit. Returns the kernel's y."""
    scale = torch.zeros((n_samples, q.shape[1]), device=q.device)
    pca_approx_pass_plain(packed, n_samples, q, scale, torch.zeros((), dtype=torch.int64,
                                                                   device=q.device))
    y0 = torch.randn(scale.shape, device=q.device) * max(float(scale.std()), 1.0)
    got, want = y0.clone(), y0.clone()
    used = torch.zeros((), dtype=torch.int64, device=q.device)
    used_plain = used.clone()
    pca_approx_pass(packed, n_samples, q, got, used)
    pca_approx_pass_plain(packed, n_samples, q, want, used_plain)
    assert int(used) == int(used_plain)
    tol = approx_pass_tolerance(packed, n_samples, q, y0)
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    again = y0.clone()
    pca_approx_pass(packed, n_samples, q, again, torch.zeros_like(used))
    assert torch.equal(again, got)
    return got


@pytest.mark.parametrize("n_cols", [18, 4, 25, 50])
@pytest.mark.parametrize("n_samples", [2504, 2503, 1001, 33, 5, 1])
def test_pca_approx_pass_matches_plain(cuda_device, n_samples, n_cols):
    """K13's pass at q's widths of one chunk of columns (18: pca -k 10's,
    4) and of several (25, 50: 24 a chunk), every S % 4 and S < 8, on
    records whose every byte value sits at every position (0xFF: a row with
    no called sample; monomorphic rows unused), y starting non-zero; one
    launch a call."""
    packed = _packed(900, n_samples, n_samples + n_cols, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n_samples)
    q = torch.randn((n_samples, n_cols), device=cuda_device, generator=gen)
    before = pca_approx_pass.launches
    _pass_pair(packed, n_samples, q)
    _pass_pair(packed[:7], n_samples, q)
    assert pca_approx_pass.launches == before + 4


def test_pca_approx_pass_block_rows(cuda_device):
    """A 16,384-row block (32 chunks of rows a slice), one of 16,385, and
    one of 107,202 (--approx's 64 MiB block of 2504 samples)."""
    packed = _packed(16_385 - 256, 2504, 3, cuda_device)
    q = torch.randn((2504, 18), device=cuda_device)
    _pass_pair(packed, 2504, q)
    _pass_pair(packed[:16_384], 2504, q)
    _pass_pair(_packed(107_202 - 256, 2504, 4, cuda_device), 2504, q)


@pytest.mark.parametrize("offset", [1, 3, 4, 8, 15])
def test_pca_approx_pass_at_row_offsets(cuda_device, offset):
    host = _packed(200, 2503, 11 * offset, "cpu").numpy()
    packed = _records_at(host, offset, cuda_device)
    q = torch.randn((2503, 18), device=cuda_device)
    for rows in (packed, packed[-1:], packed[:9]):
        _pass_pair(rows, 2503, q)


def test_pca_approx_pass_wide_rows(cuda_device):
    """40,003 samples: q's rows staged in chunks (3.2 MB of them)."""
    packed = _packed(300, 40_003, 5, cuda_device)
    q = torch.randn((40_003, 18), device=cuda_device)
    _pass_pair(packed, 40_003, q)


def test_pca_approx_pass_launches_nothing_when_empty(cuda_device):
    before = pca_approx_pass.launches
    packed = _packed(3, 17, 0, cuda_device)
    used = torch.zeros((), dtype=torch.int64, device=cuda_device)
    y = torch.zeros((17, 4), device=cuda_device)
    pca_approx_pass(packed[:0], 17, torch.zeros((17, 4), device=cuda_device), y, used)
    pca_approx_pass(packed, 17, torch.zeros((17, 0), device=cuda_device), y[:, :0], used)
    assert pca_approx_pass.launches == before and not y.any() and int(used) == 0


@pytest.mark.parametrize("widths", [(2505, 7), (2506, 7), (2507, 7), (5, 6, 3)],
                         ids=lambda w: "-".join(map(str, w)))
def test_merge_splice_on_the_card(cuda_device, widths):
    """merge's splice: K1 on each input's rows, torch.cat on the sample axis
    and K4, on the card, against the plain versions on the CPU and
    pgen_tpu's numpy codecs; a first input of 4k+1, 4k+2 or 4k+3 samples
    shifts the next one's codes inside the packed byte."""
    from pgen_tpu_torch.ops.unpack import decode_rows
    from pgen_tpu_torch.utils.timer import StageTimer

    hosts = [_packed(300, w, k, "cpu").numpy() for k, w in enumerate(widths)]
    rows = np.arange(hosts[0].shape[0])
    got, want = [], []
    for dev, out in ((cuda_device, got), (torch.device("cpu"), want)):
        before = (unpack_codes.launches, pack_codes.launches)
        streams = [decode_rows(h, rows, w, dev, 128, None, StageTimer())
                   for h, w in zip(hosts, widths)]
        for blocks in zip(*streams):
            out.append(pack_codes(torch.cat([c for _, _, c in blocks], 1).contiguous()).cpu())
        if dev.type == "cuda":
            n_blocks = -(-rows.size // 128)  # 556 rows: 5 blocks
            assert unpack_codes.launches == before[0] + n_blocks * len(widths)
            assert pack_codes.launches == before[1] + n_blocks
    got, want = torch.cat(got).numpy(), torch.cat(want).numpy()
    np.testing.assert_array_equal(got, want)
    codes = np.hstack([unpack_codes_reference(h, w) for h, w in zip(hosts, widths)])
    np.testing.assert_array_equal(got, writer_pack_codes(codes))


@pytest.mark.parametrize("n_samples", [2505, 2506, 2507])
@pytest.mark.parametrize("kept", ["all", "cohort"])
def test_export_sample_major_on_the_card(cuda_device, n_samples, kept):
    """export's decode: K1 on the kept rows, the kept samples taken and the
    block transposed on the card, one (samples, block) copy a block, against
    the same on the CPU and a numpy decode of the records."""
    from pgen_tpu_torch.pipeline.export_raw import _sample_major
    from pgen_tpu_torch.utils.timer import StageTimer

    host = _packed(1000, n_samples, n_samples, "cpu").numpy()
    rng = np.random.default_rng(n_samples)
    var_idx = np.sort(rng.choice(host.shape[0], 900, replace=False))
    sam_idx = (np.arange(n_samples) if kept == "all"
               else np.sort(rng.choice(n_samples, 1001, replace=False)))
    before = unpack_codes.launches
    got = _sample_major(host, var_idx, sam_idx, n_samples, cuda_device, 256, StageTimer())
    assert unpack_codes.launches == before + 4
    want = _sample_major(host, var_idx, sam_idx, n_samples, torch.device("cpu"), 256,
                         StageTimer())
    np.testing.assert_array_equal(got, want)
    oracle = unpack_codes_reference(host[var_idx], n_samples)[:, sam_idx].T
    np.testing.assert_array_equal(got, oracle)


def _small_fileset(d, n_var: int, n_samples: int, seed: int) -> str:
    """A fileset of random records (pad bits too) with plain .pvar/.psam."""
    from pgen_tpu.formats.writer import write_pgen_packed

    rng = np.random.default_rng(seed)
    prefix = str(d / "fs")
    rec = (n_samples + 3) // 4
    write_pgen_packed(f"{prefix}.pgen", rng.integers(0, 256, (n_var, rec), dtype=np.uint8),
                      n_samples)
    with open(f"{prefix}.pvar", "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.writelines(f"1\t{100 + i}\trs{i}\tA\tG\t.\t.\t.\n" for i in range(n_var))
    with open(f"{prefix}.psam", "w") as f:
        f.write("#IID\tSEX\n")
        f.writelines(f"s{i}\t{1 + i % 2}\n" for i in range(n_samples))
    return prefix


@pytest.mark.parametrize("kept", ["all", "two"])
def test_threads_launch_on_their_own_streams(cuda_device, tmp_path, monkeypatch, kept):
    """--threads 2 (emit_threads): each thread launches K2/K3 on a stream of
    its own, every block once; the file equals one thread's and the CPU's."""
    from pgen_tpu_torch.ops import gt_text
    from pgen_tpu_torch.pipeline.filter import filter_to_vcf

    prefix = _small_fileset(tmp_path, 1000, 2503, seed=3)
    query = None if kept == "all" else 'IID == "s7" || IID == "s2000"'
    seen = []
    real = gt_text.launch

    def spy(wrapper, symbol, t, *args):
        seen.append(torch.cuda.current_stream(t.device).cuda_stream)
        real(wrapper, symbol, t, *args)

    monkeypatch.setattr(gt_text, "launch", spy)
    for name, device, threads in (("t2", cuda_device, 2), ("t1", cuda_device, 1),
                                  ("cpu", "cpu", 2)):
        filter_to_vcf(prefix, sam_query=query, out_file=tmp_path / f"{name}.vcf", device=device,
                      block_variants=96, emit_threads=threads)
        if name == "t2":
            two = list(seen)
    assert len(two) == 11  # ceil(1000 / 96) blocks, each launched once
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert len(set(two)) == 2 and default not in two
    got = (tmp_path / "t2.vcf").read_bytes()
    assert got == (tmp_path / "t1.vcf").read_bytes() == (tmp_path / "cpu.vcf").read_bytes()


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two CUDA cards")
def test_worker_on_the_second_card(tmp_path):
    """filter_to_vcf_parallel with device cuda:1: each worker runs its shard
    on card 1 (its peak device bytes are card 1's), under a timeout, and
    the file equals the CPU's."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    prefix = _small_fileset(tmp_path, 1000, 2503, seed=5)
    repo = str(Path(__file__).resolve().parent.parent)
    code = (
        f"import json, sys\nsys.path.insert(0, {repo!r})\n"
        "from pgen_tpu_torch.parallel import shard\n"
        "from pgen_tpu_torch.pipeline.filter import filter_to_vcf\n"
        f"res = shard.filter_to_vcf_parallel({prefix!r}, out_file={str(tmp_path / 'w.vcf')!r}, "
        "device='cuda:1', num_workers=2, block_variants=96)\n"
        f"filter_to_vcf({prefix!r}, out_file={str(tmp_path / 'c.vcf')!r}, device='cpu')\n"
        "print(json.dumps(res.worker_reports))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    reports = json.loads(r.stdout.splitlines()[-1])
    assert sorted(reports) == ["0", "1"]
    # 500 rows a shard in blocks of 96: 6 launches of K2 in each worker
    assert all(x["genotype_text"] == 6 and x["device_peak"] > 0 for x in reports.values())
    assert (tmp_path / "w.vcf").read_bytes() == (tmp_path / "c.vcf").read_bytes()
