"""The port's genotype counts (pgen_tpu_torch.ops.gt_stats) and its
compute_masks against pgen_tpu's.

K8's and K9's plain versions (what a CPU tensor runs) are held with exact
equality against pgen_tpu's gt_counts_device and sample_counts_device (the
Pallas unpack in interpret mode, then a one-hot sum) and its numpy oracles,
on records made from a seed with numpy, pad slots holding random codes. The
port's compute_masks on device="cpu" is held against pgen_tpu's with
provider="device" on the --maf/--geno/--hwe/--mind queries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_fileset
from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.formats.writer import write_pgen_packed
from pgen_tpu.ops import gt_stats as jax_gt_stats
from pgen_tpu.pipeline.filter import compute_masks as tpu_compute_masks
from pgen_tpu_torch.ops.gt_stats import (
    gt_counts,
    gt_counts_device,
    gt_counts_plain,
    sample_counts,
    sample_counts_device,
    sample_counts_plain,
)
from pgen_tpu_torch.pipeline.filter import compute_masks

# every S % 4, and records of 625-628 bytes (R % 4 = 1, 2, 3, 0), the word
# columns K9 reads its rows by
WIDTHS = [1, 2, 3, 4, 5, 6, 7, 33, 2503, 2504, 2497, 2501, 2502, 2505, 2509]


def _packed(n_var, n_samples, seed):
    """Random records, random codes in the pad slots of the last byte; the
    last 256 rows each repeat one byte value."""
    rec = (2 * n_samples + 7) // 8
    packed = np.random.default_rng(seed).integers(0, 256, size=(n_var + 256, rec), dtype=np.uint8)
    packed[n_var:] = np.arange(256, dtype=np.uint8)[:, None]
    return packed


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_gt_counts_matches_pallas_and_oracle(n_samples):
    packed = _packed(11, n_samples, seed=n_samples)
    got = gt_counts_device(torch.from_numpy(packed), n_samples)
    assert got.dtype == torch.int32 and got.shape == (packed.shape[0], 4)
    want = jax_gt_stats.gt_counts_device(jnp.asarray(packed), n_samples, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), jax_gt_stats.gt_counts_reference(packed, n_samples))
    assert (got.sum(1) == n_samples).all()  # pad slots excluded


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_sample_counts_matches_pallas_and_oracle(n_samples):
    """267 rows, then 1 and 333 (no multiple of K9's 16 warps, its 4-row
    loads or its 12-row fields)."""
    packed = _packed(11, n_samples, seed=50 + n_samples)
    for rows in (packed, packed[-1:], np.concatenate([packed, packed[:66]])):
        got = sample_counts_device(torch.from_numpy(rows), n_samples)
        assert got.dtype == torch.int32 and got.shape == (n_samples, 4)
        want = jax_gt_stats.sample_counts_device(jnp.asarray(rows), n_samples, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      jax_gt_stats.sample_counts_reference(rows, n_samples))
        assert (got.sum(1) == rows.shape[0]).all()


def test_counts_of_fewer_samples_than_slots():
    """num_samples below 4R - 3 cuts whole trailing bytes, as the unpack's
    [:, :S] slice does."""
    packed = _packed(5, 40, seed=1)
    for s in (0, 1, 17, 37):
        t = torch.from_numpy(packed)
        np.testing.assert_array_equal(gt_counts_device(t, s).numpy(),
                                      jax_gt_stats.gt_counts_reference(packed, s))
        np.testing.assert_array_equal(sample_counts_device(t, s).numpy(),
                                      jax_gt_stats.sample_counts_reference(packed, s))


@pytest.mark.parametrize("offset", range(16))
def test_gt_counts_offset_views_match_pallas(offset):
    """Records that start at any byte of a buffer (a block cut from a
    staging tensor), R % 4 = 0..3: the plain version equal to pgen_tpu's
    gt_counts_device, the Pallas unpack in interpret mode."""
    for n_samples in (2504, 2497, 2505, 2509, 5):
        packed = _packed(5, n_samples, seed=offset + n_samples)
        buf = torch.from_numpy(np.full(packed.size + 32, 0xA5, dtype=np.uint8))
        view = buf[offset : offset + packed.size].view(packed.shape)
        view.copy_(torch.from_numpy(packed))
        got = gt_counts_device(view, n_samples)
        want = jax_gt_stats.gt_counts_device(jnp.asarray(packed), n_samples, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_samples", [1, 2, 17, 37, 157])
def test_gt_counts_fewer_samples_than_slots_match_pallas(n_samples):
    """S below 4R - 3 on 40-byte records: whole trailing bytes are pad, and
    the plain version counts only [0, S), as pgen_tpu's Pallas path does."""
    packed = _packed(5, 160, seed=n_samples)
    got = gt_counts_device(torch.from_numpy(packed), n_samples)
    want = jax_gt_stats.gt_counts_device(jnp.asarray(packed), n_samples, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(1) == n_samples).all()


def test_empty_and_plain_versions():
    empty = torch.empty((0, 3), dtype=torch.uint8)
    assert gt_counts_device(empty, 9).shape == (0, 4)
    assert torch.equal(sample_counts_device(empty, 9), torch.zeros((9, 4), dtype=torch.int32))
    t = torch.from_numpy(_packed(3, 9, seed=2))
    assert torch.equal(gt_counts_device(t, 9), gt_counts_plain(t, 9))
    assert torch.equal(sample_counts_device(t, 9), sample_counts_plain(t, 9))
    with pytest.raises(ValueError):
        gt_counts_device(t, 13)  # 13 samples do not fit 3-byte records


@pytest.mark.parametrize("block_rows", [1, 7, 1 << 16])
def test_streamed_counts_match_pgen_tpu(block_rows):
    """gt_counts/sample_counts over a read-only memory map, in ragged blocks,
    as int64 numpy: pgen_tpu's gt_counts/sample_counts with provider device."""
    packed = _packed(40, 23, seed=block_rows)
    mm = np.frombuffer(packed.tobytes(), dtype=np.uint8).reshape(packed.shape)
    got = gt_counts(mm, 23, "cpu", block_rows=block_rows)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_gt_stats.gt_counts(packed, 23, "device"))
    got = sample_counts(mm, 23, "cpu", block_rows=block_rows)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_gt_stats.sample_counts(packed, 23, "device"))


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    """61 variants x 30 samples of random record bytes (pad slots included)."""
    d = tmp_path_factory.mktemp("gts")
    rng = np.random.default_rng(61)
    n_var, n_samples = 61, 30
    prefix = build_fileset(
        d, "g", np.zeros((n_var, n_samples), dtype=np.uint8),
        [f"1\t{100 + i}\trs{i}\tA\t{'GC'[i % 2]}\t.\t.\t." for i in range(n_var)],
        [f"s{i}\t{'F' if i % 3 else 'M'}" for i in range(n_samples)],
    )
    write_pgen_packed(f"{prefix}.pgen", rng.integers(0, 256, (n_var, 8), dtype=np.uint8), n_samples)
    header = read_pgen_header(f"{prefix}.pgen")
    pvar, psam = read_metadata(f"{prefix}.pvar"), read_metadata(f"{prefix}.psam")
    records = np.memmap(f"{prefix}.pgen", dtype=np.uint8, mode="r", offset=12, shape=(n_var, 8))
    return pvar, psam, header, records


@pytest.mark.parametrize(
    "var_query,sam_query",
    [
        ("GT_MAF >= 0.45", None),  # --maf
        ("GT_MISSING_RATE <= 0.24", None),  # --geno
        ("GT_HWE_P >= 0.3", None),  # --hwe
        ("GT_HWE_MIDP >= 0.3", None),  # --hwe --hwe-midp
        (None, "GT_MISSING_RATE <= 0.25"),  # --mind
        ("GT_MAF >= 0.45", "GT_MISSING_RATE <= 0.25"),  # --mind, then cohort-aware --maf
        ("GT_AC > 20 && ALT == \"G\"", 'SEX == "F"'),  # cohort subset
        ('ALT == "G"', 'IID != "s3"'),  # no GT_* variable
        ("dup_first_within((GT_NOBS > 20))", None),
    ],
)
def test_compute_masks_matches_pgen_tpu_device(fileset, var_query, sam_query):
    pvar, psam, header, records = fileset
    got = compute_masks(var_query, sam_query, pvar, psam, header, records, "cpu")
    want = tpu_compute_masks(var_query, sam_query, pvar, psam, header, records, "device")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[0].sum() < len(got[0]) or var_query is None
