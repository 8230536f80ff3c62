"""The port's pack ops (pgen_tpu_torch.ops.pack) and its two off-path text
entry points (genotype_text_from_codes, genotype_text_transposed) against
pgen_tpu's.

On CPU tensors the wrappers run their plain PyTorch versions, which are held
with exact equality against pgen_tpu's Pallas kernels in interpret mode: P3
``pack_codes_device``, P1 then an XLA take then P3 (the device branch of
``pgen_out._subset_block``), P2 ``genotype_text_from_codes`` and the lab
kernel P4 ``fused_text_lab.genotype_text_transposed``; and against the numpy
packer ``formats.writer.pack_codes``. Inputs are made from a seed with
numpy. The CUDA kernels run only on a card (test_torch_kernels.py).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgen_tpu.formats.writer import pack_codes as writer_pack_codes
from pgen_tpu.ops import gt_text as jax_gt_text
from pgen_tpu.ops import unpack as jax_unpack
from pgen_tpu.ops.pack import pack_codes_device
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu_torch.ops.gt_text import (
    genotype_text_from_codes,
    genotype_text_transposed,
    genotype_text_transposed_plain,
    text_from_codes_plain,
)
from pgen_tpu_torch.ops.pack import (
    pack_codes,
    pack_codes_plain,
    subset_repack,
    subset_repack_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from fused_text_lab import genotype_text_transposed as jax_text_transposed  # noqa: E402

WIDTHS = [1, 3, 4, 5, 30, 2501, 2502, 2503, 2504]
WRAPPERS = (pack_codes, subset_repack, genotype_text_from_codes, genotype_text_transposed)


def _codes(n_var, n_samples, seed):
    return np.random.default_rng(seed).integers(0, 4, size=(n_var, n_samples), dtype=np.uint8)


def _packed(n_var, n_samples, seed):
    """Random records, pad bits in the last byte included (as in real files)."""
    rec = (2 * n_samples + 7) // 8
    return np.random.default_rng(seed).integers(0, 256, size=(n_var, rec), dtype=np.uint8)


def _jax_subset_repack(packed, sel):
    """The device branch of pgen_tpu's _subset_block: P1, take, P3."""
    codes = jax_unpack.unpack_codes(jnp.asarray(packed), 4 * packed.shape[1], interpret=True)
    return np.asarray(pack_codes_device(codes[:, jnp.asarray(sel)], interpret=True))


def _port_subset_repack(packed, sel):
    return subset_repack(torch.from_numpy(packed), torch.from_numpy(sel)).numpy()


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_pack_codes_matches_pallas_and_writer(n_samples):
    codes = _codes(11, n_samples, seed=n_samples)
    got = pack_codes(torch.from_numpy(codes)).numpy()
    assert got.shape == (11, (n_samples + 3) // 4)
    np.testing.assert_array_equal(
        got, np.asarray(pack_codes_device(jnp.asarray(codes), interpret=True))
    )
    np.testing.assert_array_equal(got, writer_pack_codes(codes))


def test_pack_codes_masks_every_byte_value_as_pallas():
    """Codes past 3 keep their low two bits, as _pack_kernel's & 3 does:
    every byte value at every position of a word, and a ragged tail."""
    codes = np.stack([np.roll(np.arange(256, dtype=np.uint8), k) for k in range(4)])
    for width in (256, 255, 254, 253):
        c = np.ascontiguousarray(codes[:, :width])
        np.testing.assert_array_equal(
            pack_codes(torch.from_numpy(c)).numpy(),
            np.asarray(pack_codes_device(jnp.asarray(c), interpret=True)),
        )


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_pack_inverts_unpack(n_samples):
    """pack∘unpack is the identity on the codes; the pad bits come out zero."""
    packed = _packed(9, n_samples, seed=300 + n_samples)
    codes = unpack_codes_reference(packed, n_samples)
    repacked = pack_codes(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(unpack_codes_reference(repacked, n_samples), codes)
    pad = 2 * (4 * packed.shape[1] - n_samples)
    if pad:
        assert not (repacked[:, -1] >> (8 - pad)).any()


@pytest.mark.parametrize("order", ["ascending", "permuted", "single"])
@pytest.mark.parametrize("n_samples", WIDTHS)
def test_subset_repack_matches_jax(n_samples, order):
    packed = _packed(9, n_samples, seed=400 + n_samples)
    rng = np.random.default_rng(n_samples)
    if order == "single":
        sel = np.array([n_samples - 1], dtype=np.int32)
    else:
        sel = rng.permutation(n_samples)[: max(1, (2 * n_samples) // 3)].astype(np.int32)
        if order == "ascending":
            sel = np.sort(sel)
    got = _port_subset_repack(packed, sel)
    assert got.shape == (9, (len(sel) + 3) // 4)
    np.testing.assert_array_equal(got, _jax_subset_repack(packed, sel))


def test_subset_repack_repeats_and_pad_ids():
    """Repeated ids, and ids in the source's pad slots [S, 4R), which the
    kernel accepts as the JAX take does."""
    packed = _packed(5, 11, seed=9)
    sel = np.array([10, 0, 10, 4, 3, 11], dtype=np.int32)
    np.testing.assert_array_equal(
        _port_subset_repack(packed, sel), _jax_subset_repack(packed, sel)
    )


def _offset_view(host, offset):
    """A CPU tensor view of ``host``'s bytes that starts ``offset`` bytes into
    a larger buffer (a block cut from a staging tensor), same shape."""
    buf = torch.from_numpy(np.full(host.size + 32, 0xA5, dtype=np.uint8))
    view = buf[offset : offset + host.size].view(host.shape)
    view.copy_(torch.from_numpy(host))
    return view


@pytest.mark.parametrize("offset", range(16))
def test_subset_repack_offset_views_match_jax(offset):
    """Records that start at any byte of a buffer, rows of R % 4 = 0..3 (S =
    2504, 2497, 2505 and 2509 give R = 626, 625, 627 and 628), K = 1,001
    sorted and 2 reversed: the plain version (what a CPU tensor runs) equal
    to pgen_tpu's P1, take, P3."""
    for n_samples in (2504, 2497, 2505, 2509):
        packed = _packed(7, n_samples, seed=offset + n_samples)
        ids = np.sort(np.random.default_rng(offset).permutation(n_samples)[:1001])
        for sel in (ids.astype(np.int32), ids[:2][::-1].astype(np.int32).copy()):
            got = subset_repack(_offset_view(packed, offset), torch.from_numpy(sel)).numpy()
            np.testing.assert_array_equal(got, _jax_subset_repack(packed, sel))


@pytest.mark.parametrize("kind", ["reversed", "repeated", "unsorted"])
@pytest.mark.parametrize("n_samples", [1, 5, 2503, 2504])
def test_subset_repack_id_orders_match_jax(n_samples, kind):
    """Ids reversed, repeated (K past S, so K % 4 and out_rec past R too) and
    unsorted, at S of 1 and 5 (a row shorter than a 16-B word) and chr22's
    widths: equal to pgen_tpu's P1, take, P3."""
    rng = np.random.default_rng(7 * n_samples)
    ascending = np.sort(rng.permutation(n_samples)[: max(1, (3 * n_samples) // 4)])
    sel = {"reversed": ascending[::-1],
           "repeated": rng.integers(0, n_samples, n_samples + 7),
           "unsorted": rng.permutation(n_samples)}[kind]
    sel = np.ascontiguousarray(sel, dtype=np.int32)
    packed = _packed(9, n_samples, seed=900 + n_samples)
    got = _port_subset_repack(packed, sel)
    assert got.shape == (9, (len(sel) + 3) // 4)
    np.testing.assert_array_equal(got, _jax_subset_repack(packed, sel))


def test_genotype_text_from_codes_all_byte_values():
    codes = np.arange(256, dtype=np.uint8).reshape(2, 128)
    got = genotype_text_from_codes(torch.from_numpy(codes)).numpy()
    want = np.asarray(jax_gt_text.genotype_text_from_codes(jnp.asarray(codes), interpret=True))
    assert got.shape == (2, 512)
    np.testing.assert_array_equal(got, want)
    small = _codes(3, 7, seed=7)
    np.testing.assert_array_equal(
        genotype_text_from_codes(torch.from_numpy(small)).numpy(),
        jax_gt_text.genotype_text_reference(small),
    )


@pytest.mark.parametrize("shape", [(4, 128), (8, 256), (40, 128), (1, 33), (3, 1)])
def test_genotype_text_transposed_matches_lab_kernel(shape):
    rec, v = shape
    packed_t = np.random.default_rng(rec * v).integers(0, 256, size=shape, dtype=np.uint8)
    got = genotype_text_transposed(torch.from_numpy(packed_t)).numpy()
    want = np.asarray(jax_text_transposed(jnp.asarray(packed_t), interpret=True))
    assert got.shape == (16 * rec, v)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_var,n_samples,k", [(0, 5, 2), (3, 0, 0), (3, 5, 0), (0, 0, 0)])
def test_zero_sized(n_var, n_samples, k):
    codes = torch.from_numpy(_codes(n_var, n_samples, seed=1))
    packed = torch.from_numpy(_packed(n_var, n_samples, seed=1))
    sel = torch.arange(k, dtype=torch.int32)
    rec = (n_samples + 3) // 4
    assert pack_codes(codes).shape == (n_var, rec)
    assert subset_repack(packed, sel).shape == (n_var, (k + 3) // 4)
    assert genotype_text_from_codes(codes).shape == (n_var, 4 * n_samples)
    assert genotype_text_transposed(packed.T.contiguous()).shape == (16 * rec, n_var)


def test_cpu_calls_launch_no_kernel(monkeypatch):
    for w in WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    codes = torch.from_numpy(_codes(5, 13, seed=3))
    packed = torch.from_numpy(_packed(5, 13, seed=3))
    pack_codes(codes)
    subset_repack(packed, torch.tensor([12, 1], dtype=torch.int32))
    genotype_text_from_codes(codes)
    genotype_text_transposed(packed)
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


def test_plain_versions_match_wrappers_on_cpu():
    codes = torch.from_numpy(_codes(6, 2503, seed=4))
    packed = torch.from_numpy(_packed(6, 2503, seed=4))
    sel = torch.from_numpy(np.random.default_rng(4).permutation(2503)[:1001].astype(np.int32))
    assert torch.equal(pack_codes(codes), pack_codes_plain(codes))
    assert torch.equal(subset_repack(packed, sel), subset_repack_plain(packed, sel))
    assert torch.equal(genotype_text_from_codes(codes), text_from_codes_plain(codes))
    pt = packed.T.contiguous()
    assert torch.equal(genotype_text_transposed(pt), genotype_text_transposed_plain(pt))


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda c, p: pack_codes(c.to(torch.int16)), TypeError),
        (lambda c, p: pack_codes(c.t()), ValueError),
        (lambda c, p: pack_codes(c[0]), ValueError),
        (lambda c, p: pack_codes(c.numpy()), TypeError),
        (lambda c, p: genotype_text_from_codes(c.t()), ValueError),
        (lambda c, p: genotype_text_transposed(p.to("meta")), ValueError),
        (lambda c, p: subset_repack(p, torch.tensor([1], dtype=torch.int64)), TypeError),
        (lambda c, p: subset_repack(p, torch.tensor([4 * p.shape[1]], dtype=torch.int32)),
         IndexError),
        (lambda c, p: subset_repack(p, torch.tensor([-1], dtype=torch.int32)), IndexError),
        (lambda c, p: subset_repack(p, torch.tensor([0, 1, 2], dtype=torch.int32)[::2]),
         ValueError),
    ],
)
def test_wrappers_reject_bad_input(call, exc):
    codes = torch.from_numpy(_codes(3, 10, seed=2))
    packed = torch.from_numpy(_packed(3, 10, seed=2))
    with pytest.raises(exc):
        call(codes, packed)
