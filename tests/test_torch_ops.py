"""The port's genotype ops (pgen_tpu_torch.ops) against pgen_tpu's.

On CPU tensors the wrappers run their plain PyTorch versions, which are held
with exact equality against pgen_tpu's Pallas kernels in interpret mode (P1
unpack, P1 then P2 text) and its XLA subset gather, on the same packed bytes
made from a seed with numpy. The CUDA kernels themselves run only on a card
(test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgen_tpu.ops import gt_text as jax_gt_text
from pgen_tpu.ops import unpack as jax_unpack
from pgen_tpu.ops.unpack_host import unpack_codes_reference
from pgen_tpu_torch.ops.gt_text import (
    genotype_text,
    genotype_text_plain,
    subset_text_from_packed,
    subset_text_plain,
)
from pgen_tpu_torch.ops.unpack import unpack_codes, unpack_codes_plain

WIDTHS = [1, 2, 3, 4, 5, 2503, 2504]
WRAPPERS = (unpack_codes, genotype_text, subset_text_from_packed)


def _packed(n_var, n_samples, seed):
    """Random records, pad bits in the last byte included (as in real files)."""
    rec = (2 * n_samples + 7) // 8
    return np.random.default_rng(seed).integers(0, 256, size=(n_var, rec), dtype=np.uint8)


def _sel(n_samples, k, seed):
    """k sample ids in random (unsorted) order."""
    return np.random.default_rng(seed).permutation(n_samples)[:k].astype(np.int32)


def _port_subset(packed, sel):
    return subset_text_from_packed(torch.from_numpy(packed), torch.from_numpy(sel)).numpy()


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_unpack_codes_matches_pallas(n_samples):
    packed = _packed(9, n_samples, seed=n_samples)
    got = unpack_codes(torch.from_numpy(packed), n_samples).numpy()
    want = np.asarray(jax_unpack.unpack_codes(jnp.asarray(packed), n_samples, interpret=True))
    assert got.shape == (9, n_samples)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_genotype_text_matches_pallas(n_samples):
    packed = _packed(9, n_samples, seed=100 + n_samples)
    got = genotype_text(torch.from_numpy(packed), n_samples).numpy()
    want = np.asarray(jax_gt_text.genotype_text(jnp.asarray(packed), n_samples, interpret=True))
    assert got.shape == (9, 4 * n_samples)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_samples", WIDTHS)
def test_subset_text_matches_jax(n_samples):
    packed = _packed(9, n_samples, seed=200 + n_samples)
    sel = _sel(n_samples, min(n_samples, 37), seed=n_samples)
    got = _port_subset(packed, sel)
    want = jax_gt_text.subset_text_from_packed(jnp.asarray(packed), sel)
    assert got.shape == (9, 4 * len(sel))
    np.testing.assert_array_equal(got, want)


def test_all_256_byte_values():
    packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
    t = torch.from_numpy(packed)
    np.testing.assert_array_equal(
        unpack_codes(t, 1024).numpy(), unpack_codes_reference(packed, 1024)
    )
    np.testing.assert_array_equal(
        genotype_text(t, 1024).numpy(),
        jax_gt_text.genotype_text_reference(unpack_codes_reference(packed, 1024)),
    )
    sel = _sel(1024, 1024, seed=5)
    np.testing.assert_array_equal(
        _port_subset(packed, sel), jax_gt_text.subset_text_from_packed(jnp.asarray(packed), sel)
    )


def test_lsb_first_tokens():
    # byte 0b00_11_10_01 -> samples [1, 2, 3, 0] (pfile.rs:171-175)
    t = torch.tensor([[0b00111001]], dtype=torch.uint8)
    assert unpack_codes(t, 4).tolist() == [[1, 2, 3, 0]]
    assert genotype_text(t, 4).numpy().tobytes() == b"\t0/1\t1/1\t./.\t0/0"
    sel = torch.tensor([3, 0], dtype=torch.int32)
    assert subset_text_from_packed(t, sel).numpy().tobytes() == b"\t0/0\t0/1"


def test_subset_repeats_and_order():
    packed = _packed(4, 11, seed=9)
    sel = np.array([10, 0, 10, 4, 3], dtype=np.int32)
    np.testing.assert_array_equal(
        _port_subset(packed, sel), jax_gt_text.subset_text_from_packed(jnp.asarray(packed), sel)
    )


@pytest.mark.parametrize(
    "n_var,n_samples,k", [(0, 5, 2), (3, 0, 0), (3, 5, 0), (0, 0, 0)]
)
def test_zero_sized(n_var, n_samples, k):
    packed = _packed(n_var, n_samples, seed=1)
    t = torch.from_numpy(packed)
    sel = _sel(n_samples, k, seed=1)
    for got, want in (
        (
            unpack_codes(t, n_samples).numpy(),
            np.asarray(jax_unpack.unpack_codes(jnp.asarray(packed), n_samples, interpret=True)),
        ),
        (
            genotype_text(t, n_samples).numpy(),
            np.asarray(jax_gt_text.genotype_text(jnp.asarray(packed), n_samples, interpret=True)),
        ),
        (_port_subset(packed, sel), jax_gt_text.subset_text_from_packed(jnp.asarray(packed), sel)),
    ):
        assert got.shape == want.shape
        assert got.dtype == np.uint8


def test_cpu_calls_launch_no_kernel(monkeypatch):
    for w in WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    packed = torch.from_numpy(_packed(5, 13, seed=3))
    unpack_codes(packed, 13)
    genotype_text(packed, 13)
    subset_text_from_packed(packed, torch.tensor([12, 1], dtype=torch.int32))
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


def test_plain_versions_match_wrappers_on_cpu():
    packed = torch.from_numpy(_packed(6, 2503, seed=4))
    sel = torch.from_numpy(_sel(2503, 100, seed=4))
    assert torch.equal(unpack_codes(packed, 2503), unpack_codes_plain(packed, 2503))
    assert torch.equal(genotype_text(packed, 2503), genotype_text_plain(packed, 2503))
    assert torch.equal(subset_text_from_packed(packed, sel), subset_text_plain(packed, sel))


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda p: genotype_text(p.to(torch.int16), 4), TypeError),
        (lambda p: genotype_text(p.t(), 4), ValueError),
        (lambda p: genotype_text(p[0], 4), ValueError),
        (lambda p: genotype_text(p, 4 * p.shape[1] + 1), ValueError),
        (lambda p: unpack_codes(p.numpy(), 4), TypeError),
        (lambda p: unpack_codes(p.to("meta"), 4), ValueError),
        (lambda p: subset_text_from_packed(p, torch.tensor([1], dtype=torch.int64)), TypeError),
        (lambda p: subset_text_from_packed(p, torch.tensor([[1]], dtype=torch.int32)), TypeError),
        (lambda p: subset_text_from_packed(p, torch.tensor([4 * p.shape[1]], dtype=torch.int32)),
         IndexError),
        (lambda p: subset_text_from_packed(p, torch.tensor([-1], dtype=torch.int32)), IndexError),
    ],
)
def test_wrappers_reject_bad_input(call, exc):
    packed = torch.from_numpy(_packed(3, 10, seed=2))
    with pytest.raises(exc):
        call(packed)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A kernel build that fails raises with the compiler's stderr; nothing
    is left in the build directory and nothing falls back."""
    from pgen_tpu_torch import kernels

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'genotype.cu(1): error: simulated' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)exit code 3.*simulated"):
        kernels.build()
    assert list((tmp_path / "build").iterdir()) == []
