"""Genotype text: packed records -> VCF GT column bytes, the port of
``pgen_tpu/ops/gt_text.py``.

Sample ``s`` contributes the four bytes ``\\t b0 / b1`` at columns
4s..4s+3 of its row: code 0 -> ``\\t0/0``, 1 -> ``\\t0/1``, 2 -> ``\\t1/1``,
3 -> ``\\t./.``.

Four entry points, each dispatching on the tensor's device, with no fallback
between the two: a CUDA tensor launches the kernel, a CPU tensor runs the
plain PyTorch version beside it.

- ``genotype_text`` (keep-all): K2, ``csrc/genotype.cu``'s
  ``genotype_text_quad_kernel`` (16 B stores, S % 4 == 0) and
  ``genotype_text_words_kernel`` (any S), one kernel for what the Pallas
  pair ``_unpack_kernel`` then ``_codes_kernel`` computes. It writes the
  interleaved text directly, so the TPU's four-plane form
  (``planes_from_packed``) has no counterpart here.
- ``subset_text_from_packed`` (kept samples): K3,
  ``csrc/genotype.cu:subset_text_kernel``, the counterpart of the XLA gather
  ``_subset_words``. Unlike pgen_tpu's, it returns a tensor on the input's
  device; the caller copies it to the host.
- ``genotype_text_from_codes`` (a code matrix): K7,
  ``csrc/genotype.cu:text_from_codes_kernel``, the Pallas ``_codes_kernel``
  on its own. No path calls it.
- ``genotype_text_transposed`` (records transposed, one column per variant):
  K6, ``csrc/genotype.cu:genotype_text_transposed_kernel``, the counterpart
  of the lab kernel ``tools/fused_text_lab.py:_fused_kernel``. No path calls
  it.

pgen_tpu's numpy oracle ``genotype_text_reference`` is not re-exported: it
lives in a module that imports jax, so the tests take it from pgen_tpu.
"""

from __future__ import annotations

import torch

from pgen_tpu_torch.kernels import launch
from pgen_tpu_torch.ops.unpack import (
    check_packed,
    check_sel,
    check_sel_range,
    unpack_codes_plain,
)

_TAB, _SLASH, _ZERO, _ONE, _DOT = (ord(c) for c in "\t/01.")


def text_words_plain(codes: torch.Tensor) -> torch.Tensor:
    """Integer codes (0..3) -> int32 words whose little-endian bytes are the
    sample's four text bytes (``'\\t' | b0 << 8 | '/' << 16 | b1 << 24``)."""
    b0 = torch.where(codes < 2, _ZERO, torch.where(codes == 2, _ONE, _DOT))
    b1 = torch.where(codes == 0, _ZERO, torch.where(codes == 3, _DOT, _ONE))
    return (_TAB | (b0 << 8) | (_SLASH << 16) | (b1 << 24)).to(torch.int32)


def _words_to_text(words: torch.Tensor) -> torch.Tensor:
    """(V, N) int32 words -> (V, 4N) u8, little-endian within each word."""
    return words.contiguous().view(torch.uint8)


def genotype_text_plain(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch keep-all text: (V, R) u8 -> (V, 4*num_samples) u8."""
    codes = unpack_codes_plain(packed, num_samples).to(torch.int32)
    return _words_to_text(text_words_plain(codes))


def subset_text_plain(packed: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch subset text: (V, R) u8 + (K,) sample ids -> (V, 4K) u8
    in ``sel`` order."""
    sel = sel.to(torch.int64)
    check_sel_range(sel, packed.shape[1])
    b = packed[:, sel >> 2].to(torch.int32)
    codes = (b >> (2 * (sel & 3)).to(torch.int32)) & 3
    return _words_to_text(text_words_plain(codes))


def genotype_text(packed: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Fused packed records -> VCF GT text, the keep-all fast path:
    (V, R) u8 -> (V, 4*num_samples) u8 on the input's device."""
    n_var, rec = check_packed(packed, num_samples)
    if n_var == 0 or num_samples == 0:
        return torch.empty((n_var, 4 * num_samples), dtype=torch.uint8, device=packed.device)
    if packed.device.type == "cpu":
        return genotype_text_plain(packed, num_samples)
    text = torch.empty((n_var, 4 * num_samples), dtype=torch.uint8, device=packed.device)
    launch(genotype_text, "pgen_genotype_text", packed,
           packed.data_ptr(), text.data_ptr(), n_var, rec, num_samples)
    return text


def subset_text_from_packed(packed: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Kept-sample text straight from the packed bytes: (V, R) u8 records and
    ``sel``, a 1-D int32 tensor of sample ids on the same device in any
    order, -> (V, 4*len(sel)) u8 in ``sel`` order. On CUDA an id outside
    [0, 4R) fails a device-side assert."""
    n_var, rec = check_packed(packed)
    n_kept = check_sel(sel, packed)
    if n_var == 0 or n_kept == 0:
        return torch.empty((n_var, 4 * n_kept), dtype=torch.uint8, device=packed.device)
    if packed.device.type == "cpu":
        return subset_text_plain(packed, sel)
    text = torch.empty((n_var, 4 * n_kept), dtype=torch.uint8, device=packed.device)
    launch(subset_text_from_packed, "pgen_subset_text", packed,
           packed.data_ptr(), sel.data_ptr(), text.data_ptr(), n_var, rec, n_kept)
    return text


def text_from_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch codes -> text: (V, S) u8 -> (V, 4S) u8, the
    ``_text_word`` formula on any byte value."""
    return _words_to_text(text_words_plain(codes.to(torch.int32)))


def genotype_text_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """(V, S) u8 codes -> (V, 4S) u8 VCF text on the input's device, the
    standalone counterpart of pgen_tpu's ``genotype_text_from_codes``."""
    n_var, n_samples = check_packed(codes, name="codes")
    if n_var == 0 or n_samples == 0:
        return torch.empty((n_var, 4 * n_samples), dtype=torch.uint8, device=codes.device)
    if codes.device.type == "cpu":
        return text_from_codes_plain(codes)
    text = torch.empty((n_var, 4 * n_samples), dtype=torch.uint8, device=codes.device)
    launch(genotype_text_from_codes, "pgen_text_from_codes", codes,
           codes.data_ptr(), text.data_ptr(), n_var, n_samples)
    return text


def genotype_text_transposed_plain(packed_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch transposed text: (R, V) u8 -> (16R, V) u8, the keep-all
    text of all 4R slots, transposed."""
    rec = packed_t.shape[0]
    return genotype_text_plain(packed_t.T.contiguous(), 4 * rec).T.contiguous()


def genotype_text_transposed(packed_t: torch.Tensor) -> torch.Tensor:
    """(R, V) u8 records, one column per variant -> (16R, V) u8 text on the
    input's device; row 4s+m is text byte m of sample s, as in
    ``tools/fused_text_lab.genotype_text_transposed``."""
    rec, n_var = check_packed(packed_t, name="packed_t")
    if rec == 0 or n_var == 0:
        return torch.empty((16 * rec, n_var), dtype=torch.uint8, device=packed_t.device)
    if packed_t.device.type == "cpu":
        return genotype_text_transposed_plain(packed_t)
    text_t = torch.empty((16 * rec, n_var), dtype=torch.uint8, device=packed_t.device)
    launch(genotype_text_transposed, "pgen_genotype_text_transposed", packed_t,
           packed_t.data_ptr(), text_t.data_ptr(), rec, n_var)
    return text_t


genotype_text.launches = 0
subset_text_from_packed.launches = 0
genotype_text_from_codes.launches = 0
genotype_text_transposed.launches = 0
