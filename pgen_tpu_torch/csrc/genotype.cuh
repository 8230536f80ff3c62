// Device functions shared by the genotype kernels (genotype.cu).
//
// Mode-0x02 records hold four 2-bit hard calls per byte, LSB-first: sample
// 4j+k of a record reads bits 2k..2k+1 of byte j. Codes: 0 = 0/0, 1 = 0/1,
// 2 = 1/1, 3 = ./. (missing).
#pragma once

#include <cstdint>

// Packed byte -> one u32 whose little-endian bytes are the codes of its four
// samples. Multiply-spread, as pgen_tpu/ops/unpack.py:_unpack_words: the even
// bit pairs (bits 0-1, 4-5) land on bytes 0 and 2 through one multiply by
// (1 | 1 << 12), the odd pairs (2-3, 6-7) on bytes 1 and 3 through
// (1 << 6 | 1 << 18); the shifted copies occupy disjoint bits, so no carries.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t x) {
  return (((x & 0x33u) * 0x1001u) & 0x00030003u) |
         (((x & 0xCCu) * 0x40040u) & 0x03000300u);
}

// The inverse of unpack_byte: a u32 whose little-endian bytes are four codes
// -> one packed byte, code k at bits 2k..2k+1. Each code is masked to its low
// two bits before the shift, as pgen_tpu/ops/pack.py:_pack_kernel does
// (byte = sum_k ((w >> 8k) & 3) << 2k), so any input byte packs as P3 packs it.
__device__ __forceinline__ uint32_t pack_word(uint32_t w) {
  return (w & 0x3u) | ((w >> 6) & 0xCu) | ((w >> 12) & 0x30u) |
         ((w >> 18) & 0xC0u);
}

// Code (0..3) -> the four VCF text bytes of one sample as a little-endian
// u32: '\t', b0, '/', b1 gives "\t0/0", "\t0/1", "\t1/1", "\t./.", as
// pgen_tpu/ops/gt_text.py:_text_word.
__device__ __forceinline__ uint32_t text_word(uint32_t code) {
  const uint32_t b0 = code < 2u ? '0' : (code == 2u ? '1' : '.');
  const uint32_t b1 = code == 0u ? '0' : (code == 3u ? '.' : '1');
  return uint32_t('\t') | (b0 << 8) | (uint32_t('/') << 16) | (b1 << 24);
}
