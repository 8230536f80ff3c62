// Genotype kernels for Hopper (sm_90a): packed 2-bit records <-> codes, a
// sample subset of records re-packed, and records or codes -> VCF GT text.
// Built by pgen_tpu_torch/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// Each launcher takes raw device pointers, int64 sizes and the caller's
// cudaStream_t, launches on that stream without synchronising, and returns
// cudaGetLastError(). The wrappers in pgen_tpu_torch/ops/ allocate every
// output and return early on zero-sized shapes; the launchers repeat that
// guard because a grid of 0 blocks is a launch error.
//
// All offsets are int64: a whole chr22 keep-all text matrix is
// 1.1M rows x 10,016 B, about 11 GB, past 2^31.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

#include "genotype.cuh"

namespace {

constexpr int kThreads = 256;
// Grid-stride loops past this many blocks (about 2M threads in flight).
constexpr int64_t kMaxBlocks = 8192;

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// K1. Replaces the Pallas kernel pgen_tpu/ops/unpack.py:_unpack_kernel
// (launched by unpack_words, wrapped by unpack_codes).
// (V, R) u8 records -> (V, R) u32 words = (V, 4R) u8 codes; the wrapper
// returns the [:, :S] slice, as unpack.py:110 does.
// Bound: memory, 1 B read and 4 B written per packed byte, a handful of
// integer ops between. Design: one thread per packed byte and one aligned
// u32 store of its four codes, so neighbouring threads write neighbouring
// words and every warp store is one contiguous 128 B segment.
__global__ void unpack_codes_kernel(const uint8_t* __restrict__ packed,
                                    uint32_t* __restrict__ words, int64_t n) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    words[i] = unpack_byte(packed[i]);
  }
}

// K2. Replaces the Pallas pair pgen_tpu/ops/gt_text.py:_codes_kernel after
// ops/unpack.py:_unpack_kernel (the fused genotype_text), and on the
// keep-all filter path the plane form planes_from_packed, whose four planes
// exist only because Mosaic cannot interleave lanes.
// (V, R) u8 records -> (V, 4S) u8 text; sample s owns bytes 4s..4s+3.
// Bound: memory, 1 B read and 16 B written per packed byte; one chr22 block
// of 65,536 x 626 B reads 41 MB and writes 656 MB. End to end this kernel is
// not the bound: the PCIe copy of its output to the host and the host's row
// assembly each take longer (PERF.md). Design: one thread per (row, packed
// byte j) decodes the byte once and writes the text words of samples
// 4j..4j+3 straight into the interleaved row, so codes never reach device
// memory. The row stride is 4S bytes: u32 stores are
// always aligned, 16 B stores only when S % 4 == 0, so they are not used.
// Codes past S in a row's last byte are padding (arbitrary bits in real
// files) and are never written.
__global__ void genotype_text_kernel(const uint8_t* __restrict__ packed,
                                     uint32_t* __restrict__ text,
                                     int64_t n_var, int64_t rec,
                                     int64_t n_samples) {
  const int64_t n = n_var * rec;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t v = i / rec;
    const int64_t s0 = 4 * (i - v * rec);
    const uint32_t codes = unpack_byte(packed[i]);
    uint32_t* row = text + v * n_samples;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s0 + k < n_samples) {
        row[s0 + k] = text_word((codes >> (8 * k)) & 0xFFu);
      }
    }
  }
}

// K3. Replaces pgen_tpu/ops/gt_text.py:_subset_words (XLA gather + text
// word, behind subset_text_from_packed) on the sample-subset filter path.
// (V, R) u8 records + sel (K) int32 sample ids, any order -> (V, 4K) u8
// text in sel order.
// Bound: memory, 4 B written per kept sample and one record byte read; for
// a keep-two filter the whole block is a few hundred KB, so launch latency
// and the host around it dominate. Design: one thread per (row, kept k)
// reads only the byte holding its sample; K u32 words per row is what the
// host copies back, instead of the full 16 B per record byte.
__global__ void subset_text_kernel(const uint8_t* __restrict__ packed,
                                   const int32_t* __restrict__ sel,
                                   uint32_t* __restrict__ text, int64_t n_var,
                                   int64_t rec, int64_t n_kept) {
  const int64_t n = n_var * n_kept;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t v = i / n_kept;
    const int32_t s = sel[i - v * n_kept];
    assert(s >= 0 && static_cast<int64_t>(s) < 4 * rec);
    const uint32_t b = packed[v * rec + (s >> 2)];
    text[i] = text_word((b >> (2 * (s & 3))) & 3u);
  }
}

// K4. Replaces the Pallas kernel pgen_tpu/ops/pack.py:_pack_kernel
// (launched by pack_codes_device) on the VCF import path.
// (V, S) u8 codes -> (V, R) u8 records, R = ceil(S/4); byte j of a row packs
// codes 4j..4j+3.
// Bound: memory, 4 B read and 1 B written per record byte. Design: one
// thread per output byte reads its (up to) four codes and makes one byte
// store. The loads are bytes: the row stride is S, so a u32 load of four
// codes would be aligned only when S % 4 == 0. A row's last byte reads only
// codes < S, so its pad bits are zero, as P3's zero padding (pack.py:42-43)
// makes them.
__global__ void pack_codes_kernel(const uint8_t* __restrict__ codes,
                                  uint8_t* __restrict__ packed, int64_t n_var,
                                  int64_t n_samples, int64_t rec) {
  const int64_t n = n_var * rec;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t v = i / rec;
    const int64_t s0 = 4 * (i - v * rec);
    const uint8_t* row = codes + v * n_samples;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s0 + k < n_samples) {
        w |= static_cast<uint32_t>(row[s0 + k]) << (8 * k);
      }
    }
    packed[i] = static_cast<uint8_t>(pack_word(w));
  }
}

// K5. Replaces the device branch of pgen_tpu/pipeline/pgen_out.py:
// _subset_block, which runs the Pallas _unpack_kernel, an XLA take of the
// kept columns, then the Pallas _pack_kernel.
// (V, R) u8 records + sel (K) int32 sample ids, any order -> (V, ceil(K/4))
// u8 records of the kept samples in sel order.
// Bound: memory, one record byte read per kept sample and a quarter byte
// written. Design: the three steps fused, so codes never reach device
// memory: one thread per output byte j reads sel[4j..4j+3], the source byte
// sel >> 2 of each and its code at bits 2 * (sel & 3), and packs them. Codes
// past K in a row's last byte stay zero, and source pad codes are never
// read, since only kept ids are.
__global__ void subset_repack_kernel(const uint8_t* __restrict__ packed,
                                     const int32_t* __restrict__ sel,
                                     uint8_t* __restrict__ out, int64_t n_var,
                                     int64_t rec, int64_t n_kept,
                                     int64_t out_rec) {
  const int64_t n = n_var * out_rec;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t v = i / out_rec;
    const int64_t k0 = 4 * (i - v * out_rec);
    const uint8_t* row = packed + v * rec;
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k0 + k < n_kept) {
        const int32_t s = sel[k0 + k];
        assert(s >= 0 && static_cast<int64_t>(s) < 4 * rec);
        b |= ((static_cast<uint32_t>(row[s >> 2]) >> (2 * (s & 3))) & 3u) << (2 * k);
      }
    }
    out[i] = static_cast<uint8_t>(b);
  }
}

// K6. Replaces the Pallas kernel tools/fused_text_lab.py:_fused_kernel
// (launched by genotype_text_transposed), a lab entry point on no path.
// (R, V) u8 records, transposed -> (16R, V) u8 text: row 4s+m is text byte
// m ('\t', b0, '/', b1) of sample s, one column per variant.
// Bound: memory, 1 B read and 16 B written per record byte. Design: one
// thread per (r, v), v varying fastest, so each of its 16 byte stores is
// coalesced across the warp (32 neighbouring columns of one output row).
// The layout is plain indexing: the TPU's in-kernel bitcast that expands
// sublanes has no counterpart here.
__global__ void genotype_text_transposed_kernel(
    const uint8_t* __restrict__ packed_t, uint8_t* __restrict__ text_t,
    int64_t rec, int64_t n_var) {
  const int64_t n = rec * n_var;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t r = i / n_var;
    const int64_t v = i - r * n_var;
    const uint32_t codes = unpack_byte(packed_t[i]);
    uint8_t* col = text_t + 16 * r * n_var + v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t word = text_word((codes >> (8 * k)) & 0xFFu);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        col[(4 * k + m) * n_var] = static_cast<uint8_t>(word >> (8 * m));
      }
    }
  }
}

// K7. Replaces the Pallas kernel pgen_tpu/ops/gt_text.py:_codes_kernel on
// its own (launched by _text_words_from_codes, wrapped by
// genotype_text_from_codes), an entry point on no path.
// (V, S) u8 codes -> (V, 4S) u8 text, sample s at bytes 4s..4s+3.
// Bound: memory, 1 B read and 4 B written per code. Design: the text matrix
// is (V * S) u32 words in row order, so the kernel is elementwise: one
// thread per code and one aligned u32 store of text_word(code), the same
// formula as _text_word on any byte value.
__global__ void text_from_codes_kernel(const uint8_t* __restrict__ codes,
                                       uint32_t* __restrict__ text, int64_t n) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    text[i] = text_word(codes[i]);
  }
}

}  // namespace

extern "C" {

int pgen_unpack_codes(const void* packed, void* words, int64_t n_var,
                      int64_t rec, void* stream) {
  const int64_t n = n_var * rec;
  if (n <= 0) return 0;
  unpack_codes_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint32_t*>(words), n);
  return static_cast<int>(cudaGetLastError());
}

int pgen_genotype_text(const void* packed, void* text, int64_t n_var,
                       int64_t rec, int64_t n_samples, void* stream) {
  const int64_t n = n_var * rec;
  if (n <= 0 || n_samples <= 0) return 0;
  genotype_text_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint32_t*>(text), n_var,
      rec, n_samples);
  return static_cast<int>(cudaGetLastError());
}

int pgen_subset_text(const void* packed, const void* sel, void* text,
                     int64_t n_var, int64_t rec, int64_t n_kept,
                     void* stream) {
  const int64_t n = n_var * n_kept;
  if (n <= 0) return 0;
  subset_text_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(sel),
      static_cast<uint32_t*>(text), n_var, rec, n_kept);
  return static_cast<int>(cudaGetLastError());
}

int pgen_pack_codes(const void* codes, void* packed, int64_t n_var,
                    int64_t n_samples, void* stream) {
  const int64_t rec = (n_samples + 3) / 4;
  const int64_t n = n_var * rec;
  if (n <= 0) return 0;
  pack_codes_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<uint8_t*>(packed), n_var,
      n_samples, rec);
  return static_cast<int>(cudaGetLastError());
}

int pgen_subset_repack(const void* packed, const void* sel, void* out,
                       int64_t n_var, int64_t rec, int64_t n_kept,
                       void* stream) {
  const int64_t out_rec = (n_kept + 3) / 4;
  const int64_t n = n_var * out_rec;
  if (n <= 0) return 0;
  subset_repack_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(sel),
      static_cast<uint8_t*>(out), n_var, rec, n_kept, out_rec);
  return static_cast<int>(cudaGetLastError());
}

int pgen_genotype_text_transposed(const void* packed_t, void* text_t,
                                  int64_t rec, int64_t n_var, void* stream) {
  const int64_t n = rec * n_var;
  if (n <= 0) return 0;
  genotype_text_transposed_kernel<<<grid_for(n), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed_t), static_cast<uint8_t*>(text_t),
      rec, n_var);
  return static_cast<int>(cudaGetLastError());
}

int pgen_text_from_codes(const void* codes, void* text, int64_t n_var,
                         int64_t n_samples, void* stream) {
  const int64_t n = n_var * n_samples;
  if (n <= 0) return 0;
  text_from_codes_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<uint32_t*>(text), n);
  return static_cast<int>(cudaGetLastError());
}

const char* pgen_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
