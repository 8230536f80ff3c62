// Genotype kernels for Hopper (sm_90a): packed 2-bit records <-> codes, a
// sample subset of records re-packed, records or codes -> VCF GT text,
// records -> per-variant and per-sample code counts, records -> the f32
// operands of the GWAS moment, polygenic score and GRM products, records ->
// LD's banded r² and pca --approx's pass y += Z^T (Z q), and records -> the
// bit planes of king's and genome's count Grams and the Grams themselves.
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

// Row-tiled kernels (K2, K3): thread x of a block takes a column of the
// output row (a packed byte, a text word or a kept sample), blockIdx.x a tile
// of columns, and the block's rows start at blockIdx.y and step by gridDim.y
// (at most 65,535), so no thread divides a flat index by the row length.
constexpr int kTileThreads = 128;

// The grid for n_var rows of n_cols columns, kTileThreads per block (times
// rows_per_block rows of threads): all column tiles, and enough row blocks
// for about kMaxBlocks blocks in all.
dim3 tile_grid(int64_t n_var, int64_t n_cols, int64_t cols_per_block,
               int64_t rows_per_block) {
  const int64_t gx = (n_cols + cols_per_block - 1) / cols_per_block;
  const int64_t rows = (n_var + rows_per_block - 1) / rows_per_block;
  int64_t gy = kMaxBlocks / gx;
  if (gy < 1) gy = 1;
  if (gy > rows) gy = rows;
  if (gy > 65535) gy = 65535;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
}

// K2. Replaces the Pallas pair pgen_tpu/ops/gt_text.py:_codes_kernel after
// ops/unpack.py:_unpack_kernel (the fused genotype_text), and on the
// keep-all filter path the plane form planes_from_packed, whose four planes
// exist only because Mosaic cannot interleave lanes.
// (V, R) u8 records -> (V, 4S) u8 text; sample s owns bytes 4s..4s+3.
// Bound: memory, 1 B read and 16 B written per packed byte; one chr22 block
// of 65,536 x 626 B reads 41 MB and writes 656 MB, 0.208 ms at 3.35 TB/s.
// Codes never reach device memory, and codes past S in a row's last byte
// (padding, arbitrary bits in real files) are never written. Two forms,
// chosen by the launcher:
// - aligned (S % 4 == 0, output 16-B aligned, so every row starts on 16 B):
//   one thread per packed byte j < S/4 decodes it once and writes its four
//   samples' text as one 16 B store; consecutive threads write consecutive
//   16 B, so a warp's store is 512 contiguous bytes, every sector full.
// - words (any S, output 4-B aligned): one thread per sample s writes its
//   text word; consecutive threads write consecutive words (a warp's store
//   is 128 contiguous bytes) and the four threads of a byte read it from L1.
// Each thread loads two rows' bytes before it stores either, so two loads
// are in flight.
__device__ __forceinline__ uint4 text_quad(uint32_t byte) {
  const uint32_t codes = unpack_byte(byte);
  return make_uint4(text_word(codes & 0xFFu), text_word((codes >> 8) & 0xFFu),
                    text_word((codes >> 16) & 0xFFu), text_word(codes >> 24));
}

__global__ void genotype_text_quad_kernel(const uint8_t* __restrict__ packed,
                                          uint4* __restrict__ text,
                                          int64_t n_var, int64_t rec,
                                          int64_t n_quads) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_quads) return;
  const int64_t step = gridDim.y;
  int64_t v = blockIdx.y;
  for (; v + step < n_var; v += 2 * step) {
    const uint32_t a = __ldg(packed + v * rec + j);
    const uint32_t b = __ldg(packed + (v + step) * rec + j);
    text[v * n_quads + j] = text_quad(a);
    text[(v + step) * n_quads + j] = text_quad(b);
  }
  if (v < n_var) text[v * n_quads + j] = text_quad(__ldg(packed + v * rec + j));
}

__global__ void genotype_text_words_kernel(const uint8_t* __restrict__ packed,
                                           uint32_t* __restrict__ text,
                                           int64_t n_var, int64_t rec,
                                           int64_t n_samples) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  const int64_t byte = s >> 2;
  const int shift = 2 * static_cast<int>(s & 3);
  const int64_t step = gridDim.y;
  int64_t v = blockIdx.y;
  for (; v + step < n_var; v += 2 * step) {
    const uint32_t a = __ldg(packed + v * rec + byte);
    const uint32_t b = __ldg(packed + (v + step) * rec + byte);
    text[v * n_samples + s] = text_word((a >> shift) & 3u);
    text[(v + step) * n_samples + s] = text_word((b >> shift) & 3u);
  }
  if (v < n_var) {
    text[v * n_samples + s] = text_word((__ldg(packed + v * rec + byte) >> shift) & 3u);
  }
}

// K3. Replaces pgen_tpu/ops/gt_text.py:_subset_words (XLA gather + text
// word, behind subset_text_from_packed) on the sample-subset filter path.
// (V, R) u8 records + sel (K) int32 sample ids, any order, repeats allowed
// -> (V, 4K) u8 text in sel order.
// Bound: memory, one record byte read per kept sample and 4 B written per
// kept sample; at K = 1000 a 65,536-row block reads 41 MB (every row's
// bytes) and writes 262 MB, 0.090 ms at 3.35 TB/s. For a keep-two filter
// the block is a few hundred KB, so launch latency and the host around it
// dominate.
// Design: a block takes a tile of kept samples (blockIdx.x, threadIdx.x)
// over rows of threads (threadIdx.y) that step through the rows. Each
// thread reads its ids from sel once, as (byte, shift) pairs kept in
// registers for every row, so K has no limit but the grid's. Per row it
// reads its record bytes through L1 (the block's threads share the row)
// and writes consecutive words: one 16 B store of four kept samples when
// K % 4 == 0 and the output is 16-B aligned (the quad form), else one u32.
template <int kPer>
__global__ void subset_text_kernel(const uint8_t* __restrict__ packed,
                                   const int32_t* __restrict__ sel,
                                   uint32_t* __restrict__ text, int64_t n_var,
                                   int64_t rec, int64_t n_kept) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kPer * c >= n_kept) return;
  int64_t byte[kPer];
  int shift[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int32_t s = sel[kPer * c + m];
    assert(s >= 0 && static_cast<int64_t>(s) < 4 * rec);
    byte[m] = s >> 2;
    shift[m] = 2 * (s & 3);
  }
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t v = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; v < n_var;
       v += step) {
    const uint8_t* row = packed + v * rec;
    uint32_t w[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) w[m] = text_word((__ldg(row + byte[m]) >> shift[m]) & 3u);
    if constexpr (kPer == 4) {
      reinterpret_cast<uint4*>(text + v * n_kept)[c] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      text[v * n_kept + c] = w[0];
    }
  }
}

// K4. Replaces the Pallas kernel pgen_tpu/ops/pack.py:_pack_kernel
// (launched by pack_codes_device) on the VCF import path.
// (V, S) u8 codes -> (V, R) u8 records, R = ceil(S/4); byte j of a row packs
// codes 4j..4j+3, each masked to two bits; codes past S in a row's last byte
// are zero, as P3's zero padding (pack.py:42-43) makes them.
// Bound: memory, 4 B read and 1 B written per record byte: 65,536 x 2504
// codes read 164 MB and write 41 MB, 0.061 ms at 3.35 TB/s. Two forms,
// chosen by the launcher from S and the two pointers:
// - flat (S % 4 == 0, codes 16-B and records 4-B aligned; 1000 Genomes'
//   2504): rows have no pad codes, so the matrix is one flat array and
//   record word i packs codes 16i..16i+15. A thread loads 16 B and stores
//   one u32; a warp reads 512 and writes 128 contiguous bytes. Each thread
//   has four loads in flight before its first store.
// - staged (any other S or alignment): a tile of rows (of one row's columns
//   [c, c + kPackTileBytes) where a row is wider than kPackTileBytes; one
//   division per tile finds its row) is one contiguous span of the codes
//   and one of the records. The
//   block copies the code span into shared memory with 16-B cp.async from
//   the first 16-B boundary inside it (the few bytes before and after go
//   one by one, so nothing outside the tensor is read), two tiles in
//   flight; packs from shared memory (two aligned words and a funnel shift
//   per record byte, the codes past the row's end masked off); and writes
//   the record span from shared memory with 16-B stores, its ragged ends
//   byte by byte. Tiles come from blockIdx.x and a stride loop; no thread
//   divides a flat index.
__device__ __forceinline__ uint32_t pack_quad(uint4 c) {
  return pack_word(c.x) | (pack_word(c.y) << 8) | (pack_word(c.z) << 16) |
         (pack_word(c.w) << 24);
}

constexpr int kPackUnroll = 4;

__global__ void pack_codes_flat_kernel(const uint4* __restrict__ codes,
                                       uint32_t* __restrict__ words,
                                       int64_t n_words, int64_t n_bytes) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * kPackUnroll;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x * kPackUnroll + threadIdx.x;
       i < n_words; i += step) {
    uint4 c[kPackUnroll];
#pragma unroll
    for (int k = 0; k < kPackUnroll; ++k) {
      const int64_t at = i + static_cast<int64_t>(k) * blockDim.x;
      if (at < n_words) c[k] = __ldg(codes + at);
    }
#pragma unroll
    for (int k = 0; k < kPackUnroll; ++k) {
      const int64_t at = i + static_cast<int64_t>(k) * blockDim.x;
      if (at < n_words) words[at] = pack_quad(c[k]);
    }
  }
  // the up to three record bytes past the last whole word
  if (blockIdx.x == 0 && threadIdx.x < n_bytes - 4 * n_words) {
    const int64_t b = 4 * n_words + threadIdx.x;
    const uint32_t w = reinterpret_cast<const uint32_t*>(codes)[b];
    reinterpret_cast<uint8_t*>(words)[b] = static_cast<uint8_t>(pack_word(w));
  }
}

// Code bytes of one staged tile (two such buffers and the record tile of a
// quarter of it fit a block's 48 KB), and the blocks that share the card.
constexpr int64_t kPackTileBytes = 16384;
constexpr int64_t kPackMaxTileRows = 64;
constexpr int kStagedBlocks = 132 * 6;

__device__ __forceinline__ void cp_async_16(void* smem, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(global));
}

// Starts the copy of the n global bytes at src into tile, at the offset
// src has from a 16-B boundary: whole 16-B pieces by cp.async, the bytes
// before the first and after the last piece by plain loads.
__device__ __forceinline__ void stage_span(uint8_t* tile, const uint8_t* src, int64_t n) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint8_t* base = src - lead;  // 16-B aligned; tile[k] mirrors base[k]
  const int64_t end = lead + n;
  const int64_t first = lead ? 16 : 0;  // first whole piece
  const int64_t last = end & ~int64_t{15};  // end of the last whole piece
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int64_t at = first + 16 * tid; at < last; at += 16 * threads) {
    cp_async_16(tile + at, base + at);
  }
  if (last <= first) {  // no whole piece: every byte on its own
    for (int64_t at = lead + tid; at < end; at += threads) tile[at] = base[at];
  } else {
    if (lead + tid < first) tile[lead + tid] = base[lead + tid];
    if (last + tid < end) tile[last + tid] = base[last + tid];
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Writes the n bytes of tile at dst's offset from a 16-B boundary (tile[k]
// mirrors the 16-B aligned base dst - lead, as stage_span's tiles do) to
// dst with the block's threads (at least 15): whole 16-B pieces as one
// store each, the bytes before the first and after the last piece one by
// one, so nothing outside [dst, dst + n) is written.
__device__ __forceinline__ void unstage_span(uint8_t* dst, const uint8_t* tile, int64_t n) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* base = dst - lead;
  const int64_t end = lead + n;
  const int64_t first = lead ? 16 : 0;
  const int64_t last = end & ~int64_t{15};
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int64_t at = first + 16 * tid; at < last; at += 16 * threads) {
    *reinterpret_cast<uint4*>(base + at) = *reinterpret_cast<const uint4*>(tile + at);
  }
  if (last <= first) {
    for (int64_t at = lead + tid; at < end; at += threads) base[at] = tile[at];
  } else {
    if (lead + tid < first) base[lead + tid] = tile[lead + tid];
    if (last + tid < end) base[last + tid] = tile[last + tid];
  }
}

// One staged tile: `rows` rows of `width` codes, contiguous from src, to
// rows of `rec` record bytes, contiguous from dst.
struct PackTile {
  const uint8_t* src;
  uint8_t* dst;
  int rows, width, rec;
};

__global__ void pack_codes_staged_kernel(const uint8_t* __restrict__ codes,
                                         uint8_t* __restrict__ packed,
                                         int64_t n_var, int64_t n_samples, int64_t rec,
                                         int tile_rows, int in_bytes, int64_t n_tiles,
                                         int col_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  // two code buffers of in_bytes (a multiple of 16, with room for the lead
  // bytes and the word a funnel shift reads past the span), then the record
  // tile
  uint8_t* out_tile = smem + 2 * in_bytes;
  int64_t tile = blockIdx.x;
  if (tile >= n_tiles) return;
  auto tile_of = [&](int64_t t) {
    PackTile g;
    if (col_tiles == 1) {  // tile_rows whole rows
      const int64_t v0 = t * tile_rows;
      g.rows = static_cast<int>(n_var - v0 < tile_rows ? n_var - v0 : tile_rows);
      g.width = static_cast<int>(n_samples);
      g.rec = static_cast<int>(rec);
      g.src = codes + v0 * n_samples;
      g.dst = packed + v0 * rec;
    } else {  // kPackTileBytes columns (a multiple of 4) of one row
      const int64_t v = t / col_tiles;
      const int64_t at = (t - v * col_tiles) * kPackTileBytes;
      g.rows = 1;
      g.width = static_cast<int>(n_samples - at < kPackTileBytes ? n_samples - at : kPackTileBytes);
      g.rec = (g.width + 3) / 4;
      g.src = codes + v * n_samples + at;
      g.dst = packed + v * rec + at / 4;
    }
    return g;
  };
  PackTile g = tile_of(tile);
  stage_span(smem, g.src, static_cast<int64_t>(g.rows) * g.width);
  int buf = 0;
  for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t next = tile + gridDim.x;
    PackTile g_next = g;
    if (next < n_tiles) {
      g_next = tile_of(next);
      stage_span(smem + (buf ^ 1) * in_bytes, g_next.src,
                 static_cast<int64_t>(g_next.rows) * g_next.width);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile's codes are in shared memory
    const uint32_t* in32 = reinterpret_cast<const uint32_t*>(smem + buf * in_bytes);
    const int in_lead = static_cast<int>(reinterpret_cast<uintptr_t>(g.src) & 15);
    const int out_lead = static_cast<int>(reinterpret_cast<uintptr_t>(g.dst) & 15);
    for (int r = threadIdx.y; r < g.rows; r += blockDim.y) {
      const int row_at = in_lead + r * g.width;
      for (int j = threadIdx.x; j < g.rec; j += blockDim.x) {
        const int at = row_at + 4 * j;
        uint32_t w = __funnelshift_r(in32[at >> 2], in32[(at >> 2) + 1], 8 * (at & 3));
        const int left = g.width - 4 * j;  // codes of this row from byte j on
        if (left < 4) w &= (1u << (8 * left)) - 1u;
        out_tile[out_lead + r * g.rec + j] = static_cast<uint8_t>(pack_word(w));
      }
    }
    __syncthreads();  // the record tile is complete
    unstage_span(g.dst, out_tile, static_cast<int64_t>(g.rows) * g.rec);
    __syncthreads();  // before the next tile overwrites the record tile
    g = g_next;
  }
}

// K5. Replaces the device branch of pgen_tpu/pipeline/pgen_out.py:
// _subset_block, which runs the Pallas _unpack_kernel, an XLA take of the
// kept columns, then the Pallas _pack_kernel.
// (V, R) u8 records + sel (K) int32 sample ids, any order, repeats allowed
// -> (V, ceil(K/4)) u8 records of the kept samples in sel order. Codes past
// K in a row's last byte are zero; source pad codes are never read, since
// only kept ids are.
// Bound: memory, the record bytes that hold a kept sample read once and a
// quarter byte written per kept sample: at K = 1,001 sorted of 2504 a
// 65,536-row block reads 36 MB (87% of its 41 MB) and writes 16 MB, 0.0157
// ms at 3.35 TB/s. Its first form, a thread per output byte of a flat grid,
// paid a 64-bit division and four id loads per byte and then four byte
// gathers that waited on them, re-reading all K ids for every row: latency,
// not bytes, bound it (12% of the bound). Both forms now hold each output
// byte's ids in registers, read once per thread (range-checked there), as
// a record byte and a rotation (repack_ids; each code one rotation and one
// masked or), the pad slots of a last byte masked off, and walk rows; no
// thread divides. Two forms, chosen by the launcher from K and R:
// - staged (ids that touch most of a row: R <= kRepackDenseRatio * K, and
//   K <= 4,096 and R <= kRepackTileBytes): a block takes tiles of
//   consecutive rows, each one contiguous span of the records, and copies
//   it into shared memory with 16-B cp.async (stage_span), the next tile's
//   copy in flight while this tile is gathered (two barriers a tile; a
//   third, or three and four buffers, ran slower); a thread owns 1 or 4
//   output bytes of the row (kPer) and gathers their codes from shared
//   memory, four rows at once, into a shared output tile: the tile's
//   output, rows * ceil(K/4) contiguous bytes, goes out with 16-B stores
//   (unstage_span). Whole rows are read, at most 1/0.87 of the bound's
//   bytes at K = 1,001. The grid is the blocks the card holds at once. The
//   gather's byte loads from shared memory and operations a code bind it.
// - direct (any other shape: few ids, as a --keep of two samples, where
//   staging rows would read 20 times the bytes the ids hold; more ids than
//   a block's threads hold; rows wider than a tile): K3's grid. A block
//   takes a column tile of output bytes (blockIdx.x, threadIdx.x) over rows
//   of threads (threadIdx.y) that step through the rows, each gathering its
//   four codes from global memory through L1, two rows' loads in flight
//   before either store. The staged form has no column tiles: each would
//   re-read whole rows, 10 times the record bytes at 40,000 of 40,003 ids.
// record bytes of one staged tile, and output bytes: two record buffers and
// the output tile stay under the 48 KB a block gets without opting in
constexpr int64_t kRepackTileBytes = 15 * 1024;
constexpr int64_t kRepackMaxTileRows = 64;
constexpr int kRepackMaxPer = 4;  // output bytes a thread of the staged form owns
// staged when R <= kRepackDenseRatio * K, so from K = 157 at R = 626.
// chip_diag.py --forms builds the kernels with -DPGEN_REPACK_DENSE_RATIO=0
// (direct at every K) and with a ratio no K reaches (staged wherever a row
// tile fits) and times both: at 65,536 rows of 2504 samples the staged form
// ran at 0.40-0.94x the direct form's speed at K = 2-32, 1.12-1.23x at 128
// and 256, 1.21-1.49x at 384-768 and 1.62x at 1,001 (NVIDIA H100 80GB HBM3,
// 700 W), so the crossover lies between K = 32 and 128.
#ifndef PGEN_REPACK_DENSE_RATIO
#define PGEN_REPACK_DENSE_RATIO 4
#endif
constexpr int64_t kRepackDenseRatio = PGEN_REPACK_DENSE_RATIO;

// The ids sel[4j .. 4j + 3] of output byte j: each one's record byte, and
// the right rotation that moves its code from bits 2 (s & 3) of that byte
// to bits 2k of the output byte, (2 (s & 3) - 2k) mod 32 (a rotation left
// where the code moves up; the bits rotated round land above bit 7 and are
// masked off). Returns the mask of the byte's valid code bits: zero past K
// and for j >= out_rec, whose ids read byte 0.
__device__ __forceinline__ uint32_t repack_ids(const int32_t* __restrict__ sel, int64_t j,
                                               int64_t n_kept, int64_t out_rec, int64_t rec,
                                               int off[4], uint32_t rot[4]) {
  uint32_t keep = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off[k] = 0;
    rot[k] = 0;
    const int64_t at = 4 * j + k;
    if (j < out_rec && at < n_kept) {
      const int32_t s = sel[at];
      assert(s >= 0 && static_cast<int64_t>(s) < 4 * rec);
      off[k] = s >> 2;
      rot[k] = static_cast<uint32_t>(2 * (s & 3) - 2 * k) & 31u;
      keep |= 3u << (2 * k);
    }
  }
  return keep;
}

// One output byte from the record bytes x[k] of its four ids: a rotation
// and a masked or a code.
__device__ __forceinline__ uint32_t repack_byte(const uint32_t x[4], const uint32_t rot[4],
                                                uint32_t keep) {
  uint32_t b = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) b |= __funnelshift_r(x[k], x[k], rot[k]) & (3u << (2 * k));
  return b & keep;
}

// Blocks of the staged form an SM holds by its registers (at most 64 a
// thread with a byte a thread, 85 with four); its launch bounds.
template <int kPer>
constexpr int kRepackMinBlocks = kPer == kRepackMaxPer ? 3 : 4;

template <int kPer>
__global__ void __launch_bounds__(kThreads, kRepackMinBlocks<kPer>)
    subset_repack_staged_kernel(const uint8_t* __restrict__ packed,
                                const int32_t* __restrict__ sel, uint8_t* __restrict__ out,
                                int64_t n_var, int64_t rec, int64_t n_kept, int tile_rows,
                                int in_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  // two record buffers of in_bytes (a multiple of 16 with room for the lead
  // bytes), then the output tile
  uint8_t* out_tile = smem + 2 * in_bytes;
  const int tid = threadIdx.x;
  const int out_rec = static_cast<int>((n_kept + 3) / 4);  // at most kThreads * kPer
  const int width = static_cast<int>(rec);
  int off[kPer][4];
  uint32_t rot[kPer][4], keep[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    keep[m] = repack_ids(sel, tid + m * kThreads, n_kept, out_rec, rec, off[m], rot[m]);
  }
  const int64_t n_tiles = (n_var + tile_rows - 1) / tile_rows;
  int64_t t = blockIdx.x;
  if (t >= n_tiles) return;
  auto rows_of = [&](int64_t tt) {
    const int64_t v0 = tt * tile_rows;
    return static_cast<int>(n_var - v0 < tile_rows ? n_var - v0 : tile_rows);
  };
  stage_span(smem, packed + t * tile_rows * rec, static_cast<int64_t>(rows_of(t)) * width);
  int buf = 0;
  for (; t < n_tiles; t += gridDim.x, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // this tile's records are in shared memory, and the other buffer and
    // the output tile were last read before this barrier
    __syncthreads();
    const int64_t next = t + gridDim.x;
    if (next < n_tiles) {
      stage_span(smem + (buf ^ 1) * in_bytes, packed + next * tile_rows * rec,
                 static_cast<int64_t>(rows_of(next)) * width);
    }
    const int64_t v0 = t * tile_rows;
    const int rows = rows_of(t);
    const uint8_t* in = smem + buf * in_bytes +
                        (reinterpret_cast<uintptr_t>(packed + v0 * rec) & 15);
    uint8_t* dst = out + v0 * out_rec;
    const int out_lead = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    // four rows at once, row i in byte i of a u32: three byte permutes join
    // the four rows' bytes of an id, and one rotation and one masked or
    // place its code in all four output bytes (a third fewer instructions
    // a code than a row at a time); then the last rows
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
      const uint8_t* row = in + r * width;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int j = tid + m * kThreads;
        if (j < out_rec) {
          uint32_t acc = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint8_t* p = row + off[m][k];
            const uint32_t x = __byte_perm(__byte_perm(p[0], p[width], 0x0040),
                                           __byte_perm(p[2 * width], p[3 * width], 0x0040), 0x5410);
            acc |= __funnelshift_r(x, x, rot[m][k]) & (0x03030303u << (2 * k));
          }
          acc &= keep[m] * 0x01010101u;
          uint8_t* o = out_tile + out_lead + r * out_rec + j;
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i * out_rec] = static_cast<uint8_t>(acc >> (8 * i));
        }
      }
    }
    for (; r < rows; ++r) {
      const uint8_t* row = in + r * width;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int j = tid + m * kThreads;
        if (j < out_rec) {
          const uint32_t x[4] = {row[off[m][0]], row[off[m][1]], row[off[m][2]], row[off[m][3]]};
          out_tile[out_lead + r * out_rec + j] =
              static_cast<uint8_t>(repack_byte(x, rot[m], keep[m]));
        }
      }
    }
    __syncthreads();  // the output tile is complete
    unstage_span(dst, out_tile, static_cast<int64_t>(rows) * out_rec);
  }
}

__global__ void subset_repack_direct_kernel(const uint8_t* __restrict__ packed,
                                            const int32_t* __restrict__ sel,
                                            uint8_t* __restrict__ out, int64_t n_var,
                                            int64_t rec, int64_t n_kept, int64_t out_rec) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_rec) return;
  int off[4];
  uint32_t rot[4];
  const uint32_t keep = repack_ids(sel, j, n_kept, out_rec, rec, off, rot);
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.y;
  int64_t v = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y;
  auto gather = [&](int64_t row) {
    const uint8_t* p = packed + row * rec;
    const uint32_t x[4] = {__ldg(p + off[0]), __ldg(p + off[1]), __ldg(p + off[2]),
                           __ldg(p + off[3])};
    return static_cast<uint8_t>(repack_byte(x, rot, keep));
  };
  for (; v + step < n_var; v += 2 * step) {
    const uint8_t a = gather(v), b = gather(v + step);
    out[v * out_rec + j] = a;
    out[(v + step) * out_rec + j] = b;
  }
  if (v < n_var) out[v * out_rec + j] = gather(v);
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

// K8. Replaces pgen_tpu/ops/gt_stats.py:gt_counts_device: the Pallas
// _unpack_kernel (ops/unpack.py) then an XLA one-hot sum over the samples.
// (V, R) u8 records -> (V, 4) int32: counts[v][c] = #{s < S : code(v, s) == c}.
// Bound: memory, one read of each record byte that holds a sample and 16 B
// written per row: 65,536 x 626 B reads 41 MB, 0.0126 ms at 3.35 TB/s.
// Design: a warp takes two rows (row_code_counts). Counting does not depend
// on byte order, so a lane loads whole aligned 16-B words: the words that
// hold a byte of a row's used span [row, row + ceil(S/4)), lanes on
// consecutive words, two words of each row a lane (a 626-B row is 40 or 41
// words), all four issued before any popcount, so a warp load instruction
// moves 512 B (its first form, lane l on bytes l, l+32, ..., moved 32 B and
// left too few bytes in flight to near the card's rate). Per
// word the slots outside [0, S) of the row, the bytes of the neighbouring
// rows and the pad codes of the span's last byte, are masked off; no funnel
// shift and no next-word load. Every load holds a byte of the tensor, and an
// aligned 16-B word that holds a byte of an allocation lies inside it (CUDA
// and PyTorch's caching allocator hand out blocks aligned to 512 B or more),
// so no load leaves the tensor's allocation, at its last byte included.
// Counts from popcounts on 32-bit lanes, with m the mask of the counted
// slots' low bits: L = popc(x & m), H = popc((x >> 1) & m), B = popc(x &
// (x >> 1) & m); c1 = L - B, c2 = H - B, c3 = B, c0 = S - L - H + B. The warp
// sums L, H and B with three __reduce_add_sync. K11's flat form and its
// count pass count their rows with the same row_code_counts.
constexpr int kWarp = 32;

// Bit 0 of each 2-bit slot of a u32 in [a, b), each clamped to [0, 16]:
// the first n slots' bits are the top 2n bits of 0x55555555 shifted out of
// a 64-bit pair, __funnelshift_lc, which is defined for every n up to 16 (a
// shift of 32 included). Masks from plain shifts, (1u << 2n) - 1 behind a
// test of n == 16, then from 64-bit shifts with 32-bit offsets, came out
// wrong on the card (nvcc 12.8, sm_90a: slots of the neighbouring rows
// counted, whole u32s of the row lost) where g++ computed them right.
__device__ __forceinline__ uint32_t slot_bits(int a, int b) {
  a = a < 0 ? 0 : (a > 16 ? 16 : a);
  b = b < 0 ? 0 : (b > 16 ? 16 : b);
  return __funnelshift_lc(0x55555555u, 0u, 2 * b) & ~__funnelshift_lc(0x55555555u, 0u, 2 * a);
}

// Adds the L, H and B of the slots [a, b) of one 16-B word (a, b clamped to
// [0, 64]; every slot of a word inside the row's span: a = 0, b = 64). The
// counted bits of a u32 sit at even positions, so two u32s' bits share one
// popcount: popc(lo0 | lo1 << 1) = popc(lo0) + popc(lo1), six popcounts a
// word where one a u32 and bit made twelve.
__device__ __forceinline__ void count_word(uint4 x, int a, int b, uint32_t& l, uint32_t& h,
                                           uint32_t& both) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t m[4];
  if (a == 0 && b == 64) {
    m[0] = m[1] = m[2] = m[3] = 0x55555555u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = slot_bits(a - 16 * q, b - 16 * q);
  }
#pragma unroll
  for (int q = 0; q < 4; q += 2) {
    const uint32_t lo0 = w[q] & m[q], hi0 = (w[q] >> 1) & m[q];
    const uint32_t lo1 = w[q + 1] & m[q + 1], hi1 = (w[q + 1] >> 1) & m[q + 1];
    l += __popc(lo0 | (lo1 << 1));
    h += __popc(hi0 | (hi1 << 1));
    both += __popc((lo0 & hi0) | ((lo1 & hi1) << 1));
  }
}

// Code counts c[r][0..3] of samples [0, n_samples) of kRows rows, rows[r] at
// any byte address (a null row reads and counts nothing), for every lane of
// the calling warp; every lane of the warp must call it. Each lane issues the
// loads of all kRows rows' words before any popcount. Word indices are
// 32-bit (rows under 2 GB): 64-bit ones took K8 from 64 to 72 registers
// and 1.5x the time. The slot offsets stay 64-bit: with 32-bit ones the
// card (nvcc 12.8, sm_90a) gave a lane's second word the first word's
// clamped end slot, so a row's last word counted the next row's codes;
// the same source computes right under g++.
template <int kRows>
__device__ __forceinline__ void row_code_counts(const uint8_t* const (&rows)[kRows],
                                                int n_samples, int lane,
                                                uint32_t (&c)[kRows][4]) {
  const int used = (n_samples + 3) / 4;
  const uint4* base[kRows];
  int n_words[kRows];
  int64_t first_slot[kRows];
  int most = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(rows[r]) & 15);
    base[r] = reinterpret_cast<const uint4*>(rows[r] - lead);  // 16-B aligned
    n_words[r] = rows[r] != nullptr ? (lead + used + 15) / 16 : 0;
    first_slot[r] = 4 * lead;  // word w holds slots [64 w, 64 w + 64) from base
    most = n_words[r] > most ? n_words[r] : most;
  }
  uint32_t l[kRows], h[kRows], both[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) l[r] = h[r] = both[r] = 0;
  auto clamp64 = [](int64_t at) { return static_cast<int>(at < 0 ? 0 : (at > 64 ? 64 : at)); };
  for (int w = lane; w < most; w += 2 * kWarp) {
    uint4 x[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int at = w + k * kWarp;
        x[r][k] = at < n_words[r] ? __ldg(base[r] + at) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int64_t a = first_slot[r] - int64_t{64} * (w + k * kWarp);
        count_word(x[r][k], clamp64(a), clamp64(a + n_samples), l[r], h[r], both[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    l[r] = __reduce_add_sync(0xFFFFFFFFu, l[r]);
    h[r] = __reduce_add_sync(0xFFFFFFFFu, h[r]);
    both[r] = __reduce_add_sync(0xFFFFFFFFu, both[r]);
    c[r][0] = static_cast<uint32_t>(n_samples) - l[r] - h[r] + both[r];
    c[r][1] = l[r] - both[r];
    c[r][2] = h[r] - both[r];
    c[r][3] = both[r];
  }
}

// Two rows a warp: rows 2g and 2g + 1 of warp g, then those a grid of warps
// later. Four blocks an SM: 64 registers at most (uncapped, 72 ran slower).
__global__ void __launch_bounds__(kThreads, 4)
    gt_counts_kernel(const uint8_t* __restrict__ packed, int4* __restrict__ counts, int64_t n_var,
                     int64_t rec, int n_samples) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  // v is the same for every lane of a warp, so the whole warp takes part in
  // each reduction
  for (int64_t v = 2 * (first_index() / kWarp); v < n_var; v += 2 * warps) {
    const uint8_t* const rows[2] = {packed + v * rec,
                                    v + 1 < n_var ? packed + (v + 1) * rec : nullptr};
    uint32_t c[2][4];
    row_code_counts<2>(rows, n_samples, lane, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (lane == r && v + r < n_var) {
        counts[v + r] = make_int4(static_cast<int>(c[r][0]), static_cast<int>(c[r][1]),
                                  static_cast<int>(c[r][2]), static_cast<int>(c[r][3]));
      }
    }
  }
}

// K14. Replaces the host count of a sample subset, pgen_tpu/ops/gt_stats.py:
// gt_counts_subset (its 4-bit keep mask per record byte from
// sample_byte_masks, then the native C++ or a 16 x 256 LUT), on every
// cohort-aware path: the GT_* variables of a variant query under a sample
// query, the reports with a sample query, fst's cohorts, score --center and
// genome's frequencies on a cohort.
// (V, R) u8 records, P <= 32 keep masks as E words (ops/gt_stats.py:
// mask_words: bit k of mask byte j at bit 2k of byte j, the low bit of its
// slot; each mask's row padded with zeros to a multiple of 32 B) and their
// kept counts K_p -> (V, P, 4) int32: counts[v][p][c] =
// #{slots s kept by mask p : code(v, s) == c}.
// Bound: memory, one read of each record byte that holds a kept sample and
// 16 P B of counts a row: a 65,536-row block of 626 B at P = 1 (a sorted
// cohort of 1,001) moves 36.6 MB, 0.0109 ms at 3.35 TB/s; at P = 26 (a
// partition of 2504 samples) 68.3 MB, 0.0204 ms.
// Design: with L = #(kept, low bit set), H = #(kept, high bit set) and B =
// #(kept, both set), c0 = K_p - L - H + B, c1 = L - B, c2 = H - B, c3 = B;
// over a row's words x, L = popc(x & E_p), H = popc(x & E_p << 1) and B =
// popc(x & x >> 1 & E_p): a binary product of the rows by the masks.
// - Staging: a block takes tiles of kMaskedRows consecutive rows through
//   kMaskedStages buffers in shared memory, filled by bulk copies (the
//   tensor memory accelerator, completing on an mbarrier) that a producer
//   warp issues up to kMaskedStages steps ahead of the four counting warps
//   (full and empty barriers a stage, no block-wide barrier in the loop).
//   Rows of up to kMaskedWholeRow bytes: one copy of the aligned 16-B
//   words that hold a tile, the masks' E words copied once per block.
//   Longer rows: kMaskedChunk-byte chunks of their columns, each row's
//   chunk copied into a slot of its own, the masks' E words of the chunk
//   beside it; a block counts the chunks of a tile in turn into the same
//   registers (enough tiles: all of a tile's chunks, then plain stores;
//   few: groups of chunks, each adding its counts to zeroed counts with
//   atomics). A row is read at its byte offset by funnel shifts, so one
//   copy of each mask's E words serves every row. Per-thread 16-B cp.async
//   staging was slower at every P; with warp 0 both staging and counting
//   and a __syncthreads a step, copies and counting barely overlapped (on
//   rows of 40,003 samples at one mask the two together took about the
//   sum of each alone, and lost to a warp a row reading global memory).
// - Counting: a warp takes 16 rows and, per 32 record bytes and for each
//   eight masks, three mma.sync m16n8k256 .b1 AND-POPC: the rows' words
//   against (E_p, E_p << 1) of masks 0-3 and of masks 4-7 (L and H; the
//   second skipped when P <= 4), and the rows' x & x >> 1 against E_p of
//   all eight (B), its columns ordered so that each lane ends with L, H
//   and B of the same two masks for two rows: every mask of the launch in
//   one pass over the row, no reduction, no popcount. The kernel is built
//   for one, two or four eights of masks, so few masks hold few registers.
//   The card runs these products at 10 POPS (chip_diag.py --rates): they
//   do not bind. A CUDA-core popcount form (6 popcounts a 16-B word and
//   mask) only tied it at one mask and lost from two on.
constexpr int kMaskedRows = 64;           // rows of a staged tile
constexpr int kMaskedMaxMasks = 32;       // keep masks of one launch
constexpr int64_t kMaskedWholeRow = 640;  // record bytes of a row staged whole
constexpr int64_t kMaskedChunk = 512;     // record bytes of a chunk of a longer row
constexpr int kMaskedStages = 2;          // tiles of a block in shared memory
constexpr int kMaskedThreads = kWarp * kMaskedRows / 16;  // a warp for each 16 rows

struct MaskedArgs {
  const uint8_t* packed;
  const uint32_t* words;  // (P, word_stride) E words of the masks
  const int* kept;
  int4* counts;
  int64_t n_var, rec;
  int n_items;             // an item: a tile's group of chunks
  int n_masks, mask_rows;  // mask_rows: masks in shared memory (zero past n_masks)
  int chunk, n_chunks;     // record bytes of a chunk (R when a row is whole), chunks a row
  int group, n_groups;     // chunks an item counts, items a tile (more than one: atomics)
  int pitch;               // bytes of a row's slot in shared memory (rows in chunks)
  int tile_bytes;          // bytes of a staged tile
  int word_stride;         // E words of a mask in the operand: 8 ceil(R / 32)
  int mask_stride;         // u32 between masks in shared memory
  int n_mbufs;             // mask buffers: 1 (whole rows) or kMaskedStages
};

// A step of a block: chunk c of an item (tile `unit`, chunks [c0, end)),
// the item's tile and range worked out once per item.
struct MaskedStep {
  int item, unit, c, end;
  bool first;  // the item holds chunk 0 (it brings K_p)
};

__device__ __forceinline__ MaskedStep item_step(const MaskedArgs& a, int item) {
  MaskedStep s;
  const int group = a.n_groups == 1 ? 0 : item % a.n_groups;
  s.item = item;
  s.unit = a.n_groups == 1 ? item : item / a.n_groups;
  s.c = group * a.group;
  s.end = s.c + a.group < a.n_chunks ? s.c + a.group : a.n_chunks;
  s.first = group == 0;
  return s;
}

// The step after s in the block's order: the item's next chunk, else the
// first chunk of the block's next item.
__device__ __forceinline__ void next_step(const MaskedArgs& a, MaskedStep& s) {
  if (++s.c == s.end) s = item_step(a, s.item + static_cast<int>(gridDim.x));
}

// Row v's chunk c: its first record byte, and its byte count.
__device__ __forceinline__ const uint8_t* chunk_start(const MaskedArgs& a, int64_t v, int c) {
  return a.packed + v * a.rec + static_cast<int64_t>(c) * a.chunk;
}

__device__ __forceinline__ int chunk_len(const MaskedArgs& a, int c) {
  const int64_t left = a.rec - static_cast<int64_t>(c) * a.chunk;
  return static_cast<int>(left < a.chunk ? left : a.chunk);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The stage's barrier expects `bytes` more of its copies, and the calling
// thread arrives on it.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy (the tensor memory accelerator) of `bytes` (a multiple of
// 16, both addresses 16-B aligned) that completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred ready;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
      "@!ready bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Starts the copies of step s into a stage (tile, mbuf), completing on bar;
// called by the producer warp. Whole rows: one copy of the aligned 16-B words that
// hold the tile's rows, row r's first byte at row_offset. Rows in chunks:
// each row's chunk into a slot of its own, one copy a row. The masks' E
// words of the chunk, 32 ceil(len / 32) bytes of each mask (inside its
// padded row of the operand), when `masks`. An aligned 16-B word holding a
// byte of the tensor lies inside its allocation, as in K8.
__device__ void stage_step(const MaskedArgs& a, uint8_t* tile, uint32_t* mbuf, MaskedStep s,
                           bool masks, uint64_t* bar) {
  const int lane = threadIdx.x % kWarp;
  const int64_t v0 = static_cast<int64_t>(s.unit) * kMaskedRows;
  const int64_t rows = a.n_var - v0 < kMaskedRows ? a.n_var - v0 : kMaskedRows;
  const int len = chunk_len(a, s.c);
  const uint32_t mask_bytes = static_cast<uint32_t>(32 * ((len + 31) / 32));
  // whatever the stage held was read before the consumers released it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint8_t* first = a.packed + v0 * a.rec;
  const uint8_t* base = first - (reinterpret_cast<uintptr_t>(first) & 15);
  uint32_t whole = 0, mine = 0;
  if (a.n_chunks == 1) {
    whole = static_cast<uint32_t>((first + rows * a.rec - base + 15) / 16 * 16);
    mine = lane == 0 ? whole : 0;
  } else {
    for (int r = lane; r < rows; r += kWarp) {
      const uint8_t* src = chunk_start(a, v0 + r, s.c);
      mine += static_cast<uint32_t>(((reinterpret_cast<uintptr_t>(src) & 15) + len + 15) / 16 * 16);
    }
  }
  if (masks) {
    for (int p = lane; p < a.n_masks; p += kWarp) mine += mask_bytes;
  }
  const uint32_t total = __reduce_add_sync(0xFFFFFFFFu, mine);
  if (lane == 0) expect_bytes(bar, total);
  __syncwarp();
  if (a.n_chunks == 1) {
    if (lane == 0) bulk_copy(tile, base, whole, bar);
  } else {
    for (int r = lane; r < rows; r += kWarp) {
      const uint8_t* src = chunk_start(a, v0 + r, s.c);
      const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      bulk_copy(tile + r * a.pitch, src - lead, static_cast<uint32_t>((lead + len + 15) / 16 * 16),
                bar);
    }
  }
  if (masks) {
    for (int p = lane; p < a.n_masks; p += kWarp) {
      bulk_copy(mbuf + p * a.mask_stride,
                a.words + static_cast<int64_t>(p) * a.word_stride + s.c * (a.chunk / 4),
                mask_bytes, bar);
    }
  }
}

// Byte offset in its tile of row r's first byte of chunk c (unit's rows).
__device__ __forceinline__ int row_offset(const MaskedArgs& a, int64_t unit, int c, int r) {
  if (a.n_chunks == 1) {
    const uint8_t* first = a.packed + unit * kMaskedRows * a.rec;
    return static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15) + r * static_cast<int>(a.rec);
  }
  const uint8_t* src = chunk_start(a, unit * kMaskedRows + r, c);
  return r * a.pitch + static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Word w of the row whose first byte is byte `off` of the tile: two
// aligned u32 and a funnel shift.
__device__ __forceinline__ uint32_t row_word(const uint32_t* tile, int off, int w) {
  const int at = (off >> 2) + w;
  return __funnelshift_r(tile[at], tile[at + 1], 8 * (off & 3));
}

// d += popc(A & B) over 256 bits: A 16 rows (a0, a2 row g; a1, a3 row g +
// 8; words t and t + 4 of the 32 bytes), B 8 columns (b0, b1: column g,
// words t and t + 4), lane = 4 g + t; d: rows g, g + 8 x columns 2t, 2t + 1.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&x)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(b0), "r"(b1));
}

// The products' sums of a lane: L, H and B of kOcts eights of masks (1, 2
// or 4) for two rows.
template <int kOcts>
using MaskedAcc = int[kOcts][3][4];

template <int kOcts>
__device__ __forceinline__ void clear_acc(MaskedAcc<kOcts>& acc) {
#pragma unroll
  for (int m = 0; m < kOcts; ++m)
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[m][k][0] = acc[m][k][1] = acc[m][k][2] = acc[m][k][3] = 0;
}

// Warp w adds the counts of chunk c of tile rows 16 w .. 16 w + 15 against
// every mask to acc. Per eight masks 8m..8m+7 three products: columns
// (E_p, E_p << 1) of masks 8m + 0..3 and of 8m + 4..7 give L and H,
// columns E_p of masks 8m + (0, 4, 1, 5, 2, 6, 3, 7) against x & x >> 1
// give B, so lane 4g + t holds L, H and B of masks 8m + t and 8m + 4 + t
// for rows g and g + 8.
template <int kOcts>
__device__ __forceinline__ void count_masked(const MaskedArgs& a, const uint8_t* tile,
                                             const uint32_t* mbuf, int64_t unit, int c,
                                             MaskedAcc<kOcts>& acc) {
  const int len = chunk_len(a, c);
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;
  const int r = 16 * (threadIdx.x / kWarp) + g;
  const int64_t v = unit * kMaskedRows + r;
  const int off[2] = {v < a.n_var ? row_offset(a, unit, c, r) : 0,
                      v + 8 < a.n_var ? row_offset(a, unit, c, r + 8) : 0};
  const uint32_t* tile32 = reinterpret_cast<const uint32_t*>(tile);
  const int n_oct = (a.n_masks + 7) / 8;
  // B-plane columns: column g is mask 8m + g / 2 + 4 (g % 2)
  const int lh0 = (g / 2) * a.mask_stride, lh1 = (4 + g / 2) * a.mask_stride;
  const int bp = (g / 2 + 4 * (g % 2)) * a.mask_stride;
  const int odd = g % 2;
  for (int w = t; w < 8 * ((len + 31) / 32); w += 8) {
    const uint32_t x[4] = {row_word(tile32, off[0], w), row_word(tile32, off[1], w),
                           row_word(tile32, off[0], w + 4), row_word(tile32, off[1], w + 4)};
    const uint32_t xb[4] = {x[0] & (x[0] >> 1), x[1] & (x[1] >> 1), x[2] & (x[2] >> 1),
                            x[3] & (x[3] >> 1)};
#pragma unroll
    for (int m = 0; m < kOcts; ++m) {
      if (m < n_oct) {
        const uint32_t* e = mbuf + 8 * m * a.mask_stride + w;
        mma_and_popc(acc[m][0], x, e[lh0] << odd, e[lh0 + 4] << odd);
        // masks 4..7, none when P <= 4; tested only in the one-eight
        // kernel, so the others keep their products free of branches
        if (kOcts > 1 || 4 < a.n_masks) {
          mma_and_popc(acc[m][1], x, e[lh1] << odd, e[lh1 + 4] << odd);
        }
        mma_and_popc(acc[m][2], xb, e[bp], e[bp + 4]);
      }
    }
  }
}

// Stores (or, when a tile has several items, adds) the counts of this
// lane's rows and masks from acc, then clears acc; the item holding chunk
// 0 brings K_p.
template <int kOcts>
__device__ __forceinline__ void put_counts(const MaskedArgs& a, const MaskedStep& step,
                                           MaskedAcc<kOcts>& acc) {
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;
  const int64_t v0 = static_cast<int64_t>(step.unit) * kMaskedRows + 16 * (threadIdx.x / kWarp) + g;
#pragma unroll
  for (int m = 0; m < kOcts; ++m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 8 * m + 4 * half + t;
        const int64_t v = v0 + 8 * s;
        if (p < a.n_masks && v < a.n_var) {
          const int l = acc[m][half][2 * s], h = acc[m][half][2 * s + 1];
          const int both = acc[m][2][2 * s + half];
          const int k = step.first ? __ldg(a.kept + p) : 0;
          const int4 out = make_int4(k - l - h + both, l - both, h - both, both);
          int4* at = a.counts + v * a.n_masks + p;
          if (a.n_groups == 1) {
            *at = out;
          } else {
            int* sum = reinterpret_cast<int*>(at);
            atomicAdd(sum, out.x);
            atomicAdd(sum + 1, out.y);
            atomicAdd(sum + 2, out.z);
            atomicAdd(sum + 3, out.w);
          }
        }
      }
    }
  }
  clear_acc(acc);
}

// kOcts: the eights of masks a launch counts, rounded up to 1, 2 or 4.
// Warps 0-3 count (consumers), warp 4 only stages (the producer): stage k
// is full when its copies land (full[k]) and empty when every consumer
// warp has read it (empty[k]), so the copies run up to kMaskedStages steps
// ahead of the counting and nothing else holds either side.
template <int kOcts>
__global__ void __launch_bounds__(kMaskedThreads + kWarp) gt_counts_masked_kernel(MaskedArgs a) {
  // kMaskedStages tiles, n_mbufs buffers of the masks' E words, then the
  // full and the empty barrier of each stage
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + kMaskedStages * a.tile_bytes);
  const int mbuf_words = a.mask_rows * a.mask_stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(masks + a.n_mbufs * mbuf_words);
  uint64_t* empty = full + kMaskedStages;
  if (static_cast<int>(blockIdx.x) >= a.n_items) return;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kMaskedStages; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + k)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(empty + k)),
                   "r"(kMaskedThreads / kWarp));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the mask rows past n_masks, which no copy writes, count nothing
  const int pad = (a.mask_rows - a.n_masks) * a.mask_stride;
  for (int i = threadIdx.x; i < a.n_mbufs * pad; i += blockDim.x) {
    masks[(i / pad) * mbuf_words + a.n_masks * a.mask_stride + i % pad] = 0;
  }
  __syncthreads();
  const auto mbuf = [&](int stage) { return masks + (a.n_mbufs == 1 ? 0 : stage) * mbuf_words; };
  // steps j = 0, 1, ... of the block, step j in stage j % kMaskedStages
  const MaskedStep start = item_step(a, static_cast<int>(blockIdx.x));
  if (threadIdx.x >= kMaskedThreads) {
    MaskedStep fill = start;
    for (int j = 0; fill.item < a.n_items; ++j) {
      const int k = j % kMaskedStages;
      // the consumers read this stage's step j - kMaskedStages
      if (j >= kMaskedStages) {
        wait_parity(empty + k, static_cast<uint32_t>((j / kMaskedStages - 1) & 1));
      }
      stage_step(a, smem + k * a.tile_bytes, mbuf(k), fill, a.n_chunks > 1 || j == 0, full + k);
      next_step(a, fill);
    }
    return;
  }
  MaskedAcc<kOcts> acc;
  clear_acc(acc);
  MaskedStep cur = start;
  for (int j = 0; cur.item < a.n_items; ++j) {
    const int k = j % kMaskedStages;
    wait_parity(full + k, static_cast<uint32_t>((j / kMaskedStages) & 1));
    count_masked(a, smem + k * a.tile_bytes, mbuf(k), cur.unit, cur.c, acc);
    __syncwarp();
    if (threadIdx.x % kWarp == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(empty + k))
                   : "memory");
    }
    const MaskedStep done = cur;
    next_step(a, cur);
    if (cur.item != done.item) put_counts(a, done, acc);
  }
}

// K9. Replaces pgen_tpu/ops/gt_stats.py:sample_counts_device: the Pallas
// _unpack_kernel then an XLA one-hot sum over the variants.
// (V, R) u8 records -> (4R, 4) int32 counts (cleared by the launcher; the
// wrapper cuts them to S rows): counts[4j+k][c] = #{v : code of slot k of
// byte j == c}. Pad slots are counted into rows >= S and cut away.
// Bound: memory, one read of each record byte: a 65,536-row block of 626 B
// reads 41 MB, 0.0123 ms at 3.35 TB/s; at score's 16,384 rows 0.0031 ms,
// which launch latency passes.
// Design: a thread counts one word column (record bytes 4w..4w+3, 16
// slots) over rows. A block takes a chunk of rows [r0, r1) (blockIdx.y)
// and up to kCountMaxSegs segments of 32 columns (blockIdx.x; one block
// holds a whole 1000 Genomes row, 5 segments): warp y takes segment
// y % segs and rows r0 + y / segs + groups j, groups = 16 / segs, so the
// block's warps read consecutive whole rows together: its first form, a
// 128-B column slice of rows in each of five blocks, read them several
// times slower.
// - Loads: a row starts at any byte (R % 4 != 0 at 2503 samples), so each
//   word comes from two aligned loads and a funnel shift (record_word);
//   eight rows' loads are in flight at once.
// - Counts, bit-parallel: with L, H and B the rows in which a slot's low
//   bit, high bit, or both are set, c1 = L - B, c2 = H - B, c3 = B and
//   c0 = rows - L - H + B. Six masks of 4-bit fields (L, H and B of the
//   even and of the odd slots, one slot a field) take one AND and one add
//   each a row; every 8 rows they spread into 8-bit fields, and every 248
//   rows those are added to the block's shared totals of the column (a
//   shared atomic per field, at most 16-way).
// - At the end each block adds its (c0, c1) and (c2, c3) of every slot as
//   two 64-bit atomics (no carry: each count < 2^31). A block holds whole
//   rows, so each of the grid's row chunks adds to every pair: 264 64-bit
//   atomics per pair at 65,536 rows (two blocks per SM, kCountBlocks),
//   where the thread-per-byte form made 256 per int. Summing 8 chunks in a
//   thread block cluster first (32 atomics a pair) ran slower, even with
//   the grid cut to the 32 clusters of 8 blocks an H100 runs at once.
constexpr int kCountWarps = 16;             // warps of a K9 block
constexpr int kCountBlocks = 2 * 132;       // two blocks on each of the card's SMs
constexpr int64_t kCountMinRows = 32;       // rows of a warp at the least
constexpr int kCountUnroll = 8;             // rows of a warp in flight
constexpr int64_t kCountMaxSegs = 16;       // 32-column segments of a block: 2 KB of a row
constexpr uint32_t kNibbles = 0x11111111u;  // bit 0 of each 4-bit field

// Record bytes [at, at + 4) of a row (at < rec) as a little-endian u32: the
// aligned word that holds byte `at` and the next one, funnel-shifted. The
// next word is clamped to `last`, the tensor's last aligned word, so every
// load holds a byte of the tensor; bytes past the row's end are whatever
// follows it, and their slots lie at or past 4R, never written.
__device__ __forceinline__ uint32_t record_word(const uint8_t* row, int64_t at,
                                                const uint32_t* last) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(row + at);
  const uint32_t* word = reinterpret_cast<const uint32_t*>(p & ~uintptr_t{3});
  const uint32_t* next = word + 1 <= last ? word + 1 : last;
  return __funnelshift_r(__ldg(word), __ldg(next), 8 * static_cast<int>(p & 3));
}

// Adds the 8-bit fields of byt (quantity q: 0 L, 1 H of the even slots, 2 L,
// 3 H of the odd slots, 4 B even, 5 B odd; byt[q][h] byte j is 4-bit field
// 2j + h, the slot 2 (2j + h) or one more) to one word column's shared
// totals, (slot, L/H/B) at 3 slot + t.
__device__ __forceinline__ void spill_counts(uint32_t* column, const uint32_t byt[6][2]) {
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int odd = q == 2 || q == 3 || q == 5;
    const int t = q < 4 ? q % 2 : 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t n = (byt[q][h] >> (8 * j)) & 0xFFu;
        if (n) atomicAdd(column + 3 * (2 * (2 * j + h) + odd) + t, n);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarp * kCountWarps, 2)
    sample_counts_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ counts,
                         int64_t n_var, int64_t rec, int64_t chunk_rows, int segs) {
  // per column of the block and slot: L, H, B
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  const int tx = threadIdx.x, wy = threadIdx.y, tid = wy * kWarp + tx;
  const int cols = segs * kWarp;  // columns of the block
  for (int i = tid; i < cols * 48; i += kWarp * kCountWarps) cnt[i] = 0;
  __syncthreads();
  const int groups = kCountWarps / segs, seg = wy % segs, g = wy / segs;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * cols;  // the block's first column
  const int64_t col = col0 + seg * kWarp + tx;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < n_var ? r0 + chunk_rows : n_var;
  const uint32_t* last = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(packed + n_var * rec - 1) & ~uintptr_t{3});
  if (g < groups && col < (rec + 3) / 4) {
    uint32_t* column = cnt + 48 * (seg * kWarp + tx);
    uint32_t nib[6] = {0, 0, 0, 0, 0, 0};
    uint32_t byt[6][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}, {0, 0}, {0, 0}};
    int in_byt = 0;  // rows held in the 8-bit fields
    for (int64_t v = r0 + g; v < r1; v += kCountUnroll * groups) {
      uint32_t x[kCountUnroll];
#pragma unroll
      for (int k = 0; k < kCountUnroll; ++k) {
        const int64_t r = v + k * groups;
        // a row past r1 adds nothing: a zero word sets no bit
        x[k] = r < r1 ? record_word(packed + r * rec, 4 * col, last) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kCountUnroll; ++k) {
        const uint32_t a = x[k], a1 = a >> 1, a2 = a >> 2, a3 = a >> 3;
        nib[0] += a & kNibbles;
        nib[1] += a1 & kNibbles;
        nib[2] += a2 & kNibbles;
        nib[3] += a3 & kNibbles;
        nib[4] += a & a1 & kNibbles;
        nib[5] += a2 & a3 & kNibbles;
      }
      // 8 rows into the 4-bit fields (at most 15 each), then into the 8-bit
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        byt[q][0] += nib[q] & 0x0F0F0F0Fu;
        byt[q][1] += (nib[q] >> 4) & 0x0F0F0F0Fu;
        nib[q] = 0;
      }
      if ((in_byt += kCountUnroll) == 248) {  // at most 255 each
        spill_counts(column, byt);
#pragma unroll
        for (int q = 0; q < 6; ++q) byt[q][0] = byt[q][1] = 0;
        in_byt = 0;
      }
    }
    spill_counts(column, byt);
  }
  __syncthreads();
  // two 64-bit atomics per slot: (c0, c1) and (c2, c3)
  const uint64_t rows = static_cast<uint64_t>(r1 - r0);
  for (int i = tid; i < cols * 16; i += kWarp * kCountWarps) {
    const int64_t slot = 16 * col0 + i;
    if (slot >= 4 * rec) break;
    const uint32_t* c = cnt + 3 * i;
    const uint64_t l = c[0], h = c[1], b = c[2];
    auto* out = reinterpret_cast<unsigned long long*>(counts + 4 * slot);
    atomicAdd(out, static_cast<unsigned long long>((rows - l - h + b) | ((l - b) << 32)));
    atomicAdd(out + 1, static_cast<unsigned long long>((h - b) | (b << 32)));
  }
}

// The operand kernels hold each row's code counts as four 16-bit fields of
// one u64 per thread; a thread sees at most kPlaneChunk / 32 codes of a
// row, so every field stays below 2^16.
__device__ __forceinline__ uint64_t count_code(uint64_t acc, uint32_t code) {
  return acc + (1ull << (16 * code));
}

constexpr int kMaxPlanes = 3;

// K10. Replaces the decode legs of pgen_tpu/ops/glm.py's three device scans
// (_glm_moments_device_jit :168-184, _glm_geno_moments_device_jit :613-626,
// _glm_int_moments_device_jit :1006-1022): the Pallas _unpack_kernel, the
// XLA take of the cohort's columns and the f32 mask/dosage/indicator
// planes that feed the moment products (torch.matmul in the wrapper's
// caller, as pgen_tpu leaves them to jnp.matmul).
// (V, R) u8 records + sel (K) int32 ids (or null: K = S) + lut (P, 4) f32
// -> planes (P, V, K) f32, planes[p][v][j] = lut[p][code(v, sel[j])], and
// hist (V, 4) int32, the counts of the K selected codes of each row, so n,
// sum g and sum g^2 come out exact (pgen_tpu's f32 sums of 0/1/2/4 are
// exact too).
// Bound: memory, 4P B written per selected sample against a quarter byte
// read: a 16,384-row block at K = 2,504 and P = 3 writes 492 MB, 0.150 ms
// at 3.35 TB/s. Design: a tile is rows of the K columns, fewer as K grows;
// past kPlaneChunk columns it is one row of a chunk of them and blockIdx.y
// names the chunk, so the ids and codes of a block always fit
// kPlaneSmemBytes. Where a row's counts come from several warps or chunks
// they meet in hist by atomic adds (the launcher clears it first).
// - A block copies its chunk's ids into shared memory once (range-checked
//   there) and keeps them for every tile of its stride loop. Decode: one
//   warp per row (8, 4 or 2 where a tile has 1, 2 or up to 4 rows), its
//   lanes striding over the K columns, reads the row's bytes through L1,
//   writes the codes, one byte each, into a shared tile and counts them in
//   registers (16-bit fields; a lane sees at most kPlaneChunk / 32 codes);
//   a shuffle tree sums them and lane 0 writes the row's four counts as one
//   16 B store (or adds them). One barrier. Store: each plane's part of
//   the tile is the contiguous span [v0 K, v1 K) of floats (of one row's
//   chunk, [v K + c0, v K + c0 + kc)),
//   whatever K % 4 is; the block writes it with 16 B streaming stores from
//   the span's first 16-B boundary (the planes pass the 50 MB L2 long
//   before the product reads them), each taking its four codes from shared
//   memory with two aligned word loads and a funnel shift, then the look-up
//   table; at most 3 floats before and 3 after go one by one.
// The tiling (operand_tiles), the id copy (stage_ids), the decode
// (decode_row) and the store (store_span) are shared with K11, whose tile
// bytes carry the row beside the code.
constexpr int64_t kPlaneSmemBytes = 96 * 1024;
constexpr int64_t kPlaneChunk = 8192;  // columns of one block: 32 KB of ids
constexpr int64_t kPlaneTileBytes = 20 * 1024;  // codes of one tile, when K allows
constexpr int64_t kPlaneMaxTileRows = 16;

// The tiling that K10 and K11 share, from V rows of K selected columns: the
// column chunk, the rows of a tile, the block's shared memory, the warps
// that share a row, and the grid.
struct OperandTiles {
  int64_t chunk, chunks, tile_rows, smem;
  int row_warps;
  dim3 grid;
};

OperandTiles operand_tiles(int64_t n_var, int64_t n_kept, bool with_ids) {
  OperandTiles t;
  // shared memory: a chunk's ids, then tile_rows rows of its codes and 8 B
  // of slack; the rows shrink as K grows, and a chunked tile is one row
  t.chunk = n_kept < kPlaneChunk ? n_kept : kPlaneChunk;
  t.chunks = (n_kept + t.chunk - 1) / t.chunk;
  const int64_t id_bytes = with_ids ? (4 * t.chunk + 15) / 16 * 16 : 0;
  t.tile_rows = t.chunks > 1 ? 1 : kPlaneTileBytes / t.chunk;
  if (t.tile_rows > kPlaneMaxTileRows) t.tile_rows = kPlaneMaxTileRows;
  if (t.tile_rows > n_var) t.tile_rows = n_var;
  t.smem = id_bytes + (t.tile_rows * t.chunk + 8 + 15) / 16 * 16;
  t.row_warps = 1;  // a power of two, so that it divides the block's warps
  while (2 * t.row_warps * t.tile_rows <= kThreads / 32) t.row_warps *= 2;
  // a block per tile up to kMaxBlocks: the ids a block re-reads (from L2)
  // are a thirtieth of what its tile writes; a chunked tile is one row, so
  // fewer blocks each take several
  const int64_t tiles = (n_var + t.tile_rows - 1) / t.tile_rows;
  int64_t blocks = kMaxBlocks / (t.chunks > 1 ? 4 * t.chunks : 1);
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  t.grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(t.chunks));
  return t;
}

// Copies ids [c0, c0 + kc) of sel into shared memory, each checked to lie in
// [0, n_samples): pgen_tpu cuts the codes to S before its take, so a pad
// slot is never a valid id.
__device__ __forceinline__ void stage_ids(const int32_t* __restrict__ sel, int32_t* ids, int c0,
                                          int kc, int n_samples) {
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    const int32_t s = sel[c0 + j];
    assert(s >= 0 && s < n_samples);
    ids[j] = s;
  }
}

// Decodes columns first, first + step, ... < kc of one row (sample ids[j],
// or c0 + j where ids is null) into out[j] = tag | code; returns their code
// counts as the 16-bit fields of count_code.
__device__ __forceinline__ uint64_t decode_row(const uint8_t* __restrict__ row,
                                               const int32_t* ids, int c0, int kc,
                                               uint8_t* out, uint32_t tag, int first,
                                               int step) {
  uint64_t acc = 0;
  for (int j = first; j < kc; j += step) {
    const int s = ids != nullptr ? ids[j] : c0 + j;
    const uint32_t code = (static_cast<uint32_t>(__ldg(row + (s >> 2))) >> (2 * (s & 3))) & 3u;
    out[j] = static_cast<uint8_t>(tag | code);
    acc = count_code(acc, code);
  }
  return acc;
}

// The warp's sums of the 16-bit fields of acc, for lane 0.
__device__ __forceinline__ void warp_code_counts(uint64_t acc, uint32_t c[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = static_cast<uint32_t>((acc >> (16 * k)) & 0xFFFFu);
    for (int off = 16; off > 0; off /= 2) c[k] += __shfl_down_sync(0xFFFFFFFFu, c[k], off);
  }
}

// Writes the n floats tab[tile[i]] to span (4-B aligned) with the block's
// threads: 16 B streaming stores from the span's first 16-B boundary, each
// taking its four tile bytes with two aligned word loads and a funnel shift;
// at most 3 floats before and 3 after go one by one. The tile holds a word
// of slack past its n bytes.
__device__ __forceinline__ void store_span(float* span, int n, const uint8_t* tile,
                                           const float* tab) {
  const int tid = threadIdx.x;
  // floats before the first 16-B boundary
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(span) & 15)) & 15) / 4;
  if (head > n) head = n;
  const int quads = (n - head) / 4;
  const int tail_at = head + 4 * quads;
  if (tid < head) span[tid] = tab[tile[tid]];
  if (tid < n - tail_at) span[tail_at + tid] = tab[tile[tail_at + tid]];
  const uint32_t* tile32 = reinterpret_cast<const uint32_t*>(tile);
  float4* out4 = reinterpret_cast<float4*>(span + head);
  for (int q = tid; q < quads; q += blockDim.x) {
    const int at = head + 4 * q;
    const uint32_t w = __funnelshift_r(tile32[at >> 2], tile32[(at >> 2) + 1], 8 * (at & 3));
    __stcs(out4 + q, make_float4(tab[w & 0xFFu], tab[(w >> 8) & 0xFFu], tab[(w >> 16) & 0xFFu],
                                 tab[w >> 24]));
  }
}

__global__ void glm_planes_kernel(const uint8_t* __restrict__ packed,
                                        const int32_t* __restrict__ sel,
                                        const float* __restrict__ lut,
                                        float* __restrict__ planes,
                                        int32_t* __restrict__ hist, int64_t n_var,
                                        int64_t rec, int n_samples, int n_kept,
                                        int n_planes, int tile_rows, int chunk,
                                        int row_warps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float table[kMaxPlanes * 4];
  // the chunk's ids (when given), then the tile's codes, row-major, and a
  // word of slack for the funnel shift's second load
  int32_t* ids = reinterpret_cast<int32_t*>(smem);
  uint8_t* tile = smem + (sel != nullptr ? (4 * chunk + 15) / 16 * 16 : 0);
  const int c0 = blockIdx.y * chunk;  // this block's columns [c0, c0 + kc)
  const int kc = n_kept - c0 < chunk ? n_kept - c0 : chunk;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  if (tid < 4 * n_planes) table[tid] = lut[tid];
  if (sel != nullptr) stage_ids(sel, ids, c0, kc, n_samples);
  __syncthreads();
  const int64_t plane = n_var * n_kept;
  const int64_t n_tiles = (n_var + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t v0 = t * tile_rows;
    const int rows = static_cast<int>(n_var - v0 < tile_rows ? n_var - v0 : tile_rows);
    // row_warps warps share a row where a tile has fewer rows than warps
    for (int r = warp / row_warps; r < rows; r += warps / row_warps) {
      const uint64_t acc = decode_row(packed + (v0 + r) * rec, sel != nullptr ? ids : nullptr, c0,
                                      kc, tile + r * kc, 0u, (warp % row_warps) * 32 + lane,
                                      32 * row_warps);
      uint32_t c[4];
      warp_code_counts(acc, c);
      if (lane == 0 && gridDim.y == 1 && row_warps == 1) {
        reinterpret_cast<int4*>(hist)[v0 + r] =
            make_int4(static_cast<int>(c[0]), static_cast<int>(c[1]), static_cast<int>(c[2]),
                      static_cast<int>(c[3]));
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) atomicAdd(hist + 4 * (v0 + r) + k, static_cast<int>(c[k]));
      }
    }
    __syncthreads();  // the tile's codes are complete
    for (int p = 0; p < n_planes; ++p) {
      store_span(planes + p * plane + v0 * n_kept + c0, rows * kc, tile, table + 4 * p);
    }
    __syncthreads();  // before the next tile's codes overwrite these
  }
}

// K11. Replaces the decode leg of pgen_tpu/ops/score.py:_score_device_jit
// (:133-158): the Pallas _unpack_kernel, the XLA take, the effect-allele
// flip and the mean imputation of missing calls, before the f32 product
// with the weights (torch.matmul in the caller).
// (V, R) u8 records + sel (K) int32 ids (or null: K = S) + flip (V) u8 ->
// db (V, K) f32 effect dosages and called (2V) int32, whose first V hold
// each row's called count n_called (every row is written; the second V are
// the chunked form's scratch). A called code c gives c, or 2 - c on a
// flipped row; a missing call gives 0, or with mean_impute, in a row with
// n_called > 0, the row's mean dosage (row sum) / n_called in f32. The row
// sum is the exact integer c1 + 2 c2 (2 c0 + c1 flipped) of the row's code
// counts, so the mean is bitwise the reference's
// jnp.sum(db) / jnp.maximum(n_called, 1).
// Bound: memory, 4 B written per selected sample against a quarter byte
// read: a 16,384-row block of 2504 samples writes 164 MB, 0.0521 ms at
// 3.35 TB/s. The fill needs the row's complete counts before its first
// store, so every form counts a row before it writes it. Three forms,
// chosen by the launcher (launch_dosage, shared with K13):
// - flat (no sel, S % 4 == 0, db 16-B aligned; every sample scored, 1000
//   Genomes' 2504): rows have no pad codes and every row starts on 16 B.
//   One warp per row counts its bytes by popcount (row_code_counts, as K8;
//   every lane gets the counts and so the row's table), then writes each
//   byte's four dosages as one 16 B
//   streaming store (the dosages pass the 50 MB L2 before the product reads
//   them), the bytes again from L1: no shared memory, no barrier.
// - tiled (any other K or alignment, K <= kPlaneChunk): K10's tiles
//   (operand_tiles, stage_ids, decode_row, store_span). Each tile byte is
//   (row << 2) | code, and a (tile_rows x 4) table in shared memory maps it
//   to c0 -> 0 or 2, c1 -> 1, c2 -> 2 or 0, c3 -> the row's fill, so the
//   store pass is K10's single-plane store. The warps add each row's counts
//   into shared memory; one barrier, then one thread per row makes its
//   table row and writes n_called; a second barrier, then the store.
// - chunked (K > kPlaneChunk: blockIdx.y takes a chunk of the ids, as K10):
//   a chunk's block cannot see the row's other columns, so a count pass
//   (dosage_counts_kernel) runs first on the same grid of (rows, chunks):
//   each block keeps its chunk's ids in shared memory, one warp a row
//   counts the chunk's codes (a quarter byte read per selected sample,
//   from L2 or L1, against the 4 B the store writes), and lane 0 adds them
//   into n_called and the row sum (cleared by the launcher). Counting the
//   whole row in every chunk's block instead would read every id once per
//   chunk; one warp per row over all K ids (its first form) left a
//   1,024-row block with too few warps in flight: 0.4 ms. The tiled kernel
//   then reads each row's table from the sums.
// The three kernels take the row's table from a policy (ScoreRows here,
// GrmRows for K13), and write the policy's per-row value (its Out) to
// row_out; the chunked form's sums are (kSums x V) ints at sums (n, then the
// row sum). K11 passes called for both: in the chunked form its row_out
// value is the n_called already there.
struct ScoreRows {
  using Out = int32_t;
  static constexpr int kSums = 2;  // the chunked form's sums: n, then the row sum
  // a called code's effect dosage, a missing call's fill; the called count
  __device__ static __forceinline__ int32_t table(uint32_t n, uint32_t sum, bool flipped,
                                                  int mean_impute, float (&t)[4]) {
    t[0] = flipped ? 2.0f : 0.0f;
    t[1] = 1.0f;
    t[2] = flipped ? 0.0f : 2.0f;
    t[3] = mean_impute && n > 0 ? static_cast<float>(sum) / static_cast<float>(n) : 0.0f;
    return static_cast<int32_t>(n);
  }
};

// K13. Replaces the decode and standardization legs of pgen_tpu/ops/pca.py's
// _grm_device_jit (:109) and _approx_pass_jit (:412): the Pallas
// _unpack_kernel, the XLA take of the cohort's columns and
// _standardize_block_jnp (:91), before the f32 products (torch.matmul in
// full fp32 in the caller, as pgen_tpu pins Precision.HIGHEST).
// (V, R) u8 records + sel (K) int32 ids (or null: K = S) -> z (V, K) f32
// and rows (3V) int32, whose first V hold each row's used flag (var > 0;
// the second and third V are the chunked form's scratch). Per row, over the
// selected samples: n = called count, ac = c1 + 2 c2 (exact integers, as
// the reference's f32 sums of 0/1/2 are below 2^24), p = ac / max(2n, 1)
// (0 when n = 0), var = 2p (1 - p), inv_sd = 1 / sqrt(var) where var > 0
// (else 0), then z = (g - 2p) inv_sd on a called entry and 0 on a missing
// one, each in f32 in _standardize_block_jnp's order. 1 / sqrt is correctly
// rounded here and in the plain version on either device; XLA's rsqrt on
// the CPU is 1 ulp off it in about a third of values.
// Bound: memory, K11's: 4 B written per selected sample against a quarter
// byte read: a 16,384-row block of 2504 samples writes 164 MB, 0.052 ms at
// 3.35 TB/s. Design: K11's three forms, whose per-row table of four floats
// turns each code into z once the row's counts are known.
struct GrmRows {
  using Out = int32_t;
  static constexpr int kSums = 2;
  // z of codes 0, 1, 2 and of a missing call; the used flag
  __device__ static __forceinline__ int32_t table(uint32_t n, uint32_t ac, bool, int,
                                                  float (&t)[4]) {
    const float nf = static_cast<float>(n);
    const float p = n > 0 ? static_cast<float>(ac) / fmaxf(2.0f * nf, 1.0f) : 0.0f;
    const float var = 2.0f * p * (1.0f - p);
    const bool used = var > 0.0f;
    const float inv_sd = used ? 1.0f / sqrtf(fmaxf(var, 1e-30f)) : 0.0f;
    const float two_p = 2.0f * p;
    t[0] = (0.0f - two_p) * inv_sd;
    t[1] = (1.0f - two_p) * inv_sd;
    t[2] = (2.0f - two_p) * inv_sd;
    t[3] = 0.0f;
    return used ? 1 : 0;
  }
};

// A row's sum for the policies: the effect-allele dosage sum (flipped: 2 c0
// + c1) for K11, the alt count for K13 (flip is null there).
__device__ __forceinline__ uint32_t row_sum(const uint32_t c[4], bool flipped) {
  return flipped ? 2 * c[0] + c[1] : c[1] + 2 * c[2];
}

template <class Rows>
__global__ void dosage_flat_kernel(const uint8_t* __restrict__ packed,
                                   const uint8_t* __restrict__ flip, float4* __restrict__ out,
                                   typename Rows::Out* __restrict__ row_out, int64_t n_var,
                                   int64_t rec, int64_t n_quads, int mean_impute) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  for (int64_t v = first_index() / kWarp; v < n_var; v += warps) {
    const uint8_t* row = packed + v * rec;
    const bool flipped = flip != nullptr && flip[v] != 0;
    const uint8_t* const rows[1] = {row};
    uint32_t counts[1][4];
    // every lane holds the counts
    row_code_counts<1>(rows, static_cast<int>(4 * n_quads), lane, counts);
    const uint32_t* c = counts[0];
    float t[4];
    const typename Rows::Out value =
        Rows::table(c[0] + c[1] + c[2], row_sum(c, flipped), flipped, mean_impute, t);
    if (lane == 0) row_out[v] = value;
    auto dose = [&](uint32_t code) {
      return code == 0u ? t[0] : (code == 1u ? t[1] : (code == 2u ? t[2] : t[3]));
    };
    float4* dst = out + v * n_quads;
    for (int64_t j = lane; j < n_quads; j += kWarp) {
      const uint32_t b = __ldg(row + j);
      __stcs(dst + j, make_float4(dose(b & 3u), dose((b >> 2) & 3u), dose((b >> 4) & 3u),
                                  dose(b >> 6)));
    }
  }
}

__global__ void dosage_counts_kernel(const uint8_t* __restrict__ packed,
                                     const int32_t* __restrict__ sel,
                                     const uint8_t* __restrict__ flip,
                                     int32_t* __restrict__ sums, int64_t n_var, int64_t rec,
                                     int n_samples, int n_kept, int chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* ids = reinterpret_cast<int32_t*>(smem);
  const int c0 = blockIdx.y * chunk;  // this block's columns [c0, c0 + kc)
  const int kc = n_kept - c0 < chunk ? n_kept - c0 : chunk;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  if (sel != nullptr) stage_ids(sel, ids, c0, kc, n_samples);
  __syncthreads();
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * warps + warp; v < n_var;
       v += static_cast<int64_t>(gridDim.x) * warps) {
    const uint8_t* row = packed + v * rec;
    uint32_t c[4];
    if (sel == nullptr) {  // chunk is a multiple of 4: whole bytes
      const uint8_t* const rows[1] = {row + c0 / 4};
      uint32_t counts[1][4];
      row_code_counts<1>(rows, kc, lane, counts);
      for (int k = 0; k < 4; ++k) c[k] = counts[0][k];
    } else {
      uint64_t acc = 0;
      for (int j = lane; j < kc; j += kWarp) {
        const int s = ids[j];
        acc = count_code(acc, (static_cast<uint32_t>(__ldg(row + (s >> 2))) >> (2 * (s & 3))) & 3u);
      }
      warp_code_counts(acc, c);
    }
    if (lane == 0) {
      atomicAdd(sums + v, static_cast<int>(c[0] + c[1] + c[2]));
      atomicAdd(sums + n_var + v,
                static_cast<int>(row_sum(c, flip != nullptr && flip[v] != 0)));
    }
  }
}

template <class Rows>
__global__ void dosage_kernel(const uint8_t* __restrict__ packed,
                              const int32_t* __restrict__ sel,
                              const uint8_t* __restrict__ flip, float* __restrict__ out,
                              typename Rows::Out* row_out, const int32_t* sums, int64_t n_var,
                              int64_t rec, int n_samples, int n_kept, int mean_impute,
                              int tile_rows, int chunk, int row_warps) {
  extern __shared__ __align__(16) uint8_t smem[];
  // per tile row: its value of each code, and the counts its warps add
  __shared__ float table[4 * kPlaneMaxTileRows];
  __shared__ uint32_t counts[4 * kPlaneMaxTileRows];
  int32_t* ids = reinterpret_cast<int32_t*>(smem);
  uint8_t* tile = smem + (sel != nullptr ? (4 * chunk + 15) / 16 * 16 : 0);
  const int c0 = blockIdx.y * chunk;  // this block's columns [c0, c0 + kc)
  const int kc = n_kept - c0 < chunk ? n_kept - c0 : chunk;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const bool chunked = gridDim.y > 1;  // the counts come from dosage_counts_kernel
  if (tid < 4 * kPlaneMaxTileRows) counts[tid] = 0;
  if (sel != nullptr) stage_ids(sel, ids, c0, kc, n_samples);
  __syncthreads();
  const int64_t n_tiles = (n_var + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t v0 = t * tile_rows;
    const int rows = static_cast<int>(n_var - v0 < tile_rows ? n_var - v0 : tile_rows);
    for (int r = warp / row_warps; r < rows; r += warps / row_warps) {
      const uint64_t acc = decode_row(packed + (v0 + r) * rec, sel != nullptr ? ids : nullptr, c0,
                                      kc, tile + r * kc, static_cast<uint32_t>(r) << 2,
                                      (warp % row_warps) * 32 + lane, 32 * row_warps);
      if (!chunked) {
        uint32_t c[4];
        warp_code_counts(acc, c);
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) atomicAdd(counts + 4 * r + k, c[k]);
        }
      }
    }
    __syncthreads();  // the tile's codes and its rows' counts are complete
    if (tid < rows) {
      const int64_t v = v0 + tid;
      const bool flipped = flip != nullptr && flip[v] != 0;
      uint32_t n, sum;
      if (chunked) {
        n = static_cast<uint32_t>(sums[v]);
        sum = static_cast<uint32_t>(sums[n_var + v]);
      } else {
        uint32_t* c = counts + 4 * tid;
        n = c[0] + c[1] + c[2];
        sum = row_sum(c, flipped);
        c[0] = c[1] = c[2] = c[3] = 0;  // for the next tile, after two barriers
      }
      float tab[4];
      const typename Rows::Out value = Rows::table(n, sum, flipped, mean_impute, tab);
      if (!chunked || blockIdx.y == 0) row_out[v] = value;
#pragma unroll
      for (int k = 0; k < 4; ++k) table[4 * tid + k] = tab[k];
    }
    __syncthreads();  // the rows' tables are complete
    store_span(out + v0 * n_kept + c0, rows * kc, tile, table);
    __syncthreads();  // before the next tile's codes overwrite these
  }
}

// K15. Replaces pgen_tpu/ops/ld.py's banded_r2_device (:106): its
// _tiles (:128-150: the Pallas _unpack_kernel, the XLA take of the cohort,
// the f32 mean-imputed centered dosages c, their norms and the HIGHEST
// einsum of each band tile against its window) and the f64 r² of :151-160.
// Its first form wrote c, 16 times the records' bytes, for
// torch.bmm tile Grams; this one counts each pair's products from the codes.
// (n_rows, R) u8 records of S samples (a cohort is re-packed by K5 first)
// -> out (n_out, band) f64, out[i][d] = r²(i, i + 1 + d); a row at or past
// n_rows is all missing (r² 0). Per row, over its S samples: n called, ac =
// c1 + 2 c2, the mean m = ac / max(n, 1) in f32 and ||c||² = sum_k c_k t_k²
// in f64 with t_k = k - m in f32 (its first form's table and norm). Per pair, with
// three bit planes of a row, U1 (code 1 or 2), U2 (code 2) and V (called),
// so that the dosage x = U1 + U2 (0 on a missing call):
//   S_xx = sum x_i x_j = U1U1 + U1U2 + U2U1 + U2U2 (each an AND-POPC count),
//   S_xi = sum of x_i over j's called samples = U1V + U2V, S_xj = VU1 + VU2,
//   N = VV, dot = S_xx - m_j S_xi - m_i S_xj + m_i m_j N,
//   r² = dot² / (||c_i||² ||c_j||²), 0 where that product is 0;
// the counts are exact integers (under 2^31 at 40,003 samples), and every
// f64 product, sum and quotient is rounded on its own in this order, as
// ld_r2_band_plain's tensor operations round them: the two agree bit for bit
// (no square root: torch's f64 sqrt on the CPU is not correctly rounded).
// Bound: a block of 16,384 rows of 2504 samples reads 10.3 MB of records
// and writes 1.2 MB of r² at band 9 (6.4 MB at 49): 0.0034 (0.0050) ms at
// 3.35 TB/s; its 9 x 2 x 2504 binary operations a pair, 6.6 G at band 9 (36
// G at 49), take 0.0034 (0.018) ms at the int8 tensor rate of 1,979 TOPS.
// Design: a block takes an item, 64 output rows (a warp each 16) by a tile
// of DT = 8 NT - 15 offsets d (NT the n-tiles of 8 columns a warp takes, 2
// to 8: DT up to 49, the whole band below 50), and stages the rows the item
// reads, the 64 rows then their window of 48 + 8 NT rows (one run when the
// two overlap), in chunks of kLdChunk record bytes: cp.async copies of the
// aligned 16-B words that hold each row's chunk into a raw slot, the next
// chunk's copies in flight while this one is counted. The raw bytes become
// the three planes in shared memory (two record words a plane word of 32
// samples; bytes past the row's end read 0xFF and its last byte's pad
// slots 3, so neither counts), each row's n, popc(U1) and popc(U2) summed
// over the chunks as they pass. A warp then takes its 16 rows against the
// 8 NT columns of its window with mma.sync m16n8k256 .b1 AND-POPC (K14's),
// nine products a k-step and n-tile into four sums. The epilogue works out
// each staged row's m and squared norm, and each lane the r² of its
// fragment's pairs that fall in the item's tile.
constexpr int kLdRows = 64;                 // output rows of an item
constexpr int kLdWarps = kLdRows / 16;
constexpr int kLdThreads = kLdWarps * kWarp;
constexpr int kLdChunk = 128;               // record bytes of a row staged at a time: two k-steps
constexpr int kLdWords = kLdChunk / 8;      // plane words (32 samples) of a row's chunk
constexpr int kLdPitch = 3 * kLdWords + 4;  // u32 of a row's planes: 4 (mod 8), so 8 rows x 4 words
                                            // of a fragment load hit 32 banks
constexpr int kLdSlot = kLdChunk + 32;      // raw bytes of a row's slot: lead, chunk, funnel slack
constexpr int kLdPieces = kLdChunk / 16 + 1;  // aligned 16-B words that hold a chunk
constexpr int kLdMaxNt = 8;

__host__ __device__ constexpr int ld_staged_rows(int nt) { return kLdRows + 48 + 8 * nt; }
__host__ __device__ constexpr int ld_band_tile(int nt) { return 8 * nt - 15; }

// Shared memory of a block: two raw buffers, the planes, the rows' counts,
// then their means and norms.
__host__ __device__ constexpr int ld_smem_bytes(int nt) {
  return ld_staged_rows(nt) * (2 * kLdSlot + 4 * kLdPitch + 3 * 4 + 4 + 8);
}

struct LdArgs {
  const uint8_t* packed;
  double* out;
  int64_t n_rows, n_out, rec;
  int used;  // record bytes that hold a sample: ceil(S / 4)
  int band;
  int n_dtiles, n_items, n_chunks;
  uint32_t last_pad;  // the pad slots' bits of byte used - 1 (both bits of each)
};

// The bits OR-ed into the record word at row byte b: 0xFF for each byte at
// or past the used ones, the pad slots' bits in the last used byte.
__device__ __forceinline__ uint32_t ld_fill(int64_t b, const LdArgs& a) {
  if (b + 4 < a.used) return 0u;
  uint32_t f = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t at = b + k;
    f |= (at >= a.used ? 0xFFu : (at == a.used - 1 ? a.last_pad : 0u)) << (8 * k);
  }
  return f;
}

// Two record words (32 slots) -> one word of each plane: the even bits from
// r0, the odd ones from r1.
__device__ __forceinline__ void ld_planes(uint32_t r0, uint32_t r1, uint32_t& u1, uint32_t& u2,
                                          uint32_t& v) {
  const uint32_t lo0 = r0 & 0x55555555u, hi0 = (r0 >> 1) & 0x55555555u;
  const uint32_t lo1 = r1 & 0x55555555u, hi1 = (r1 >> 1) & 0x55555555u;
  u1 = (lo0 ^ hi0) | ((lo1 ^ hi1) << 1);
  u2 = (hi0 & ~lo0) | ((hi1 & ~lo1) << 1);
  v = ((lo0 & hi0) ^ 0x55555555u) | (((lo1 & hi1) ^ 0x55555555u) << 1);
}

// A row's mean and squared norm from its called count n, alt count ac and
// count of code 2: the first form's table and f64 norm.
__device__ __forceinline__ void ld_row_stats(uint32_t n, uint32_t ac, uint32_t c2, float& m,
                                             double& norm2) {
  m = __fdiv_rn(static_cast<float>(ac), fmaxf(static_cast<float>(n), 1.0f));
  const float t[3] = {0.0f - m, 1.0f - m, 2.0f - m};
  const uint32_t c1 = ac - 2 * c2;
  const uint32_t counts[3] = {n - c1 - c2, c1, c2};
  norm2 = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double tk = static_cast<double>(t[k]);
    norm2 = __dadd_rn(norm2, __dmul_rn(static_cast<double>(counts[k]), __dmul_rn(tk, tk)));
  }
}

__device__ __forceinline__ double ld_r2(int sxx, int sxi, int sxj, int nn, float mi_f, float mj_f,
                                        double n2i, double n2j) {
  const double den = __dmul_rn(n2i, n2j);
  if (!(den > 0.0)) return 0.0;
  const double mi = mi_f, mj = mj_f;
  double dot = __dsub_rn(static_cast<double>(sxx), __dmul_rn(mj, static_cast<double>(sxi)));
  dot = __dsub_rn(dot, __dmul_rn(mi, static_cast<double>(sxj)));
  dot = __dadd_rn(dot, __dmul_rn(__dmul_rn(mi, mj), static_cast<double>(nn)));
  return __ddiv_rn(__dmul_rn(dot, dot), den);
}

template <int kNt>
__global__ void __launch_bounds__(kLdThreads) ld_r2_band_kernel(LdArgs a) {
  constexpr int kStaged = ld_staged_rows(kNt);
  constexpr int kDt = ld_band_tile(kNt);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;  // [2][kStaged][kLdSlot]
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + 2 * kStaged * kLdSlot);
  int* stats = reinterpret_cast<int*>(planes + kStaged * kLdPitch);  // [kStaged][3]
  float* mean = reinterpret_cast<float*>(stats + 3 * kStaged);
  double* norm2 = reinterpret_cast<double*>(mean + kStaged);  // kStaged is a multiple of 8
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane / 4, t = lane % 4;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    const int64_t i0 = static_cast<int64_t>(item / a.n_dtiles) * kLdRows;
    const int d0 = (item % a.n_dtiles) * kDt;
    // rows [i0, i0 + 64), then the window's from i0 + 1 + d0 at staged row
    // joff: one run up to d0 = 63, two runs gap rows apart past it
    const int gap = d0 + 1 > kLdRows ? d0 + 1 - kLdRows : 0;
    const int joff = 1 + d0 - gap;
    const int n_staged = joff + 48 + 8 * kNt;
    auto row_of = [&](int k) { return i0 + k + (k >= kLdRows ? gap : 0); };
    for (int k = tid; k < 3 * n_staged; k += kLdThreads) stats[k] = 0;
    auto stage = [&](int c) {
      uint8_t* buf = raw + (c & 1) * kStaged * kLdSlot;
      const int64_t off = static_cast<int64_t>(c) * kLdChunk;
      const int len = static_cast<int>(a.used - off < kLdChunk ? a.used - off : kLdChunk);
      for (int p = tid; p < n_staged * kLdPieces; p += kLdThreads) {
        const int k = p / kLdPieces, piece = p % kLdPieces;
        const int64_t v = row_of(k);
        if (v >= a.n_rows) continue;
        const uint8_t* src = a.packed + v * a.rec + off;
        const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
        if (piece < (lead + len + 15) / 16) {
          cp_async_16(buf + k * kLdSlot + 16 * piece, src - lead + 16 * piece);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    int acc[4][kNt][4];  // S_xx, S_xi, S_xj and N of each n-tile's fragment
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        acc[q][nt][0] = acc[q][nt][1] = acc[q][nt][2] = acc[q][nt][3] = 0;
      }
    stage(0);
    for (int c = 0; c < a.n_chunks; ++c) {
      if (c + 1 < a.n_chunks) {
        stage(c + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();  // chunk c has landed, and the planes of chunk c - 1 are read
      // the planes: half a warp a row, a lane a plane word
      const uint8_t* buf = raw + (c & 1) * kStaged * kLdSlot;
      const int64_t off = static_cast<int64_t>(c) * kLdChunk;
      const int w = lane % 16;
      for (int k0 = 2 * warp; k0 < n_staged; k0 += 2 * kLdWarps) {
        const int k = k0 + lane / 16;
        const int64_t v = row_of(k);
        uint32_t r0 = ~0u, r1 = ~0u;
        if (k < n_staged && v < a.n_rows) {
          const uint8_t* src = a.packed + v * a.rec + off;
          const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
          const uint32_t* slot = reinterpret_cast<const uint32_t*>(buf + k * kLdSlot);
          const int at = (lead >> 2) + 2 * w;
          const uint32_t x0 = slot[at], x1 = slot[at + 1], x2 = slot[at + 2];
          r0 = __funnelshift_r(x0, x1, 8 * (lead & 3)) | ld_fill(off + 8 * w, a);
          r1 = __funnelshift_r(x1, x2, 8 * (lead & 3)) | ld_fill(off + 8 * w + 4, a);
        }
        uint32_t u1, u2, vv;
        ld_planes(r0, r1, u1, u2, vv);
        int cn = __popc(vv), c1 = __popc(u1), c2 = __popc(u2);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          cn += __shfl_xor_sync(0xFFFFFFFFu, cn, o);
          c1 += __shfl_xor_sync(0xFFFFFFFFu, c1, o);
          c2 += __shfl_xor_sync(0xFFFFFFFFu, c2, o);
        }
        if (k < n_staged) {
          uint32_t* pl = planes + k * kLdPitch;
          pl[w] = u1;
          pl[kLdWords + w] = u2;
          pl[2 * kLdWords + w] = vv;
          if (w == 0) {
            stats[3 * k] += cn;
            stats[3 * k + 1] += c1;
            stats[3 * k + 2] += c2;
          }
        }
      }
      __syncthreads();  // the chunk's planes are complete
      const uint32_t* pa0 = planes + (16 * warp + g) * kLdPitch;
      const uint32_t* pa1 = pa0 + 8 * kLdPitch;
#pragma unroll
      for (int ks = 0; ks < kLdChunk / 64; ++ks) {
        const int wo = 8 * ks + t;
        const uint32_t au1[4] = {pa0[wo], pa1[wo], pa0[wo + 4], pa1[wo + 4]};
        const uint32_t au2[4] = {pa0[kLdWords + wo], pa1[kLdWords + wo], pa0[kLdWords + wo + 4],
                                 pa1[kLdWords + wo + 4]};
        const uint32_t av[4] = {pa0[2 * kLdWords + wo], pa1[2 * kLdWords + wo],
                                pa0[2 * kLdWords + wo + 4], pa1[2 * kLdWords + wo + 4]};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const uint32_t* pb = planes + (joff + 16 * warp + 8 * nt + g) * kLdPitch + wo;
          const uint32_t b10 = pb[0], b11 = pb[4];
          const uint32_t b20 = pb[kLdWords], b21 = pb[kLdWords + 4];
          const uint32_t bv0 = pb[2 * kLdWords], bv1 = pb[2 * kLdWords + 4];
          mma_and_popc(acc[0][nt], au1, b10, b11);
          mma_and_popc(acc[0][nt], au1, b20, b21);
          mma_and_popc(acc[0][nt], au2, b10, b11);
          mma_and_popc(acc[0][nt], au2, b20, b21);
          mma_and_popc(acc[1][nt], au1, bv0, bv1);
          mma_and_popc(acc[1][nt], au2, bv0, bv1);
          mma_and_popc(acc[2][nt], av, b10, b11);
          mma_and_popc(acc[2][nt], av, b20, b21);
          mma_and_popc(acc[3][nt], av, bv0, bv1);
        }
      }
    }
    __syncthreads();  // every row's counts are complete
    for (int k = tid; k < n_staged; k += kLdThreads) {
      const uint32_t n = stats[3 * k], u1 = stats[3 * k + 1], u2 = stats[3 * k + 2];
      ld_row_stats(n, u1 + u2, u2, mean[k], norm2[k]);
    }
    __syncthreads();
    // fragment entry e: row g + 8 (e / 2) of the warp's 16, column 2 t + e % 2
    // of n-tile nt, so d - d0 = 8 nt + 2 t + e % 2 - row
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 8 * nt + 2 * t + (e & 1);
        const int dd = col - r, d = d0 + dd;
        const int64_t i = i0 + 16 * warp + r;
        if (dd < 0 || dd >= kDt || d >= a.band || i >= a.n_out) continue;
        const int ki = 16 * warp + r, kj = joff + 16 * warp + col;
        a.out[i * a.band + d] = ld_r2(acc[0][nt][e], acc[1][nt][e], acc[2][nt][e], acc[3][nt][e],
                                      mean[ki], mean[kj], norm2[ki], norm2[kj]);
      }
    }
    __syncthreads();  // before the next item's counts and copies
  }
}

// K13's --approx pass. Replaces the body of pgen_tpu/ops/pca.py's
// _approx_pass_jit (:412-445): the Pallas _unpack_kernel, the XLA take,
// _standardize_block_jnp (:91) and the two HIGHEST products z_b^T (z_b q),
// where the port first wrote z (16 times the records' bytes) for two fp32
// torch.matmul products that each read it back.
// (V, R) u8 records of S samples (a cohort is re-packed by K5 first), q (S,
// L) f32, y (S, L) f32, used (an int64) -> y += Z^T (Z q), used += the rows
// with var > 0; Z is K13's z (GrmRows' table, the same bits as grm_z).
// Columns go in chunks of up to kPcaMaxCols, three kernels a chunk:
// - pca_zq_kernel (t = Z q): a warp takes kPcaRows rows, works out their
//   tables from row_code_counts (K8's), and its lanes take every 32nd
//   sample, two samples an iteration, z of each row from the row's byte
//   (through L1) and q's row from shared memory (all of q's columns staged
//   once a block where they fit, else in sample chunks for each group of
//   rows): kPcaRows x C fp32 FMAs a sample. The lanes' sums go through a
//   fixed butterfly, so every lane holds the same sums, and lane c writes
//   column c. It writes each row's table for the second kernel.
// - pca_zty_kernel (Z^T t by chunks of rows): a block takes a slice of 128
//   record bytes (512 samples, a thread a byte) by a chunk of kPcaRowChunk
//   rows, whose tables and t it stages in shared memory first; a thread
//   adds z x t over the chunk's rows for its four samples (the record
//   bytes of four rows loaded together, each row's table and t read by
//   every thread at once), then writes its partial sums.
// - pca_sum_kernel: a thread an entry of y at a time (grid-stride) adds the
//   chunks' partial sums to it in chunk order. No float atomics: a pass
//   repeats bit for bit.
// (A first form had the last block of each slice add the slice's partials:
// 2,560 dependent loads a thread, 0.42 of the pass's 0.62 ms. pca_zty_kernel
// reading t and the tables from L2 a row at a time took 0.135 ms, staged
// 0.120 ms; pca_zq_kernel with four rows a warp and 12 warps a block, so
// that each of q's loads serves twice the FMAs, took 0.179 ms against 0.120
// with two rows and 16 warps.)
// Bound: operations, 4 S L FLOP a row: 2.95 GFLOP at 16,384 rows x 2504
// samples and L = 18, 0.044 ms at 67 TFLOPS fp32 (its 10.3 MB of records
// take 0.003 ms at 3.35 TB/s). fp32 FMA on the CUDA cores throughout, as
// pgen_tpu pins Precision.HIGHEST (no TF32).
constexpr int kPcaRows = 2;               // rows a warp of pca_zq_kernel
constexpr int kPcaWarps = 16;             // one block an SM: q takes its shared memory
constexpr int kPcaThreads = kPcaWarps * kWarp;
constexpr int kPcaMaxCols = 24;           // q's columns a pair of launches
constexpr int kPcaQBytes = 200 * 1024;    // shared memory of q's staged rows
constexpr int kPcaSliceThreads = 128;     // record bytes of a slice: 512 samples
constexpr int kPcaRowChunk = 256;         // rows of a pca_zty_kernel block

// q's row pitch in shared memory: a multiple of 4 floats with an odd count
// of 16-B pieces, so 8 lanes' float4 loads of consecutive rows hit 8 bank
// groups.
__host__ __device__ constexpr int pca_pitch(int cols) { return 4 * ((cols / 4) | 1); }

struct PcaArgs {
  const uint8_t* packed;
  const float* q;
  float* y;
  unsigned long long* used;
  float4* table;  // (V) z of codes 0, 1, 2 and 0
  float* zq;      // (V, kCols) t
  float* parts;   // (chunks, slices x 512, kCols) partial sums
  int64_t n_var, rec;
  int n_samples, n_cols, col0, pitch;  // pitch: the columns of q and y (L)
  int q_rows;                          // q's rows staged at once
  int count_used;
  int n_chunks, n_slices;
};

__device__ __forceinline__ float pca_z(const float (&tab)[4], uint32_t code) {
  return code == 0u ? tab[0] : (code == 1u ? tab[1] : (code == 2u ? tab[2] : 0.0f));
}

template <int kCols>
__global__ void __launch_bounds__(kPcaThreads, 1) pca_zq_kernel(PcaArgs a) {
  constexpr int kPitch = pca_pitch(kCols);
  extern __shared__ __align__(16) float qs[];  // [q_rows][kPitch]
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_qchunks = (a.n_samples + a.q_rows - 1) / a.q_rows;
  auto stage_q = [&](int qc) {
    const int s0 = qc * a.q_rows;
    const int rows = a.n_samples - s0 < a.q_rows ? a.n_samples - s0 : a.q_rows;
    for (int i = tid; i < rows * kPitch; i += kPcaThreads) {
      const int s = i / kPitch, c = i % kPitch;
      qs[i] = c < a.n_cols ? a.q[static_cast<int64_t>(s0 + s) * a.pitch + a.col0 + c] : 0.0f;
    }
  };
  if (n_qchunks == 1) {
    stage_q(0);
    __syncthreads();
  }
  constexpr int kBlockRows = kPcaWarps * kPcaRows;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockRows; base < a.n_var;
       base += static_cast<int64_t>(gridDim.x) * kBlockRows) {
    const int64_t v0 = base + warp * kPcaRows;
    const uint8_t* rows[kPcaRows];
#pragma unroll
    for (int r = 0; r < kPcaRows; ++r) {
      rows[r] = v0 + r < a.n_var ? a.packed + (v0 + r) * a.rec : nullptr;
    }
    uint32_t cnt[kPcaRows][4];
    row_code_counts<kPcaRows>(rows, a.n_samples, lane, cnt);
    float tab[kPcaRows][4];
    int used = 0;
#pragma unroll
    for (int r = 0; r < kPcaRows; ++r) {
      const int u = GrmRows::table(cnt[r][0] + cnt[r][1] + cnt[r][2], cnt[r][1] + 2 * cnt[r][2],
                                   false, 0, tab[r]);
      if (rows[r] != nullptr) {
        used += u;
        if (lane == r) a.table[v0 + r] = make_float4(tab[r][0], tab[r][1], tab[r][2], tab[r][3]);
      }
    }
    if (a.count_used && lane == 0 && used > 0) {
      atomicAdd(a.used, static_cast<unsigned long long>(used));
    }
    float acc[kPcaRows][kCols];
#pragma unroll
    for (int r = 0; r < kPcaRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    for (int qc = 0; qc < n_qchunks; ++qc) {
      if (n_qchunks > 1) {
        __syncthreads();  // every warp is done with the last chunk
        stage_q(qc);
        __syncthreads();
      }
      const int s0 = qc * a.q_rows;
      const int s1 = a.n_samples - s0 < a.q_rows ? a.n_samples : s0 + a.q_rows;
      // samples s and s + 32 an iteration, their loads issued together; a
      // sample past s1 reads q's staged row 0 and adds z 0
      for (int s = s0 + lane; s < s1; s += 2 * kWarp) {
        float z[2][kPcaRows];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = s + h * kWarp;
          const int byte = (at < s1 ? at : s) >> 2, shift = 2 * ((at < s1 ? at : s) & 3);
#pragma unroll
          for (int r = 0; r < kPcaRows; ++r) {
            const uint32_t code =
                rows[r] == nullptr ? 3u : (static_cast<uint32_t>(__ldg(rows[r] + byte)) >> shift) & 3u;
            z[h][r] = at < s1 ? pca_z(tab[r], code) : 0.0f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = s + h * kWarp;
          const float4* qrow = reinterpret_cast<const float4*>(qs + (at < s1 ? at - s0 : 0) * kPitch);
#pragma unroll
          for (int c4 = 0; c4 < kCols / 4; ++c4) {
            const float4 x = qrow[c4];
#pragma unroll
            for (int r = 0; r < kPcaRows; ++r) {
              acc[r][4 * c4] = fmaf(z[h][r], x.x, acc[r][4 * c4]);
              acc[r][4 * c4 + 1] = fmaf(z[h][r], x.y, acc[r][4 * c4 + 1]);
              acc[r][4 * c4 + 2] = fmaf(z[h][r], x.z, acc[r][4 * c4 + 2]);
              acc[r][4 * c4 + 3] = fmaf(z[h][r], x.w, acc[r][4 * c4 + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPcaRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float x = acc[r][c];
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
        if (lane == c && rows[r] != nullptr) a.zq[(v0 + r) * kCols + c] = x;
      }
    }
  }
}

template <int kCols>
__global__ void __launch_bounds__(kPcaSliceThreads) pca_zty_kernel(PcaArgs a) {
  // each row of the chunk: its table, then its t
  constexpr int kRowF4 = kCols / 4 + 1;
  __shared__ float4 staged[kPcaRowChunk * kRowF4];
  const int slice = static_cast<int>(blockIdx.x) % a.n_slices;
  const int chunk = static_cast<int>(blockIdx.x) / a.n_slices;
  const int64_t j = static_cast<int64_t>(slice) * kPcaSliceThreads + threadIdx.x;  // record byte
  const int64_t used_bytes = (a.n_samples + 3) / 4;
  const int64_t v_lo = static_cast<int64_t>(chunk) * kPcaRowChunk;
  const int rows = static_cast<int>(a.n_var - v_lo < kPcaRowChunk ? a.n_var - v_lo : kPcaRowChunk);
  for (int i = threadIdx.x; i < rows * kRowF4; i += kPcaSliceThreads) {
    const int r = i / kRowF4, f = i % kRowF4;
    staged[i] = f == 0 ? __ldg(a.table + v_lo + r)
                       : __ldg(reinterpret_cast<const float4*>(a.zq + (v_lo + r) * kCols) + f - 1);
  }
  __syncthreads();
  float acc[4][kCols];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[k][c] = 0.0f;
  // adds row r's terms for the byte b of this thread's four samples
  auto add_row = [&](int r, uint32_t b) {
    const float4* row = staged + r * kRowF4;
    const float4 t4 = row[0];
    const float tab[4] = {t4.x, t4.y, t4.z, t4.w};
    float z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) z[k] = pca_z(tab, (b >> (2 * k)) & 3u);
#pragma unroll
    for (int c4 = 0; c4 < kCols / 4; ++c4) {
      const float4 x = row[1 + c4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k][4 * c4] = fmaf(z[k], x.x, acc[k][4 * c4]);
        acc[k][4 * c4 + 1] = fmaf(z[k], x.y, acc[k][4 * c4 + 1]);
        acc[k][4 * c4 + 2] = fmaf(z[k], x.z, acc[k][4 * c4 + 2]);
        acc[k][4 * c4 + 3] = fmaf(z[k], x.w, acc[k][4 * c4 + 3]);
      }
    }
  };
  if (j < used_bytes) {
    const uint8_t* col = a.packed + v_lo * a.rec + j;
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
      uint32_t b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) b[u] = __ldg(col + (r + u) * a.rec);
#pragma unroll
      for (int u = 0; u < 4; ++u) add_row(r + u, b[u]);
    }
    for (; r < rows; ++r) add_row(r, __ldg(col + r * a.rec));
  }
  const int64_t slice_samples = static_cast<int64_t>(a.n_slices) * 4 * kPcaSliceThreads;
  float4* mine = reinterpret_cast<float4*>(a.parts + (chunk * slice_samples + 4 * j) * kCols);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < kCols / 4; ++c) {
      mine[k * (kCols / 4) + c] =
          make_float4(acc[k][4 * c], acc[k][4 * c + 1], acc[k][4 * c + 2], acc[k][4 * c + 3]);
    }
}

// A grid-stride loop: grid_for caps the grid at kMaxBlocks blocks, 2,097,152
// threads, fewer than y's S L entries past 116,508 samples at L = 18.
template <int kCols>
__global__ void __launch_bounds__(kThreads) pca_sum_kernel(PcaArgs a) {
  const int64_t n = static_cast<int64_t>(a.n_samples) * a.n_cols;
  const int64_t slice_samples = static_cast<int64_t>(a.n_slices) * 4 * kPcaSliceThreads;
  for (int64_t at = first_index(); at < n; at += grid_stride()) {
    const int64_t s = at / a.n_cols;
    const int c = static_cast<int>(at % a.n_cols);
    float* y = a.y + s * a.pitch + a.col0 + c;
    float sum = *y;
    for (int ch = 0; ch < a.n_chunks; ++ch) sum += a.parts[(ch * slice_samples + s) * kCols + c];
    *y = sum;
  }
}

// K12. Replaces the decode, plane and product legs of pgen_tpu/ops/king.py's
// _king_counts_device_jit (:148) and _king_counts_device_sel_jit (:182),
// body _device_block_grams (:134), and of ops/ibd.py's
// _ibd_counts_device_jit (:156) and _ibd_counts_device_sel_jit (:185),
// body _block_grams (:142): the Pallas _unpack_kernel, the XLA take of the
// cohort's columns, the bf16 0/1 indicator planes H (code 1), R (code 0),
// A (code 2) and C (code != 3) and their Grams by jnp.matmul. Its first
// form wrote those planes as int8, 16 times the records' bytes, for
// torch._int_mm to read back; this one counts each Gram entry with AND-POPC
// over bit planes as big as the records. Two kernels (a cohort's records
// are re-packed by K5 first, so both see S samples in order):
//
// relatedness_bits_kernel: (V, R) u8 records of S samples -> the block's
// bit planes lo and hi of each code (code = lo + 2 hi), u32 words in the
// order the Gram kernel's mma.sync fragments read them: (2, G, steps, 128),
// G = S_pad / 16 groups of 16 samples (S_pad a multiple of kRelPad), steps
// = ceil(V / 256) k-steps of 256 variants. Entry [p][grp][k][4 lane + e],
// lane = 4 g + t, holds plane p's word (32 variants, variant 256 k + 32 w +
// b at bit b) of sample 16 grp + g + 8 (e & 1), word w = t + 4 (e >> 1): one
// 16-B load a lane is the A fragment of the group's 16 samples, and the B
// fragments of its two eights. A slot that is no call reads code 3, in no
// plane: every sample at or past S (a row's pad slots, K5's zero pad bits,
// the pad samples up to S_pad), by count, never by its bits, and every row
// at or past V. Bound: memory, the records read and 2 bits a sample and
// variant written: 20.5 + 21.0 MB at 32,768 rows of 2504 samples, 0.0124
// ms at 3.35 TB/s. Design: a warp takes one group (a record word, 16
// samples) over one k-step; each lane loads its record word of eight rows
// (two aligned loads and a funnel shift, record_word; the block's eight
// warps read 32 consecutive bytes of each row, through L1, and the blocks
// of a k-step run side by side); each word of 32 rows is a 32 x 32 bit
// matrix, transposed by five shuffles (transpose32), after which lane 2 r +
// p holds plane p of sample r; four shuffles hand lane (g, t) its words,
// written as one 16-B store a plane, a warp's 512 B contiguous.
//
// relatedness_gram_kernel: the bit planes of a block -> for each Gram of
// the set (king: H^T H, R^T A, H^T C, C^T C; genome: H^T H, R^T A, R^T R,
// A^T A, C^T C), gram += X^T Y over the block's variants, int32 (n_grams,
// S_pad, S_pad), in place, exact (the callers keep a scan below 2^24
// rows); a symmetric Gram on and above its diagonal only (the wrapper
// mirrors it once a scan). Bound: operations, at the 10.08 P/s of .b1
// mma.sync that chip_diag.py --rates measured: a Gram of 2504 samples over
// 32,768 rows is 4.11e11 (2 M N K) operations, 0.0408 ms; the symmetric
// ones need only their triangle, so king's four and genome's five are three
// Grams' work each, 0.122 ms. The bytes (bits read once, each Gram's K x K
// entries read and written once) take 0.066 / 0.081 ms. Design: a block
// owns a square tile of kRelTile samples (I, J), I <= J (the upper
// triangle of tiles, J-major), and two of the set's kRelProducts products
// (a symmetric Gram one product, X_I^T X_J; an asymmetric one two, X_I^T
// Y_J at (I, J) and Y_I^T X_J transposed into (J, I), the second left out
// on the diagonal). Its threads stage the lo and hi words of the tile's row
// and column groups, kRelStageSteps k-steps a stage, in a ring of
// kRelStages by 16-B cp.async (each thread the same pieces of every stage:
// its addresses are set once); its eight warps, 2 (rows) x 4 (columns), take
// kRelMT m-tiles of 16 by kRelNT n-tiles of 8 each (64 x 32 samples, 128
// int32 accumulators a thread for the two products),
// forms each product's indicator words from lo and hi in registers, one
// lop3 each (H = lo & ~hi, R = ~(lo | hi), A = hi & ~lo, C = ~(lo & hi):
// code 3 is in none), and counts them with mma.sync m16n8k256 .b1
// AND-POPC into int32 accumulators held over the whole block of rows. At
// the end each product's tile goes through shared memory, transposed for
// (J, I), and one thread a row adds it to the Gram by a bulk reduction
// (cp.reduce.async.bulk .add: the L2 adds, and the block goes on once its
// tile is read; the SM neither reads the Gram nor takes an atomic). Its
// first epilogue, each lane's read-add-write of its fragments straight to
// the Gram (a mirror's four bytes a column apart), took about a third of
// the kernel's time. Of the three shapes timed (PERF.md row X6), this one
// was the fastest: 64-sample tiles with all six products a block, and 16
// warps of 32 x 32, were slower. The main loop runs at about half the .b1
// rate chip_diag.py --rates measures, each warp's fragment loads and
// products in turn.
constexpr int kRelStep = 256;       // variants of a k-step of mma.sync m16n8k256 .b1
constexpr int kRelPad = 128;        // S_pad is a multiple of the tile side
constexpr int kRelBitsWarps = 8;    // warps of a transposer block: 128 samples
constexpr int kRelStages = 4;       // stages in the Gram kernel's ring
constexpr int kRelStageSteps = 2;   // k-steps a stage
constexpr int kRelProducts = 6;     // products of either set (king's and genome's)
constexpr int kRelPairs = kRelProducts / 2;  // a Gram block's products: one pair of them
constexpr int kRelFragBytes = 512;  // one plane's words of a group over a k-step
// The Gram kernel's block: 2 (rows) x kRelWC (columns) warps, a warp kRelMT
// m-tiles (16 rows, a group each) by kRelNT n-tiles (8 columns, two a
// group), two products.
constexpr int kRelWC = 4, kRelMT = 4, kRelNT = 4;
constexpr int kRelThreads = 2 * kRelWC * kWarp;
constexpr int kRelTile = 16 * 2 * kRelMT;  // = 8 kRelWC kRelNT = kRelPad
constexpr int kRelGroups = kRelTile / 16;  // 16-sample groups of a tile side
// a stage: for each of the row then the column groups, lo then hi, each
// kRelStageSteps k-steps (one contiguous span of the bits)
constexpr int kRelStageBytes = 2 * kRelGroups * 2 * kRelStageSteps * kRelFragBytes;
// the epilogue's tile of one product, a row kRelTile + 4 ints (4 mod 32: the
// transposed fragment stores hit 32 banks); it reuses the ring
constexpr int kRelPitch = kRelTile + 4;
constexpr int kRelSmem = kRelStages * kRelStageBytes;
constexpr int kRelCopies = kRelStageBytes / 16 / kRelThreads;  // 16-B copies a thread a stage
static_assert(kRelTile == 8 * kRelWC * kRelNT && kRelTile == kRelPad, "tile");
static_assert(4 * kRelTile * kRelPitch <= kRelSmem, "epilogue");
static_assert(kRelCopies * 16 * kRelThreads == kRelStageBytes, "copies");

// lop3.b32 with the truth table `lut` of (a, b, c) = (0xF0, 0xCC, 0xAA).
template <int kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, 0, %3;\n" : "=r"(d) : "r"(a), "r"(b), "n"(kLut));
  return d;
}

// Indicator plane p (H, R, A, C of ops/relatedness.py: 0..3) of the slots of
// bit planes lo and hi (code = lo + 2 hi), one lop3 each; code 3 is in none.
template <int kPlane>
__device__ __forceinline__ uint32_t rel_plane(uint32_t lo, uint32_t hi) {
  if constexpr (kPlane == 0) return lop3<0x30>(lo, hi);       // H: lo & ~hi, code 1
  else if constexpr (kPlane == 1) return lop3<0x03>(lo, hi);  // R: ~(lo | hi), code 0
  else if constexpr (kPlane == 2) return lop3<0x0C>(lo, hi);  // A: hi & ~lo, code 2
  else return lop3<0x3F>(lo, hi);                             // C: ~(lo & hi), code != 3
}

enum RelMode { kRelUpper, kRelStore, kRelSwap };

// Product i of a set (0 king, 1 genome): plane x of the tile's rows against
// plane y of its columns into Gram `gram` (its index in KING_GRAMS or
// IBD_GRAMS), symmetric ones first so a group of two shares its planes.
struct RelProduct {
  int x, y, gram, mode;
};

__host__ __device__ constexpr RelProduct rel_product(int set, int i) {
  constexpr int H = 0, R = 1, A = 2, C = 3;
  if (set == 0) {
    switch (i) {
      case 0: return {H, H, 0, kRelUpper};
      case 1: return {C, C, 3, kRelUpper};
      case 2: return {R, A, 1, kRelStore};
      case 3: return {A, R, 1, kRelSwap};
      case 4: return {H, C, 2, kRelStore};
      default: return {C, H, 2, kRelSwap};
    }
  }
  switch (i) {
    case 0: return {H, H, 0, kRelUpper};
    case 1: return {C, C, 4, kRelUpper};
    case 2: return {R, A, 1, kRelStore};
    case 3: return {A, R, 1, kRelSwap};
    case 4: return {R, R, 2, kRelUpper};
    default: return {A, A, 3, kRelUpper};
  }
}

// Calls f(std::integral_constant-like I<i>) for i in [kBegin, kEnd).
template <int kI>
struct RelIndex {
  static constexpr int value = kI;
};
template <int kBegin, int kEnd, class F>
__device__ __forceinline__ void rel_for(F&& f) {
  if constexpr (kBegin < kEnd) {
    f(RelIndex<kBegin>{});
    rel_for<kBegin + 1, kEnd>(f);
  }
}

// The 32 x 32 bit matrix of a warp's words (lane r's bit c is entry (r, c))
// transposed: lane c's bit r is entry (r, c). Five swaps of off-diagonal
// blocks, 16 to 1 wide, a shuffle each.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kKeep[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u,
                                 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = lane & j ? (x & ~kKeep[i]) | ((y & ~kKeep[i]) >> j)
                 : (x & kKeep[i]) | ((y & kKeep[i]) << j);
  }
  return x;
}

__global__ void __launch_bounds__(kRelBitsWarps * kWarp)
    relatedness_bits_kernel(const uint8_t* __restrict__ packed, uint32_t* __restrict__ bits,
                            int64_t n_var, int64_t rec, int64_t n_samples, int64_t n_groups,
                            int64_t n_steps) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  // blocks of one k-step side by side: the grid reads each row's bytes in turn
  const int64_t blocks = (n_groups + kRelBitsWarps - 1) / kRelBitsWarps;
  const int64_t step = blockIdx.x / blocks;
  const int64_t grp = blockIdx.x % blocks * kRelBitsWarps + warp;
  if (grp >= n_groups) return;
  const uint32_t* last = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(packed + n_var * rec - 1) & ~uintptr_t{3});
  // out[p][e]: plane p's word of sample g + 8 (e & 1), word t + 4 (e >> 1)
  uint32_t out[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  uint32_t x[kRelStep / 32];
#pragma unroll
  for (int w = 0; w < kRelStep / 32; ++w) {
    const int64_t v = step * kRelStep + 32 * w + lane;
    x[w] = ~0u;  // a row past V: all missing
    if (v < n_var && 4 * grp < rec) x[w] = record_word(packed + v * rec, 4 * grp, last);
  }
#pragma unroll
  for (int w = 0; w < kRelStep / 32; ++w) {
    // lane 2 r + p now holds plane p of sample 16 grp + r over the word's 32
    // rows; lane (g, t) takes samples g and g + 8 of word w where t = w % 4
    const uint32_t col = transpose32(x[w], lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t word = __shfl_sync(0xFFFFFFFFu, col, 2 * (g + 8 * half) + p);
        if (t == w % 4) out[p][half + 2 * (w / 4)] = word;
      }
    }
  }
  // samples at or past S are missing whatever their bits hold
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (16 * grp + g + 8 * half >= n_samples) {
#pragma unroll
      for (int p = 0; p < 2; ++p) out[p][half] = out[p][half + 2] = ~0u;
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint4* dst = reinterpret_cast<uint4*>(bits + ((p * n_groups + grp) * n_steps + step) * 128);
    dst[lane] = make_uint4(out[p][0], out[p][1], out[p][2], out[p][3]);
  }
}

struct RelArgs {
  const uint32_t* bits;
  int32_t* grams;
  int64_t n_groups, n_steps, s_pad;
};

// One block's products kFirst and kFirst + 1 of set kSet over the tile
// (ti, tj). The first of a pair is never a swapped one, so every block has a
// product to count.
template <int kSet, int kFirst>
__device__ __forceinline__ void rel_gram_tile(const RelArgs& a, int64_t ti, int64_t tj,
                                              uint8_t* smem) {
  constexpr int kCount = 2, kGroups = kRelGroups, kMT = kRelMT, kNT = kRelNT;
  static_assert(rel_product(kSet, kFirst).mode != kRelSwap, "pairs");
  constexpr int kSpan = kRelStageSteps * kRelFragBytes / 16;  // 16-B pieces of a (group, plane)
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kRelWC, wn = warp % kRelWC;
  const bool diag = ti == tj;
  // this thread's copies: the same pieces of every stage, k-steps further on
  const uint32_t* src[kRelCopies];
  uint32_t dst[kRelCopies];
#pragma unroll
  for (int j = 0; j < kRelCopies; ++j) {
    const int q = tid + j * kRelThreads;
    const int chunk = q / kSpan, piece = q % kSpan;
    const int side = chunk / 2, p = chunk % 2;
    const int64_t grp = side < kGroups ? ti * kGroups + side : tj * kGroups + side - kGroups;
    src[j] = a.bits + (p * a.n_groups + grp) * a.n_steps * 128 + 4 * piece;
    dst[j] = smem_addr(smem) + 16 * q;
  }
  const int64_t n_stages = (a.n_steps + kRelStageSteps - 1) / kRelStageSteps;
  auto stage = [&](int64_t st) {
    if (st < n_stages) {
      const int64_t k0 = st * kRelStageSteps;
      const uint32_t off = static_cast<uint32_t>(st % kRelStages) * kRelStageBytes;
#pragma unroll
      for (int j = 0; j < kRelCopies; ++j) {
        const int s = (j * kRelThreads + tid) % kSpan / (kRelFragBytes / 16);
        if (k0 + s < a.n_steps) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst[j] + off),
                       "l"(src[j] + k0 * 128));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the last stage
  };
  int acc[kCount][kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kCount; ++i)
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][n][e] = 0;
#pragma unroll
  for (int st = 0; st < kRelStages - 1; ++st) stage(st);
  for (int64_t st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRelStages - 2) : "memory");
    // stage st has landed, and stage st - 1's buffer, which the next copy
    // overwrites, is read
    __syncthreads();
    stage(st + kRelStages - 1);
    const uint4* buf = reinterpret_cast<const uint4*>(smem + (st % kRelStages) * kRelStageBytes);
#pragma unroll
    for (int s = 0; s < kRelStageSteps; ++s) {
      if (st * kRelStageSteps + s >= a.n_steps) break;
      // (group c, plane p) of this k-step, lane's 16 B
      auto frag = [&](int c, int p) { return buf[((2 * c + p) * kRelStageSteps + s) * kWarp + lane]; };
      uint4 blo[kNT / 2], bhi[kNT / 2];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        const int c = kGroups + wn * (kNT / 2) + j;
        blo[j] = frag(c, 0);
        bhi[j] = frag(c, 1);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int r = wm * kMT + m;
        const uint4 alo = frag(r, 0), ahi = frag(r, 1);
        rel_for<0, kCount>([&](auto ii) {
          constexpr RelProduct pr = rel_product(kSet, kFirst + decltype(ii)::value);
          constexpr int i = decltype(ii)::value;
          if (pr.mode == kRelSwap && diag) return;
          const uint32_t ax[4] = {rel_plane<pr.x>(alo.x, ahi.x), rel_plane<pr.x>(alo.y, ahi.y),
                                  rel_plane<pr.x>(alo.z, ahi.z), rel_plane<pr.x>(alo.w, ahi.w)};
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            // n-tile n: samples 8 (n % 2) .. of column group n / 2, whose
            // words t and t + 4 are entries n % 2 and n % 2 + 2
            const uint4 lo = blo[n / 2], hi = bhi[n / 2];
            const uint32_t b0 = rel_plane<pr.y>(n % 2 ? lo.y : lo.x, n % 2 ? hi.y : hi.x);
            const uint32_t b1 = rel_plane<pr.y>(n % 2 ? lo.w : lo.z, n % 2 ? hi.w : hi.z);
            mma_and_popc(acc[i][m][n], ax, b0, b1);
          }
        });
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every warp is past the ring, which the epilogue's tile reuses
  // Each product's tile goes through shared memory, fragment entry e (row
  // g + 8 (e / 2) of m-tile m, column 2 t + e % 2 of n-tile n) at [row][col],
  // or at [col][row] for the transposed tile of (J, I); then one thread a
  // row adds it to the Gram's row by a bulk reduction (the tensor memory
  // accelerator adds in L2, and the block goes on once it has read the
  // row). A symmetric Gram gets its entries on and above the diagonal
  // only: its tiles (I, J), I <= J, the diagonal tiles' lower entries as 0.
  int* tile = reinterpret_cast<int*>(smem);
  auto add = [&](const int (&d)[kMT][kNT][4], bool transposed, bool upper, int32_t* dst) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * (wm * kMT + m) + g + 8 * (e >> 1);
          const int col = 8 * (wn * kNT + n) + 2 * t + (e & 1);
          tile[transposed ? col * kRelPitch + row : row * kRelPitch + col] =
              upper && row > col ? 0 : d[m][n][e];
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid < kRelTile) {
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;\n" ::"l"(
              dst + tid * a.s_pad),
          "r"(smem_addr(tile + tid * kRelPitch)), "n"(4 * kRelTile)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    __syncthreads();  // the tile is read before the next product's is written
  };
  rel_for<0, kCount>([&](auto ii) {
    constexpr RelProduct pr = rel_product(kSet, kFirst + decltype(ii)::value);
    constexpr int i = decltype(ii)::value;
    if (pr.mode == kRelSwap && diag) return;
    int32_t* gram = a.grams + static_cast<int64_t>(pr.gram) * a.s_pad * a.s_pad;
    if (pr.mode == kRelSwap) {
      add(acc[i], true, false, gram + tj * kRelTile * a.s_pad + ti * kRelTile);
    } else {
      add(acc[i], false, pr.mode == kRelUpper && diag,
          gram + ti * kRelTile * a.s_pad + tj * kRelTile);
    }
  });
}

template <int kSet>
__global__ void __launch_bounds__(kRelThreads, 1) relatedness_gram_kernel(RelArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  // tile t of the upper triangle, J-major: t = tj (tj + 1) / 2 + ti, ti <= tj
  const int64_t t = blockIdx.x;
  int64_t tj = static_cast<int64_t>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) / 2.0);
  while (tj * (tj + 1) / 2 > t) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  const int64_t ti = t - tj * (tj + 1) / 2;
  // blockIdx.y: the pair of products
  if (blockIdx.y == 0) rel_gram_tile<kSet, 0>(a, ti, tj, smem);
  else if (blockIdx.y == 1) rel_gram_tile<kSet, 2>(a, ti, tj, smem);
  else rel_gram_tile<kSet, 4>(a, ti, tj, smem);
}

// One block for each tile of rows up to as many as the card holds at once:
// its SMs times the blocks an SM holds, the kernel's launch bounds (its
// registers) or the shared memory (228 KB an SM, 1 KB of it reserved a
// block), whichever is fewer.
template <int kPer>
int launch_repack_staged(const uint8_t* in, const int32_t* ids, uint8_t* dst, int64_t n_var,
                         int64_t rec, int64_t n_kept, int64_t tile_rows, int64_t in_bytes,
                         int64_t smem, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t per_sm = 228 * 1024 / (smem + 1024);
  const int64_t by_registers = kRepackMinBlocks<kPer>;
  if (per_sm > by_registers) per_sm = by_registers;
  int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t row_tiles = (n_var + tile_rows - 1) / tile_rows;
  if (blocks > row_tiles) blocks = row_tiles;
  subset_repack_staged_kernel<kPer><<<static_cast<unsigned>(blocks), kThreads,
                                      static_cast<size_t>(smem), s>>>(
      in, ids, dst, n_var, rec, n_kept, static_cast<int>(tile_rows), static_cast<int>(in_bytes));
  return static_cast<int>(cudaGetLastError());
}

// The three forms of K11 and K13 (see K11's note): flat without sel at
// S % 4 == 0 into a 16-B aligned output, else K10's tiles, after a count
// pass into sums past kPlaneChunk ids.
template <class Rows>
int launch_dosage(const uint8_t* in, const int32_t* ids, const uint8_t* flip, void* out,
                  typename Rows::Out* row_out, int32_t* sums, int64_t n_var, int64_t rec,
                  int64_t n_samples, int64_t n_kept, int mean_impute, cudaStream_t s) {
  if (ids == nullptr && n_kept % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int64_t rows_per_block = kThreads / kWarp;
    const int64_t blocks = (n_var + rows_per_block - 1) / rows_per_block;
    dosage_flat_kernel<Rows><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                               kThreads, 0, s>>>(
        in, flip, static_cast<float4*>(out), row_out, n_var, rec, n_kept / 4, mean_impute);
    return static_cast<int>(cudaGetLastError());
  }
  const OperandTiles t = operand_tiles(n_var, n_kept, ids != nullptr);
  const cudaError_t opted = cudaFuncSetAttribute(
      dosage_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPlaneSmemBytes));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if (t.chunks > 1) {  // each row's counts before any chunk's block writes it
    const cudaError_t cleared = cudaMemsetAsync(sums, 0, 4 * Rows::kSums * n_var, s);
    if (cleared != cudaSuccess) return static_cast<int>(cleared);
    // about four blocks an SM in all: each stages its chunk's ids once for
    // its rows (a block per tile, as the store takes, would stage them per
    // row: 67 MB of L2 reads at 1,024 x 40,000)
    const int64_t rows_per_block = kThreads / kWarp;
    int64_t gx = (n_var + rows_per_block - 1) / rows_per_block;
    const int64_t most = 4 * 132 / t.chunks > 1 ? 4 * 132 / t.chunks : 1;
    if (gx > most) gx = most;
    const int64_t id_bytes = ids != nullptr ? 4 * t.chunk : 0;  // 32 KB at most
    dosage_counts_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(t.chunks)),
                           kThreads, static_cast<size_t>(id_bytes), s>>>(
        in, ids, flip, sums, n_var, rec, static_cast<int>(n_samples), static_cast<int>(n_kept),
        static_cast<int>(t.chunk));
    const cudaError_t counted = cudaGetLastError();
    if (counted != cudaSuccess) return static_cast<int>(counted);
  }
  dosage_kernel<Rows><<<t.grid, kThreads, static_cast<size_t>(t.smem), s>>>(
      in, ids, flip, static_cast<float*>(out), row_out, sums, n_var, rec,
      static_cast<int>(n_samples), static_cast<int>(n_kept), mean_impute,
      static_cast<int>(t.tile_rows), static_cast<int>(t.chunk), t.row_warps);
  return static_cast<int>(cudaGetLastError());
}

// A launch shape the card was asked about: the blocks of it the card holds
// at once, cached per kernel, device and dynamic shared memory (the
// attribute and the occupancy query cost every launch host time
// otherwise). The kernel's shared-memory attribute is set to the card's
// most, so it holds for every size a kernel is launched with.
struct Fit {
  const void* kernel = nullptr;
  int device = -1, smem = 0;
  int64_t blocks = 0;
};

int64_t resident_blocks(const void* kernel, int threads, int smem, cudaError_t* err) {
  static Fit fits[16];
  static int next_fit = 0;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  for (const Fit& f : fits) {
    if (f.kernel == kernel && f.device == device && f.smem == smem) return f.blocks;
  }
  int most = 0, sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (*err == cudaSuccess) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (*err == cudaSuccess && per_sm < 1) *err = cudaErrorInvalidConfiguration;
  if (*err != cudaSuccess) return 0;
  fits[next_fit] = Fit{kernel, device, smem, static_cast<int64_t>(sms) * per_sm};
  const int64_t blocks = fits[next_fit].blocks;
  next_fit = (next_fit + 1) % 16;
  return blocks;
}

// K15: items of 64 rows by DT offsets, one block for each up to as many as
// the card holds at once.
template <int kNt>
int launch_ld(LdArgs a, cudaStream_t s) {
  constexpr int kDt = ld_band_tile(kNt);
  a.n_dtiles = (a.band + kDt - 1) / kDt;
  const int64_t items = (a.n_out + kLdRows - 1) / kLdRows * a.n_dtiles;
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.n_items = static_cast<int>(items);
  const int smem = ld_smem_bytes(kNt);
  cudaError_t err;
  const int64_t blocks = resident_blocks(reinterpret_cast<const void*>(ld_r2_band_kernel<kNt>),
                                         kLdThreads, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  ld_r2_band_kernel<kNt><<<static_cast<unsigned>(items < blocks ? items : blocks), kLdThreads,
                          smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K12's Gram kernel: one block for each tile of the upper triangle and pair
// of products.
template <int kSet>
int launch_rel_gram(const RelArgs& a, cudaStream_t s) {
  const int64_t sides = a.s_pad / kRelTile;
  const int64_t tiles = sides * (sides + 1) / 2;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  // lifts the kernel's shared-memory limit
  resident_blocks(reinterpret_cast<const void*>(relatedness_gram_kernel<kSet>), kRelThreads,
                  kRelSmem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  relatedness_gram_kernel<kSet><<<dim3(static_cast<unsigned>(tiles), kRelPairs), kRelThreads,
                                  kRelSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K13's pass, one chunk of kCols columns (a multiple of 4): q's rows in
// shared memory (all of them where they fit in kPcaQBytes), then t = Z q,
// Z^T t by chunks of rows, and y += their sum.
template <int kCols>
int launch_pca(PcaArgs a, cudaStream_t s) {
  constexpr int kPitch = pca_pitch(kCols);
  const int most = kPcaQBytes / (4 * kPitch) / kWarp * kWarp;
  const int need = (a.n_samples + kWarp - 1) / kWarp * kWarp;
  a.q_rows = need < most ? need : most;
  const int smem = 4 * kPitch * a.q_rows;
  cudaError_t err;
  const int64_t blocks = resident_blocks(reinterpret_cast<const void*>(pca_zq_kernel<kCols>),
                                         kPcaThreads, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = (a.n_var + kPcaWarps * kPcaRows - 1) / (kPcaWarps * kPcaRows);
  pca_zq_kernel<kCols><<<static_cast<unsigned>(groups < blocks ? groups : blocks), kPcaThreads,
                         smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pca_zty_kernel<kCols><<<static_cast<unsigned>(a.n_slices * a.n_chunks), kPcaSliceThreads, 0,
                          s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pca_sum_kernel<kCols><<<grid_for(static_cast<int64_t>(a.n_samples) * a.n_cols), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  if (n_var <= 0 || n_samples <= 0) return 0;
  const auto at = reinterpret_cast<uintptr_t>(text);
  if (at % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(packed);
  if (n_samples % 4 == 0 && at % 16 == 0) {
    const int64_t n_quads = n_samples / 4;
    genotype_text_quad_kernel<<<tile_grid(n_var, n_quads, kTileThreads, 1),
                                kTileThreads, 0, s>>>(
        in, static_cast<uint4*>(text), n_var, rec, n_quads);
  } else {
    genotype_text_words_kernel<<<tile_grid(n_var, n_samples, kTileThreads, 1),
                                 kTileThreads, 0, s>>>(
        in, static_cast<uint32_t*>(text), n_var, rec, n_samples);
  }
  return static_cast<int>(cudaGetLastError());
}

int pgen_subset_text(const void* packed, const void* sel, void* text,
                     int64_t n_var, int64_t rec, int64_t n_kept,
                     void* stream) {
  if (n_var <= 0 || n_kept <= 0) return 0;
  const auto at = reinterpret_cast<uintptr_t>(text);
  if (at % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool quad = n_kept % 4 == 0 && at % 16 == 0;
  const int64_t cols = quad ? n_kept / 4 : n_kept;
  // threads on columns: one warp or more, the rest of 256 on rows
  int64_t tx = (cols + 31) / 32 * 32;
  if (tx > 256) tx = 256;
  const int64_t ty = 256 / tx;
  const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const dim3 grid = tile_grid(n_var, cols, tx, ty);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(packed);
  const auto ids = static_cast<const int32_t*>(sel);
  if (quad) {
    subset_text_kernel<4><<<grid, block, 0, s>>>(in, ids, static_cast<uint32_t*>(text),
                                                 n_var, rec, n_kept);
  } else {
    subset_text_kernel<1><<<grid, block, 0, s>>>(in, ids, static_cast<uint32_t*>(text),
                                                 n_var, rec, n_kept);
  }
  return static_cast<int>(cudaGetLastError());
}

int pgen_pack_codes(const void* codes, void* packed, int64_t n_var,
                    int64_t n_samples, void* stream) {
  const int64_t rec = (n_samples + 3) / 4;
  const int64_t n = n_var * rec;
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(codes);
  const auto out = static_cast<uint8_t*>(packed);
  if (n_samples % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(packed) % 4 == 0) {
    const int64_t n_words = n / 4;
    const int64_t per_block = kThreads * kPackUnroll;
    int64_t blocks = (n_words + per_block - 1) / per_block;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    pack_codes_flat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(in), reinterpret_cast<uint32_t*>(out), n_words, n);
  } else {
    // whole rows per tile, or column tiles of a row wider than a tile
    const int64_t col_tiles = (n_samples + kPackTileBytes - 1) / kPackTileBytes;
    const int64_t width = col_tiles == 1 ? n_samples : kPackTileBytes;
    int64_t tile_rows = kPackTileBytes / width;
    if (tile_rows > kPackMaxTileRows) tile_rows = kPackMaxTileRows;
    if (tile_rows > n_var) tile_rows = n_var;
    // the span, up to 15 lead bytes and 8 B of slack, in whole 16 B
    const int64_t in_bytes = (tile_rows * width + 15 + 8 + 15) / 16 * 16;
    const int64_t out_bytes = (tile_rows * ((width + 3) / 4) + 15 + 15) / 16 * 16;
    const int64_t tiles =
        col_tiles == 1 ? (n_var + tile_rows - 1) / tile_rows : n_var * col_tiles;
    // threads on record bytes: one warp or more, the rest of 256 on rows
    int64_t tx = ((width + 3) / 4 + 31) / 32 * 32;
    if (tx > 128) tx = 128;
    const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(kThreads / tx));
    pack_codes_staged_kernel<<<static_cast<unsigned>(tiles < kStagedBlocks ? tiles : kStagedBlocks),
                               block, static_cast<size_t>(2 * in_bytes + out_bytes), s>>>(
        in, out, n_var, n_samples, rec, static_cast<int>(tile_rows),
        static_cast<int>(in_bytes), tiles, static_cast<int>(col_tiles));
  }
  return static_cast<int>(cudaGetLastError());
}

int pgen_subset_repack(const void* packed, const void* sel, void* out,
                       int64_t n_var, int64_t rec, int64_t n_kept,
                       void* stream) {
  const int64_t out_rec = (n_kept + 3) / 4;
  if (n_var <= 0 || out_rec <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(packed);
  const auto ids = static_cast<const int32_t*>(sel);
  const auto dst = static_cast<uint8_t*>(out);
  // a staged block's threads hold a row's output: a byte each up to K =
  // 1,024, four bytes each up to 4,096
  if (out_rec <= kThreads * kRepackMaxPer && rec <= kRepackTileBytes &&
      rec <= kRepackDenseRatio * n_kept) {
    // rows of a tile: their records, and their output, each within
    // kRepackTileBytes
    const int64_t widest = out_rec > rec ? out_rec : rec;
    int64_t tile_rows = kRepackTileBytes / widest;
    if (tile_rows > kRepackMaxTileRows) tile_rows = kRepackMaxTileRows;
    if (tile_rows > n_var) tile_rows = n_var;
    // the spans and up to 15 lead bytes, in whole 16 B
    const int64_t in_bytes = (tile_rows * rec + 15 + 15) / 16 * 16;
    const int64_t out_bytes = (tile_rows * out_rec + 15 + 15) / 16 * 16;
    const int64_t smem = 2 * in_bytes + out_bytes;  // under 48 KB
    if (out_rec <= kThreads) {
      return launch_repack_staged<1>(in, ids, dst, n_var, rec, n_kept, tile_rows, in_bytes, smem,
                                     s);
    }
    return launch_repack_staged<kRepackMaxPer>(in, ids, dst, n_var, rec, n_kept, tile_rows,
                                               in_bytes, smem, s);
  }
  // threads on output bytes: a power of two up to 256 (past that, column
  // tiles on blockIdx.x), the rest on rows
  int64_t tx = 1;
  while (tx < out_rec && tx < kThreads) tx *= 2;
  const int64_t ty = kThreads / tx;
  subset_repack_direct_kernel<<<tile_grid(n_var, out_rec, tx, ty),
                                dim3(static_cast<unsigned>(tx), static_cast<unsigned>(ty)), 0,
                                s>>>(in, ids, dst, n_var, rec, n_kept, out_rec);
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

int pgen_gt_counts(const void* packed, void* counts, int64_t n_var,
                   int64_t rec, int64_t n_samples, void* stream) {
  if (n_var <= 0 || n_samples <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(counts) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t rows_per_block = 2 * kThreads / kWarp;
  const int64_t blocks = (n_var + rows_per_block - 1) / rows_per_block;
  gt_counts_kernel<<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int4*>(counts), n_var,
      rec, static_cast<int>(n_samples));
  return static_cast<int>(cudaGetLastError());
}

int pgen_gt_counts_masked(const void* packed, const void* words, const void* kept, void* counts,
                          int64_t n_var, int64_t rec, int64_t n_masks, void* stream) {
  if (n_var <= 0 || rec <= 0 || n_masks <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(counts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(kept) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_masks > kMaskedMaxMasks) return static_cast<int>(cudaErrorInvalidValue);
  MaskedArgs a;
  a.packed = static_cast<const uint8_t*>(packed);
  a.words = static_cast<const uint32_t*>(words);
  a.kept = static_cast<const int*>(kept);
  a.counts = static_cast<int4*>(counts);
  a.n_var = n_var;
  a.rec = rec;
  a.n_masks = static_cast<int>(n_masks);
  a.chunk = static_cast<int>(rec <= kMaskedWholeRow ? rec : kMaskedChunk);
  a.n_chunks = static_cast<int>((rec + a.chunk - 1) / a.chunk);
  a.mask_rows = 8 * ((a.n_masks + 7) / 8);
  a.n_mbufs = a.n_chunks == 1 ? 1 : kMaskedStages;
  // whole 32-B products; a mask row 4 (mod 8) words apart from the next, so
  // the lanes of a warp read its E words from distinct banks
  const int span = 32 * ((a.chunk + 31) / 32);
  a.word_stride = static_cast<int>(8 * ((rec + 31) / 32));
  a.mask_stride = span / 4 + 4;
  // a row's slot (rows in chunks): its lead bytes, its words, and those its
  // last funnel shift reads past them; an odd number of 16-B pieces. Whole
  // rows: the tile's lead bytes, its rows, and the same words past them
  a.pitch = 16 * ((15 + span + 8 + 15) / 16);
  if (a.pitch % 32 == 0) a.pitch += 16;
  a.tile_bytes = a.n_chunks == 1
                     ? static_cast<int>(16 * ((15 + (kMaskedRows - 1) * rec + span + 8 + 15) / 16))
                     : kMaskedRows * a.pitch;
  const int smem = kMaskedStages * a.tile_bytes + 4 * a.n_mbufs * a.mask_rows * a.mask_stride +
                   16 * kMaskedStages;
  const int n_oct = (a.n_masks + 7) / 8;
  const auto kernel = n_oct == 1   ? gt_counts_masked_kernel<1>
                      : n_oct == 2 ? gt_counts_masked_kernel<2>
                                   : gt_counts_masked_kernel<4>;
  // the blocks the card holds at once for this kernel and shared memory
  // (they vary with R and ceil(P / 8))
  cudaError_t err;
  const int64_t blocks =
      resident_blocks(reinterpret_cast<const void*>(kernel), kMaskedThreads + kWarp, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  // chunks an item counts: the fewest steps of the busiest block, with a
  // step more an item for its stores and its pipeline's fill (so all of a
  // tile's chunks in one item, and no atomics, wherever the tiles fill the
  // card)
  const int64_t n_tiles = (n_var + kMaskedRows - 1) / kMaskedRows;
  int64_t best = -1;
  for (int g = a.n_chunks; g >= 1; --g) {
    const int64_t items = n_tiles * ((a.n_chunks + g - 1) / g);
    const int64_t cost = (items + blocks - 1) / blocks * (g + 1);
    if (best < 0 || cost < best) {
      best = cost;
      a.group = g;
    }
  }
  a.n_groups = (a.n_chunks + a.group - 1) / a.group;
  // items and the grid stride past the last count in int
  if (n_tiles * a.n_groups > INT32_MAX - blocks) return static_cast<int>(cudaErrorInvalidValue);
  a.n_items = static_cast<int>(n_tiles * a.n_groups);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.n_groups > 1) {  // every item adds its counts
    err = cudaMemsetAsync(counts, 0, 16 * n_var * n_masks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(a.n_items < blocks ? a.n_items : blocks), kMaskedThreads + kWarp,
           smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int pgen_sample_counts(const void* packed, void* counts, int64_t n_var,
                       int64_t rec, void* stream) {
  if (n_var <= 0 || rec <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(counts) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // every block adds its counts into the (4R, 4) ints
  const cudaError_t cleared = cudaMemsetAsync(counts, 0, 64 * rec, s);
  if (cleared != cudaSuccess) return static_cast<int>(cleared);
  // whole rows in a block up to kCountMaxSegs segments; row chunks for
  // about kCountBlocks blocks in all, each warp kCountMinRows rows or more
  const int64_t n_segs = ((rec + 3) / 4 + kWarp - 1) / kWarp;
  const int64_t segs = n_segs < kCountMaxSegs ? n_segs : kCountMaxSegs;
  const int64_t gx = (n_segs + segs - 1) / segs;
  const int64_t groups = kCountWarps / segs;
  int64_t gy = kCountBlocks / gx;
  const int64_t most = (n_var + groups * kCountMinRows - 1) / (groups * kCountMinRows);
  if (gy > most) gy = most;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  const int64_t chunk = (n_var + gy - 1) / gy;
  gy = (n_var + chunk - 1) / chunk;  // no block without rows
  const int smem = static_cast<int>(segs * kWarp * 48 * 4);  // 96 KB at most
  const cudaError_t opted = cudaFuncSetAttribute(
      sample_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  sample_counts_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                         dim3(kWarp, kCountWarps), smem, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<int32_t*>(counts), n_var, rec, chunk,
      static_cast<int>(segs));
  return static_cast<int>(cudaGetLastError());
}

int pgen_glm_planes(const void* packed, const void* sel, const void* lut,
                    void* planes, void* hist, int64_t n_var, int64_t rec,
                    int64_t n_samples, int64_t n_kept, int64_t n_planes,
                    void* stream) {
  if (n_var <= 0) return 0;
  if (n_planes < 1 || n_planes > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(packed);
  const auto ids = static_cast<const int32_t*>(sel);
  const auto tab = static_cast<const float*>(lut);
  const auto out = static_cast<float*>(planes);
  const auto counts = static_cast<int32_t*>(hist);
  if (reinterpret_cast<uintptr_t>(planes) % 4 != 0 || reinterpret_cast<uintptr_t>(hist) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_kept <= 0) return 0;
  const OperandTiles t = operand_tiles(n_var, n_kept, ids != nullptr);
  // per device, so on every launch; above 48 KB only wide cohorts
  const cudaError_t opted = cudaFuncSetAttribute(
      glm_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPlaneSmemBytes));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if (t.chunks > 1 || t.row_warps > 1) {  // several warps or chunks add a row's counts
    const cudaError_t cleared = cudaMemsetAsync(counts, 0, 16 * n_var, s);
    if (cleared != cudaSuccess) return static_cast<int>(cleared);
  }
  glm_planes_kernel<<<t.grid, kThreads, static_cast<size_t>(t.smem), s>>>(
      in, ids, tab, out, counts, n_var, rec, static_cast<int>(n_samples),
      static_cast<int>(n_kept), static_cast<int>(n_planes), static_cast<int>(t.tile_rows),
      static_cast<int>(t.chunk), t.row_warps);
  return static_cast<int>(cudaGetLastError());
}

int pgen_score_dosage(const void* packed, const void* sel, const void* flip,
                      void* db, void* called, int64_t n_var, int64_t rec,
                      int64_t n_samples, int64_t n_kept, int64_t mean_impute,
                      void* stream) {
  if (n_var <= 0) return 0;
  const auto at = reinterpret_cast<uintptr_t>(db);
  if (at % 4 != 0 || reinterpret_cast<uintptr_t>(called) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_kept <= 0) return 0;  // nothing is called: the wrapper returns zeros
  const auto n_called = static_cast<int32_t*>(called);
  return launch_dosage<ScoreRows>(static_cast<const uint8_t*>(packed),
                                  static_cast<const int32_t*>(sel),
                                  static_cast<const uint8_t*>(flip), db, n_called, n_called,
                                  n_var, rec, n_samples, n_kept, mean_impute != 0,
                                  static_cast<cudaStream_t>(stream));
}

// rows: (3V) int32, the used flags then the chunked form's (2V) sums.
int pgen_grm_z(const void* packed, const void* sel, void* z, void* rows, int64_t n_var,
               int64_t rec, int64_t n_samples, int64_t n_kept, void* stream) {
  if (n_var <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(z) % 4 != 0 || reinterpret_cast<uintptr_t>(rows) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_kept <= 0) return 0;  // nothing is used: the wrapper returns zeros
  const auto used = static_cast<int32_t*>(rows);
  return launch_dosage<GrmRows>(static_cast<const uint8_t*>(packed),
                                static_cast<const int32_t*>(sel), nullptr, z, used, used + n_var,
                                n_var, rec, n_samples, n_kept, 0,
                                static_cast<cudaStream_t>(stream));
}

// out (n_out, band) f64, 8-B aligned; rows at or past n_rows are missing.
int pgen_ld_r2_band(const void* packed, void* out, int64_t n_rows, int64_t n_out, int64_t rec,
                    int64_t n_samples, int64_t band, void* stream) {
  if (n_out <= 0 || band <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_samples < 0 || n_samples > 4 * rec || band > INT32_MAX || rec > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LdArgs a;
  a.packed = static_cast<const uint8_t*>(packed);
  a.out = static_cast<double*>(out);
  a.n_rows = n_rows;
  a.n_out = n_out;
  a.rec = rec;
  a.used = static_cast<int>((n_samples + 3) / 4);
  a.band = static_cast<int>(band);
  a.n_chunks = (a.used + kLdChunk - 1) / kLdChunk;
  // the samples of the last used byte, 1 to 4: the slots past them are pad
  const int tail = static_cast<int>(n_samples - 4 * (a.used - 1));
  a.last_pad = n_samples > 0 ? (0xFFu << (2 * tail)) & 0xFFu : 0u;
  // n-tiles a warp: its 16 rows against the DT offsets of a tile, the whole
  // band up to 49
  const int64_t dt = band < ld_band_tile(kLdMaxNt) ? band : ld_band_tile(kLdMaxNt);
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((15 + dt + 7) / 8) {
    case 2: return launch_ld<2>(a, s);
    case 3: return launch_ld<3>(a, s);
    case 4: return launch_ld<4>(a, s);
    case 5: return launch_ld<5>(a, s);
    case 6: return launch_ld<6>(a, s);
    case 7: return launch_ld<7>(a, s);
    default: return launch_ld<8>(a, s);
  }
}

// The pass's scratch for a block of n_var rows of n_samples samples, in
// bytes: each row's table (V) float4, t (V, kPcaMaxCols) f32 and the chunks'
// partial sums (chunks, slices x 512, kPcaMaxCols) f32, each 16-B aligned.
int64_t pgen_pca_approx_scratch_bytes(int64_t n_var, int64_t n_samples) {
  const int64_t slices = ((n_samples + 3) / 4 + kPcaSliceThreads - 1) / kPcaSliceThreads;
  const int64_t chunks = (n_var + kPcaRowChunk - 1) / kPcaRowChunk;
  return 4 * (n_var * (4 + kPcaMaxCols) + chunks * slices * 4 * kPcaSliceThreads * kPcaMaxCols);
}

// q and y (S, L) f32, used one int64; scratch scratch_bytes bytes, at least
// pgen_pca_approx_scratch_bytes(n_var, n_samples) of them.
int pgen_pca_approx_pass(const void* packed, const void* q, void* y, void* used, void* scratch,
                         int64_t n_var, int64_t rec, int64_t n_samples, int64_t n_cols,
                         int64_t scratch_bytes, void* stream) {
  if (n_var <= 0 || n_samples <= 0 || n_cols <= 0) return 0;
  const auto misaligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to != 0;
  };
  if (misaligned(q, 4) || misaligned(y, 4) || misaligned(used, 8) || misaligned(scratch, 16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_samples > 4 * rec || n_samples > INT32_MAX || n_cols > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t slices = ((n_samples + 3) / 4 + kPcaSliceThreads - 1) / kPcaSliceThreads;
  const int64_t chunks = (n_var + kPcaRowChunk - 1) / kPcaRowChunk;
  if (pgen_pca_approx_scratch_bytes(n_var, n_samples) > scratch_bytes ||
      slices * chunks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PcaArgs a;
  a.packed = static_cast<const uint8_t*>(packed);
  a.q = static_cast<const float*>(q);
  a.y = static_cast<float*>(y);
  a.used = static_cast<unsigned long long*>(used);
  a.table = static_cast<float4*>(scratch);
  a.zq = reinterpret_cast<float*>(a.table + n_var);
  a.parts = a.zq + n_var * kPcaMaxCols;
  a.n_var = n_var;
  a.rec = rec;
  a.n_samples = static_cast<int>(n_samples);
  a.pitch = static_cast<int>(n_cols);
  a.n_slices = static_cast<int>(slices);
  a.n_chunks = static_cast<int>(chunks);
  const auto s = static_cast<cudaStream_t>(stream);
  for (int64_t col0 = 0; col0 < n_cols; col0 += kPcaMaxCols) {
    a.col0 = static_cast<int>(col0);
    a.n_cols = static_cast<int>(n_cols - col0 < kPcaMaxCols ? n_cols - col0 : kPcaMaxCols);
    a.count_used = col0 == 0;
    int status;
    switch ((a.n_cols + 3) / 4) {
      case 1: status = launch_pca<4>(a, s); break;
      case 2: status = launch_pca<8>(a, s); break;
      case 3: status = launch_pca<12>(a, s); break;
      case 4: status = launch_pca<16>(a, s); break;
      case 5: status = launch_pca<20>(a, s); break;
      default: status = launch_pca<24>(a, s); break;
    }
    if (status != 0) return status;
  }
  return 0;
}

// bits (2, n_groups, n_steps, 128) u32, 16-B aligned; n_groups a multiple
// of kRelPad / 16, at least ceil(n_samples / 16).
int pgen_relatedness_bits(const void* packed, void* bits, int64_t n_var, int64_t rec,
                          int64_t n_samples, int64_t n_groups, int64_t n_steps, void* stream) {
  if (n_groups <= 0 || n_steps <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(bits) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t blocks = n_steps * ((n_groups + kRelBitsWarps - 1) / kRelBitsWarps);
  if (n_samples < 0 || n_samples > 4 * rec || n_samples > 16 * n_groups ||
      n_steps != (n_var + kRelStep - 1) / kRelStep || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  relatedness_bits_kernel<<<static_cast<unsigned>(blocks), kRelBitsWarps * kWarp, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint32_t*>(bits), n_var, rec, n_samples,
      n_groups, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// grams (n_grams, 16 n_groups, 16 n_groups) int32, 16-B aligned (the bulk
// reductions' addresses; each row's is 64 B times a whole number on), added to in
// place; set 0 king's four Grams, 1 genome's five (ops/relatedness.py's
// GRAM_SETS).
int pgen_relatedness_gram(const void* bits, void* grams, int64_t n_groups, int64_t n_steps,
                          int64_t set, void* stream) {
  if (n_groups <= 0 || n_steps <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(bits) % 16 != 0 || reinterpret_cast<uintptr_t>(grams) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if ((set != 0 && set != 1) || n_groups % (kRelPad / 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RelArgs a;
  a.bits = static_cast<const uint32_t*>(bits);
  a.grams = static_cast<int32_t*>(grams);
  a.n_groups = n_groups;
  a.n_steps = n_steps;
  a.s_pad = 16 * n_groups;
  const auto s = static_cast<cudaStream_t>(stream);
  return set == 0 ? launch_rel_gram<0>(a, s) : launch_rel_gram<1>(a, s);
}

const char* pgen_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
