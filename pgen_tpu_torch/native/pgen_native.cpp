// pgen_tpu native host runtime: single-pass VCF row emission + 2-bit codecs.
//
// TPU-native framework split (SURVEY.md §7 "Hard parts" #1): the genotype
// matrix math runs on device (Pallas kernels in ops/), but the byte-exact
// VCF text must ultimately stream through the host to the filesystem. The
// reference spends most of its keep-all wall time in per-sample write calls
// (pgen-rs/src/pfile.rs:171-188, 18.9 s sys on chr22 — SURVEY.md §6).
// This runtime makes that host stage a single memory pass:
//
//   record byte (4 hard calls) --LUT--> 16 output bytes "\t0/0\t0/1..."
//
// so emission runs at memcpy speed. Exposed via a plain C ABI for ctypes.
//
// Semantics replicated exactly (pfile.rs:156-191):
//   row := prefix bytes (pvar cols + "\tGT")
//        + per kept sample "\t" + token, token in {0/0, 0/1, 1/1, ./.}
//        + "\n"
//   code extraction: (byte >> ((s % 4) * 2)) & 3, LSB-first (pfile.rs:171-175).

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <unistd.h>
#include <errno.h>

#if defined(__SSE2__)
#include <immintrin.h>
#define PGEN_HAVE_NT 1
#endif

namespace {

// 4-byte tokens per 2-bit code, each preceded by '\t' (pfile.rs:177-187).
const unsigned char kTok[4][4] = {
    {'\t', '0', '/', '0'},
    {'\t', '0', '/', '1'},
    {'\t', '1', '/', '1'},
    {'\t', '.', '/', '.'},
};

// 256-entry LUT: one packed byte -> 16 text bytes (4 samples).
struct Lut16 {
  unsigned char t[256][16];
  Lut16() {
    for (int b = 0; b < 256; ++b)
      for (int k = 0; k < 4; ++k)
        std::memcpy(&t[b][4 * k], kTok[(b >> (2 * k)) & 3], 4);
  }
};
const Lut16 kLut;

// Masked LUT: for a packed byte and a 4-bit keep-mask over its samples,
// the text bytes of the KEPT samples only (4*popcount(mask) bytes).
// 16*256*16 = 64 KB, cache-resident. Kept samples are always emitted in
// file order (filtering is order-stable), so a per-record-byte mask plan
// fully describes any sample subset.
struct LutMasked {
  unsigned char t[16][256][16];
  unsigned char n[16];  // 4*popcount
  LutMasked() {
    for (int m = 0; m < 16; ++m) {
      int cnt = 0;
      for (int b = 0; b < 256; ++b) {
        unsigned char* dst = t[m][b];
        int w = 0;
        for (int k = 0; k < 4; ++k) {
          if (m & (1 << k)) {
            std::memcpy(dst + w, kTok[(b >> (2 * k)) & 3], 4);
            w += 4;
          }
        }
        cnt = w;
      }
      n[m] = (unsigned char)cnt;
    }
  }
};
const LutMasked kLutM;

// 256x4 LUT: packed byte -> 4 codes.
struct LutCodes {
  unsigned char t[256][4];
  LutCodes() {
    for (int b = 0; b < 256; ++b)
      for (int k = 0; k < 4; ++k) t[b][k] = (b >> (2 * k)) & 3;
  }
};
const LutCodes kCodes;

constexpr int64_t kBufCap = 8 << 20;  // 8 MiB output buffer

struct OutBuf {
  unsigned char* buf;
  int64_t len = 0;
  int fd;
  int64_t written = 0;
  bool error = false;

  explicit OutBuf(int fd_) : fd(fd_) { buf = (unsigned char*)std::malloc(kBufCap); }
  ~OutBuf() { std::free(buf); }

  bool flush() {
    int64_t off = 0;
    while (off < len) {
      ssize_t n = ::write(fd, buf + off, (size_t)(len - off));
      if (n < 0) {
        if (errno == EINTR) continue;
        error = true;
        return false;
      }
      off += n;
    }
    written += len;
    len = 0;
    return true;
  }
  // Reserve space for an n-byte write. Returns nullptr when n cannot fit
  // even in an empty buffer (caller must fall back to put()) or on a write
  // error during the flush.
  inline unsigned char* reserve(int64_t n) {
    if (len + n > kBufCap) {
      if (!flush()) return nullptr;
      if (n > kBufCap) return nullptr;
    }
    return buf + len;
  }

  // Buffered copy of arbitrary size (chunks through the buffer); the slow
  // path for rows larger than kBufCap.
  bool put(const unsigned char* src, int64_t n) {
    while (n > 0) {
      if (len == kBufCap && !flush()) return false;
      const int64_t c = std::min(n, kBufCap - len);
      std::memcpy(buf + len, src, (size_t)c);
      len += c;
      src += c;
      n -= c;
    }
    return true;
  }
};

// Thread-local staging buffer with cleanup at thread exit (raw thread_local
// pointers leak their allocation every time a short-lived pool thread dies).
struct Stage {
  unsigned char* p = nullptr;
  int64_t cap = 0;
  ~Stage() { std::free(p); }
  unsigned char* ensure(int64_t n) {
    if (cap < n) {
      std::free(p);
      p = (unsigned char*)std::malloc((size_t)n);
      cap = p ? n : 0;
    }
    return p;
  }
};

// Streaming copy with non-temporal stores: the VCF body is written once and
// never read back by the CPU, so bypassing the cache avoids the
// read-for-ownership of every destination line — halving DRAM traffic on
// the multi-GB emit (SURVEY.md §6: emission is the reference's real
// bottleneck). Rows are staged in a cache-resident buffer and flushed here.
inline void stream_copy(unsigned char* dst, const unsigned char* src,
                        int64_t n) {
#ifdef PGEN_HAVE_NT
  // align destination to 16 bytes
  while (n > 0 && ((uintptr_t)dst & 15)) {
    *dst++ = *src++;
    --n;
  }
  while (n >= 64) {
    __m128i a = _mm_loadu_si128((const __m128i*)(src + 0));
    __m128i b = _mm_loadu_si128((const __m128i*)(src + 16));
    __m128i c = _mm_loadu_si128((const __m128i*)(src + 32));
    __m128i d = _mm_loadu_si128((const __m128i*)(src + 48));
    _mm_stream_si128((__m128i*)(dst + 0), a);
    _mm_stream_si128((__m128i*)(dst + 16), b);
    _mm_stream_si128((__m128i*)(dst + 32), c);
    _mm_stream_si128((__m128i*)(dst + 48), d);
    src += 64;
    dst += 64;
    n -= 64;
  }
  if (n) std::memcpy(dst, src, (size_t)n);
  _mm_sfence();
#else
  std::memcpy(dst, src, (size_t)n);
#endif
}

}  // namespace

extern "C" {

// Emit VCF body rows for n_var variants. packed points at the (gathered)
// variant records, rec_size bytes each. prefix_buf/prefix_off give each
// row's leading text (pvar columns + "\tGT"). sample_idx==nullptr means all
// n_samples samples in file order (fast LUT path); otherwise n_samples
// entries of kept sample indices. Returns total bytes written, or -1 on a
// write error.
int64_t pgen_emit_vcf_rows(const unsigned char* packed, int64_t n_var,
                           int64_t rec_size, const unsigned char* prefix_buf,
                           const int64_t* prefix_off,
                           const int32_t* sample_idx, int64_t n_samples,
                           int fd) {
  OutBuf out(fd);
  if (!out.buf) return -1;

  const int64_t full_bytes = n_samples / 4;   // only for the all-samples path
  const int tail = (int)(n_samples % 4);
  const int64_t gt_len =
      sample_idx ? 4 * n_samples : 4 * n_samples;  // 4 text bytes per sample

  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = prefix_off[v + 1] - prefix_off[v];
    const int64_t row_len = plen + gt_len + 1;
    const unsigned char* rec = packed + v * rec_size;
    unsigned char* dst = out.reserve(row_len);
    if (!dst) {
      if (out.error) return -1;
      // Row larger than the buffer: emit it piecewise through put().
      if (!out.put(prefix_buf + prefix_off[v], plen)) return -1;
      if (!sample_idx) {
        for (int64_t j = 0; j < full_bytes; ++j)
          if (!out.put(kLut.t[rec[j]], 16)) return -1;
        if (tail)
          if (!out.put(kLut.t[rec[full_bytes]], 4 * tail)) return -1;
      } else {
        for (int64_t i = 0; i < n_samples; ++i) {
          const int32_t s = sample_idx[i];
          const unsigned char code = kCodes.t[rec[s >> 2]][s & 3];
          if (!out.put(kTok[code], 4)) return -1;
        }
      }
      const unsigned char nl = '\n';
      if (!out.put(&nl, 1)) return -1;
      continue;
    }
    std::memcpy(dst, prefix_buf + prefix_off[v], (size_t)plen);
    dst += plen;
    if (!sample_idx) {
      for (int64_t j = 0; j < full_bytes; ++j) {
        std::memcpy(dst, kLut.t[rec[j]], 16);
        dst += 16;
      }
      if (tail) {
        std::memcpy(dst, kLut.t[rec[full_bytes]], (size_t)(4 * tail));
        dst += 4 * tail;
      }
    } else {
      for (int64_t i = 0; i < n_samples; ++i) {
        const int32_t s = sample_idx[i];
        const unsigned char code = kCodes.t[rec[s >> 2]][s & 3];
        std::memcpy(dst, kTok[code], 4);
        dst += 4;
      }
    }
    *dst++ = '\n';
    out.len += row_len;
  }
  if (!out.flush()) return -1;
  return out.written;
}

// Same row assembly, but into a caller-provided buffer instead of an fd.
// Returns bytes produced, or -1 if cap is too small.
int64_t pgen_emit_vcf_rows_buf(const unsigned char* packed, int64_t n_var,
                               int64_t rec_size,
                               const unsigned char* prefix_buf,
                               const int64_t* prefix_off,
                               const int32_t* sample_idx, int64_t n_samples,
                               unsigned char* out, int64_t cap) {
  const int64_t full_bytes = n_samples / 4;
  const int tail = (int)(n_samples % 4);
  unsigned char* dst = out;
  unsigned char* end = out + cap;
  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = prefix_off[v + 1] - prefix_off[v];
    if (dst + plen + 4 * n_samples + 1 > end) return -1;
    std::memcpy(dst, prefix_buf + prefix_off[v], (size_t)plen);
    dst += plen;
    const unsigned char* rec = packed + v * rec_size;
    if (!sample_idx) {
      for (int64_t j = 0; j < full_bytes; ++j) {
        std::memcpy(dst, kLut.t[rec[j]], 16);
        dst += 16;
      }
      if (tail) {
        std::memcpy(dst, kLut.t[rec[full_bytes]], (size_t)(4 * tail));
        dst += 4 * tail;
      }
    } else {
      for (int64_t i = 0; i < n_samples; ++i) {
        const int32_t s = sample_idx[i];
        const unsigned char code = kCodes.t[rec[s >> 2]][s & 3];
        std::memcpy(dst, kTok[code], 4);
        dst += 4;
      }
    }
    *dst++ = '\n';
  }
  return dst - out;
}

// Fused row emission straight from the metadata buffer: for each kept
// variant v, the row prefix is the raw .pvar line bytes
// [line_starts[v], line_ends[v]) + "\tGT" — no intermediate prefix buffer
// (large temporary allocations pay a kernel page-zeroing tax). Returns
// bytes produced, or -1 if cap is too small.
int64_t pgen_emit_vcf_rows_meta(const unsigned char* packed, int64_t n_var,
                                int64_t rec_size,
                                const unsigned char* meta_buf,
                                const int64_t* line_starts,
                                const int64_t* line_ends,
                                const int32_t* sample_idx, int64_t n_samples,
                                unsigned char* out, int64_t cap) {
  const int64_t full_bytes = n_samples / 4;
  const int tail = (int)(n_samples % 4);
  const int64_t row_max = 4 * n_samples + 4;  // + "\tGT" + "\n" (sans prefix)

  // Rows are built in a cache-resident staging buffer and flushed to `out`
  // with non-temporal stores (see stream_copy).
  constexpr int64_t kStage = 1 << 20;
  static thread_local Stage stage_tls;
  unsigned char* stage = stage_tls.ensure(kStage);
  if (!stage) return -1;
  int64_t slen = 0;
  unsigned char* dst = out;
  unsigned char* const end = out + cap;

  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = line_ends[v] - line_starts[v];
    const int64_t row_len = plen + row_max;
    unsigned char* w;
    bool staged = row_len <= kStage;
    if (staged) {
      if (slen + row_len > kStage) {
        if (dst + slen > end) return -1;
        stream_copy(dst, stage, slen);
        dst += slen;
        slen = 0;
      }
      w = stage + slen;
    } else {
      // pathological row larger than the stage: flush and write direct
      if (slen) {
        if (dst + slen > end) return -1;
        stream_copy(dst, stage, slen);
        dst += slen;
        slen = 0;
      }
      if (dst + row_len > end) return -1;
      w = dst;
    }
    unsigned char* w0 = w;
    std::memcpy(w, meta_buf + line_starts[v], (size_t)plen);
    w += plen;
    *w++ = '\t';
    *w++ = 'G';
    *w++ = 'T';
    const unsigned char* rec = packed + v * rec_size;
    if (!sample_idx) {
      for (int64_t j = 0; j < full_bytes; ++j) {
        std::memcpy(w, kLut.t[rec[j]], 16);
        w += 16;
      }
      if (tail) {
        std::memcpy(w, kLut.t[rec[full_bytes]], (size_t)(4 * tail));
        w += 4 * tail;
      }
    } else {
      for (int64_t i = 0; i < n_samples; ++i) {
        const int32_t s = sample_idx[i];
        const unsigned char code = kCodes.t[rec[s >> 2]][s & 3];
        std::memcpy(w, kTok[code], 4);
        w += 4;
      }
    }
    *w++ = '\n';
    if (staged) {
      slen += w - w0;
      if (dst + slen > end) return -1;  // early overflow check
    } else {
      dst = w;
    }
  }
  if (slen) {
    if (dst + slen > end) return -1;
    stream_copy(dst, stage, slen);
    dst += slen;
  }
  return dst - out;
}

// Sample-subset row emission driven by a per-record-byte keep-mask plan
// (byte_masks[j] bit k set <=> sample 4j+k kept). n_kept must equal the
// total popcount. Staged + NT-stored like pgen_emit_vcf_rows_meta.
int64_t pgen_emit_vcf_rows_masked(const unsigned char* packed, int64_t n_var,
                                  int64_t rec_size,
                                  const unsigned char* meta_buf,
                                  const int64_t* line_starts,
                                  const int64_t* line_ends,
                                  const unsigned char* byte_masks,
                                  int64_t n_kept, unsigned char* out,
                                  int64_t cap) {
  // Rows always build in the staging buffer: the 16-byte LUT copies may
  // overshoot a row's kept width by up to 16 bytes; within the stage that
  // garbage is overwritten by later rows and never leaves (stream_copy
  // copies exactly slen). The stage grows to fit any row + slack.
  constexpr int64_t kSlack = 16;
  const int64_t row_max = 4 * n_kept + 4;
  static thread_local Stage stage_tls;
  int64_t need = (1 << 20);
  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t r = line_ends[v] - line_starts[v] + row_max + kSlack;
    if (r > need) need = r;
  }
  unsigned char* stage = stage_tls.ensure(need);
  if (!stage) return -1;
  const int64_t stage_cap = stage_tls.cap;
  int64_t slen = 0;
  unsigned char* dst = out;
  unsigned char* const end = out + cap;

  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = line_ends[v] - line_starts[v];
    if (slen + plen + row_max + kSlack > stage_cap) {
      if (dst + slen > end) return -1;
      stream_copy(dst, stage, slen);
      dst += slen;
      slen = 0;
    }
    unsigned char* w = stage + slen;
    unsigned char* const w0 = w;
    std::memcpy(w, meta_buf + line_starts[v], (size_t)plen);
    w += plen;
    *w++ = '\t';
    *w++ = 'G';
    *w++ = 'T';
    const unsigned char* rec = packed + v * rec_size;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char m = byte_masks[j];
      // one 16-byte store pair regardless of popcount; advance by the kept
      // width (trailing garbage stays inside the stage slack)
      std::memcpy(w, kLutM.t[m][rec[j]], 16);
      w += kLutM.n[m];
    }
    *w++ = '\n';
    slen += w - w0;
    if (dst + slen > end) return -1;
  }
  if (slen) {
    if (dst + slen > end) return -1;
    stream_copy(dst, stage, slen);
    dst += slen;
  }
  return dst - out;
}

// Assemble rows from an already-produced GT text matrix (device kernel
// output): row := prefix + gt_text_row (gt_len bytes) + '\n'. Returns bytes
// produced, or -1 if cap is too small.
int64_t pgen_assemble_rows_buf(const unsigned char* gt_text, int64_t gt_len,
                               int64_t n_var,
                               const unsigned char* prefix_buf,
                               const int64_t* prefix_off, unsigned char* out,
                               int64_t cap) {
  unsigned char* dst = out;
  unsigned char* end = out + cap;
  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = prefix_off[v + 1] - prefix_off[v];
    if (dst + plen + gt_len + 1 > end) return -1;
    std::memcpy(dst, prefix_buf + prefix_off[v], (size_t)plen);
    dst += plen;
    std::memcpy(dst, gt_text + v * gt_len, (size_t)gt_len);
    dst += gt_len;
    *dst++ = '\n';
  }
  return dst - out;
}

// Assemble rows from FOUR text-word planes (device plane-form output:
// plane k lane j = u32 text word of sample 4j+k — the interleaved layout
// is a relayout TPU materialization pays ~10x for, so the device emits
// planes and the interleave happens here, a sequential 4-stream merge).
// gt_len = bytes of genotype text per row (4 * n_kept_samples);
// plane_words = u32 lanes per plane row (>= ceil(gt_len/16)).
int64_t pgen_assemble_rows_planes(const uint32_t* t0, const uint32_t* t1,
                                  const uint32_t* t2, const uint32_t* t3,
                                  int64_t plane_words, int64_t gt_len,
                                  int64_t n_var,
                                  const unsigned char* prefix_buf,
                                  const int64_t* prefix_off,
                                  unsigned char* out, int64_t cap) {
  unsigned char* dst = out;
  unsigned char* end = out + cap;
  const int64_t full = gt_len / 16;        // whole 16-byte groups (4 samples)
  const int64_t tail = gt_len - full * 16; // remaining bytes (1-3 samples + part)
  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t plen = prefix_off[v + 1] - prefix_off[v];
    if (dst + plen + gt_len + 1 > end) return -1;
    std::memcpy(dst, prefix_buf + prefix_off[v], (size_t)plen);
    dst += plen;
    const uint32_t* p0 = t0 + v * plane_words;
    const uint32_t* p1 = t1 + v * plane_words;
    const uint32_t* p2 = t2 + v * plane_words;
    const uint32_t* p3 = t3 + v * plane_words;
    int64_t j = 0;
#if defined(__SSE2__)
    for (; j + 4 <= full; j += 4) {
      // 4x4 u32 transpose: four 16-byte loads -> four interleaved stores
      __m128i a = _mm_loadu_si128((const __m128i*)(p0 + j));
      __m128i b = _mm_loadu_si128((const __m128i*)(p1 + j));
      __m128i c = _mm_loadu_si128((const __m128i*)(p2 + j));
      __m128i d = _mm_loadu_si128((const __m128i*)(p3 + j));
      __m128i ab_lo = _mm_unpacklo_epi32(a, b);  // a0 b0 a1 b1
      __m128i ab_hi = _mm_unpackhi_epi32(a, b);  // a2 b2 a3 b3
      __m128i cd_lo = _mm_unpacklo_epi32(c, d);  // c0 d0 c1 d1
      __m128i cd_hi = _mm_unpackhi_epi32(c, d);  // c2 d2 c3 d3
      _mm_storeu_si128((__m128i*)(dst + 0), _mm_unpacklo_epi64(ab_lo, cd_lo));
      _mm_storeu_si128((__m128i*)(dst + 16), _mm_unpackhi_epi64(ab_lo, cd_lo));
      _mm_storeu_si128((__m128i*)(dst + 32), _mm_unpacklo_epi64(ab_hi, cd_hi));
      _mm_storeu_si128((__m128i*)(dst + 48), _mm_unpackhi_epi64(ab_hi, cd_hi));
      dst += 64;
    }
#endif
    for (; j < full; ++j) {
      uint32_t w[4] = {p0[j], p1[j], p2[j], p3[j]};
      std::memcpy(dst, w, 16);
      dst += 16;
    }
    if (tail) {
      uint32_t w[4] = {p0[full], p1[full], p2[full], p3[full]};
      std::memcpy(dst, w, (size_t)tail);
      dst += tail;
    }
    *dst++ = '\n';
  }
  return dst - out;
}

// Extract a metadata column into a zero-padded (rows, width) u8 matrix:
// out[i, :lens[i]] = buf[starts[i] : starts[i]+lens[i]], rest zeros.
// Replaces a numpy fancy-index gather that builds a rows*width int64
// index matrix (the query path's hot spot at chr22 scale).
void pgen_extract_column(const unsigned char* buf, const int64_t* starts,
                         const int64_t* lens, int64_t n_rows, int64_t width,
                         unsigned char* out) {
  std::memset(out, 0, (size_t)(n_rows * width));
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + i * width, buf + starts[i], (size_t)lens[i]);
  }
}

// Single-pass SIMD scan for metadata separators: counts '\t' and '\n' in
// buf (pgen_count_seps) and fills their positions (pgen_fill_seps). The
// columnar .pvar/.psam loader is bound by this scan on chr22-scale files.
void pgen_count_seps(const unsigned char* buf, int64_t n, int64_t* n_tabs,
                     int64_t* n_nls, int64_t* n_crs) {
  int64_t tabs = 0, nls = 0, crs = 0;
  int64_t i = 0;
#if defined(__AVX512BW__)
  // 64 B/iter with mask registers: compare-to-mask + popcount, no
  // per-byte accumulators or overflow flushes needed.
  const __m512i wt = _mm512_set1_epi8('\t');
  const __m512i wn = _mm512_set1_epi8('\n');
  const __m512i wr = _mm512_set1_epi8('\r');
  for (; i + 64 <= n; i += 64) {
    __m512i x = _mm512_loadu_si512((const void*)(buf + i));
    tabs += (int64_t)__builtin_popcountll(_mm512_cmpeq_epi8_mask(x, wt));
    nls += (int64_t)__builtin_popcountll(_mm512_cmpeq_epi8_mask(x, wn));
    crs += (int64_t)__builtin_popcountll(_mm512_cmpeq_epi8_mask(x, wr));
  }
#elif defined(PGEN_HAVE_NT)
  const __m128i vt = _mm_set1_epi8('\t');
  const __m128i vn = _mm_set1_epi8('\n');
  const __m128i vr = _mm_set1_epi8('\r');
  __m128i acc_t = _mm_setzero_si128(), acc_n = _mm_setzero_si128(),
          acc_r = _mm_setzero_si128();
  int inner = 0;
  const __m128i z = _mm_setzero_si128();
  auto flush = [&]() {
    tabs += _mm_cvtsi128_si64(_mm_sad_epu8(acc_t, z)) +
            _mm_extract_epi16(_mm_sad_epu8(acc_t, z), 4);
    nls += _mm_cvtsi128_si64(_mm_sad_epu8(acc_n, z)) +
           _mm_extract_epi16(_mm_sad_epu8(acc_n, z), 4);
    crs += _mm_cvtsi128_si64(_mm_sad_epu8(acc_r, z)) +
           _mm_extract_epi16(_mm_sad_epu8(acc_r, z), 4);
    acc_t = acc_n = acc_r = _mm_setzero_si128();
    inner = 0;
  };
  for (; i + 16 <= n; i += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(buf + i));
    // cmpeq gives 0xFF per match; subtract to accumulate per-byte counts
    acc_t = _mm_sub_epi8(acc_t, _mm_cmpeq_epi8(x, vt));
    acc_n = _mm_sub_epi8(acc_n, _mm_cmpeq_epi8(x, vn));
    acc_r = _mm_sub_epi8(acc_r, _mm_cmpeq_epi8(x, vr));
    if (++inner == 255) flush();  // before per-byte counters overflow
  }
  flush();
#endif
  for (; i < n; ++i) {
    tabs += buf[i] == '\t';
    nls += buf[i] == '\n';
    crs += buf[i] == '\r';
  }
  *n_tabs = tabs;
  *n_nls = nls;
  *n_crs = crs;
}

void pgen_fill_seps(const unsigned char* buf, int64_t n, int64_t* tab_out,
                    int64_t* nl_out) {
  int64_t i = 0;
#if defined(__AVX512BW__)
  const __m512i wt = _mm512_set1_epi8('\t');
  const __m512i wn = _mm512_set1_epi8('\n');
  for (; i + 64 <= n; i += 64) {
    __m512i x = _mm512_loadu_si512((const void*)(buf + i));
    unsigned long long mt = _mm512_cmpeq_epi8_mask(x, wt);
    unsigned long long mn = _mm512_cmpeq_epi8_mask(x, wn);
    while (mt) {
      *tab_out++ = i + __builtin_ctzll(mt);
      mt &= mt - 1;
    }
    while (mn) {
      *nl_out++ = i + __builtin_ctzll(mn);
      mn &= mn - 1;
    }
  }
#elif defined(PGEN_HAVE_NT)
  const __m128i vt = _mm_set1_epi8('\t');
  const __m128i vn = _mm_set1_epi8('\n');
  for (; i + 16 <= n; i += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(buf + i));
    unsigned mt = (unsigned)_mm_movemask_epi8(_mm_cmpeq_epi8(x, vt));
    unsigned mn = (unsigned)_mm_movemask_epi8(_mm_cmpeq_epi8(x, vn));
    while (mt) {
      *tab_out++ = i + __builtin_ctz(mt);
      mt &= mt - 1;
    }
    while (mn) {
      *nl_out++ = i + __builtin_ctz(mn);
      mn &= mn - 1;
    }
  }
#endif
  for (; i < n; ++i) {
    if (buf[i] == '\t') *tab_out++ = i;
    if (buf[i] == '\n') *nl_out++ = i;
  }
}

// Parallel position fill: counts the first half (cheap compare-to-mask
// pass) to find each half's output offsets, then fills both halves
// concurrently — the fill is bound by the position-array writes, which
// split cleanly across cores. Second-half positions are shifted by mid.
void pgen_fill_seps_par(const unsigned char* buf, int64_t n,
                        int64_t* tab_out, int64_t* nl_out) {
  if (n < (8 << 20)) {  // small files: threading overhead dominates
    pgen_fill_seps(buf, n, tab_out, nl_out);
    return;
  }
  const int64_t mid = n / 2;
  int64_t t0 = 0, l0 = 0, c0 = 0, t1 = 0, l1 = 0, c1 = 0;
  pgen_count_seps(buf, mid, &t0, &l0, &c0);
  std::thread th([&] { pgen_fill_seps(buf, mid, tab_out, nl_out); });
  int64_t* tab_hi = tab_out + t0;
  int64_t* nl_hi = nl_out + l0;
  pgen_fill_seps(buf + mid, n - mid, tab_hi, nl_hi);
  pgen_count_seps(buf + mid, n - mid, &t1, &l1, &c1);
  for (int64_t k = 0; k < t1; ++k) tab_hi[k] += mid;
  for (int64_t k = 0; k < l1; ++k) nl_hi[k] += mid;
  th.join();
}

// Per-variant 2-bit code histogram: counts[v*4+k] = #samples with code k.
// One pass over the packed bytes via a 256->4-counts LUT; pad positions in
// the last byte are excluded.
namespace {
struct LutCounts {
  unsigned char t[256][4];
  LutCounts() {
    for (int b = 0; b < 256; ++b)
      for (int p = 0; p < 4; ++p) ++t[b][(b >> (2 * p)) & 3];
  }
};
const LutCounts kCnt;
}  // namespace

void pgen_gt_counts(const unsigned char* packed, int64_t n_var,
                    int64_t rec_size, int64_t n_samples, int64_t* counts) {
  const int pad = (int)(4 * rec_size - n_samples);
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    int64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char* e = kCnt.t[rec[j]];
      c0 += e[0];
      c1 += e[1];
      c2 += e[2];
      c3 += e[3];
    }
    if (pad) {
      const unsigned char last = rec[rec_size - 1];
      for (int p = 4 - pad; p < 4; ++p) {
        switch ((last >> (2 * p)) & 3) {
          case 0: --c0; break;
          case 1: --c1; break;
          case 2: --c2; break;
          default: --c3; break;
        }
      }
    }
    int64_t* o = counts + v * 4;
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
    o[3] = c3;
  }
}

// Masked variant of pgen_gt_counts: only samples whose bit is set in the
// per-record-byte keep mask are counted (mask bits never cover pad
// positions, so no pad correction is needed).
namespace {
struct LutCountsMasked {
  unsigned char t[16][256][4];
  LutCountsMasked() {
    for (int m = 0; m < 16; ++m)
      for (int b = 0; b < 256; ++b)
        for (int p = 0; p < 4; ++p)
          if (m & (1 << p)) ++t[m][b][(b >> (2 * p)) & 3];
  }
};
const LutCountsMasked kCntM;
}  // namespace

void pgen_gt_counts_masked(const unsigned char* packed, int64_t n_var,
                           int64_t rec_size, const unsigned char* byte_masks,
                           int64_t* counts) {
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    int64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char* e = kCntM.t[byte_masks[j]][rec[j]];
      c0 += e[0];
      c1 += e[1];
      c2 += e[2];
      c3 += e[3];
    }
    int64_t* o = counts + v * 4;
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
    o[3] = c3;
  }
}

// Variant-parallel wrappers: rows are independent, so split the variant
// range across two threads (GT_* predicate queries and `stats` walk the
// whole packed matrix through these).
void pgen_gt_counts_par(const unsigned char* packed, int64_t n_var,
                        int64_t rec_size, int64_t n_samples,
                        int64_t* counts) {
  if (n_var * rec_size < (16 << 20)) {
    pgen_gt_counts(packed, n_var, rec_size, n_samples, counts);
    return;
  }
  const int64_t mid = n_var / 2;
  std::thread th(
      [&] { pgen_gt_counts(packed, mid, rec_size, n_samples, counts); });
  pgen_gt_counts(packed + mid * rec_size, n_var - mid, rec_size, n_samples,
                 counts + mid * 4);
  th.join();
}

void pgen_gt_counts_masked_par(const unsigned char* packed, int64_t n_var,
                               int64_t rec_size,
                               const unsigned char* byte_masks,
                               int64_t* counts) {
  if (n_var * rec_size < (16 << 20)) {
    pgen_gt_counts_masked(packed, n_var, rec_size, byte_masks, counts);
    return;
  }
  const int64_t mid = n_var / 2;
  std::thread th([&] {
    pgen_gt_counts_masked(packed, mid, rec_size, byte_masks, counts);
  });
  pgen_gt_counts_masked(packed + mid * rec_size, n_var - mid, rec_size,
                        byte_masks, counts + mid * 4);
  th.join();
}

// Extract an INFO subfield per row: within each field span, find the
// ';'-separated segment "KEY=value" (value span returned) or bare "KEY"
// (flag, len=-2); absent keys get len=-1. First occurrence wins.
void pgen_info_extract(const unsigned char* buf, const char* starts,
                       int64_t s_stride, const char* ends, int64_t e_stride,
                       int64_t n, const unsigned char* key, int64_t keylen,
                       int64_t* val_starts, int64_t* val_lens) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = *(const int64_t*)(starts + i * s_stride);
    const int64_t e = *(const int64_t*)(ends + i * e_stride);
    int64_t vs = 0, vl = -1;
    int64_t pos = s;
    while (pos < e) {
      const unsigned char* semi = (const unsigned char*)std::memchr(
          buf + pos, ';', (size_t)(e - pos));
      const int64_t seg_end = semi ? (int64_t)(semi - buf) : e;
      if (seg_end - pos >= keylen &&
          std::memcmp(buf + pos, key, (size_t)keylen) == 0) {
        if (pos + keylen == seg_end) {
          vl = -2;  // flag
          break;
        }
        if (buf[pos + keylen] == '=') {
          vs = pos + keylen + 1;
          vl = seg_end - vs;
          break;
        }
      }
      pos = seg_end + 1;
    }
    val_starts[i] = vs;
    val_lens[i] = vl;
  }
}

// Join fixed-width rows into newline-separated output: row i contributes
// lens[i] bytes of mat[i*width..] then '\n'. Returns bytes produced.
int64_t pgen_join_lines(const unsigned char* mat, int64_t n, int64_t width,
                        const int32_t* lens, unsigned char* out,
                        int64_t cap) {
  unsigned char* dst = out;
  unsigned char* const end = out + cap;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = lens[i];
    if (dst + len + 1 > end) return -1;
    std::memcpy(dst, mat + i * width, (size_t)len);
    dst += len;
    *dst++ = '\n';
  }
  return dst - out;
}

// Vectorized column == literal over the raw metadata buffer: one pass of
// length-check + memcmp per row. starts/ends are int64 arrays with
// arbitrary byte strides (they may be strided views of the tab index).
void pgen_column_equals(const unsigned char* buf, const char* starts,
                        int64_t s_stride, const char* ends, int64_t e_stride,
                        int64_t n, const unsigned char* lit, int64_t litlen,
                        unsigned char* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = *(const int64_t*)(starts + i * s_stride);
    const int64_t e = *(const int64_t*)(ends + i * e_stride);
    out[i] = (e - s == litlen) &&
             std::memcmp(buf + s, lit, (size_t)litlen) == 0;
  }
}

// Unpack n_var records into a (n_var, n_samples) u8 code matrix.
void pgen_unpack_codes(const unsigned char* packed, int64_t n_var,
                       int64_t rec_size, int64_t n_samples,
                       unsigned char* codes) {
  const int64_t full = n_samples / 4;
  const int tail = (int)(n_samples % 4);
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    unsigned char* dst = codes + v * n_samples;
    for (int64_t j = 0; j < full; ++j) {
      std::memcpy(dst + 4 * j, kCodes.t[rec[j]], 4);
    }
    if (tail) std::memcpy(dst + 4 * full, kCodes.t[rec[full]], (size_t)tail);
  }
}

// GLM masked moments, sparse-complement form (ops/glm.py native path).
// Realistic genotype data is overwhelmingly hom-ref (code 0), and the
// per-variant complete-case moment sums decompose so that ONLY
// non-hom-ref samples cost work:
//     n      = n_kept - #missing
//     M @ P  = colsum_kept(P) - sum_{missing} P[s]
//     G @ Q  = sum_{het} Q[s] + 2 sum_{hom} Q[s]
//     sum g  = #het + 2 #hom ;   sum g^2 = #het + 4 #hom
// A zero record byte (four hom-ref calls) is skipped outright, so a
// rare variant costs a memchr-speed scan plus a handful of f64 adds —
// vs the dense provider's full (bv, S) f64 materialization + dgemm.
// pcols/qcols are FULL-S row-major with zero rows for dropped samples;
// keep[s] gates subset cohorts; ptot = column sums of pcols over KEPT
// samples. Pad bits are guarded by the n_samples bound.
void pgen_glm_moments(const unsigned char* packed, int64_t n_var,
                      int64_t rec_size, int64_t n_samples,
                      const unsigned char* keep, const double* pcols,
                      int64_t np_, const double* qcols, int64_t nq,
                      const double* ptot, double n_kept, double* n_out,
                      double* mp, double* gq, double* sg, double* sg2) {
  std::vector<double> het((size_t)nq), hom((size_t)nq);
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    double* mpo = mp + v * np_;
    std::memcpy(mpo, ptot, (size_t)np_ * sizeof(double));
    std::fill(het.begin(), het.end(), 0.0);
    std::fill(hom.begin(), hom.end(), 0.0);
    double nm = 0.0, nhet = 0.0, nhom = 0.0;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char b = rec[j];
      if (!b) continue;
      const int64_t base = 4 * j;
      const int lim = (int)(base + 4 <= n_samples ? 4 : n_samples - base);
      for (int p = 0; p < lim; ++p) {
        const int code = (b >> (2 * p)) & 3;
        if (!code) continue;
        const int64_t s = base + p;
        if (!keep[s]) continue;
        if (code == 3) {
          const double* pr = pcols + s * np_;
          for (int64_t c = 0; c < np_; ++c) mpo[c] -= pr[c];
          nm += 1.0;
        } else {
          const double* q = qcols + s * nq;
          double* acc = (code == 1) ? het.data() : hom.data();
          for (int64_t c = 0; c < nq; ++c) acc[c] += q[c];
          if (code == 1) nhet += 1.0; else nhom += 1.0;
        }
      }
    }
    double* gqo = gq + v * nq;
    for (int64_t c = 0; c < nq; ++c) gqo[c] = het[c] + 2.0 * hom[c];
    n_out[v] = n_kept - nm;
    sg[v] = nhet + 2.0 * nhom;
    sg2[v] = nhet + 4.0 * nhom;
  }
}

// Modifier-design (het/hom indicator) variant of pgen_glm_moments:
// same sparse-complement decomposition, but the het and hom column
// sums stay SEPARATE (ops/glm.py GlmGenoMoments) so any (het, hom)
// recode — dominant/recessive/genotypic/hethom — derives from them.
// qcols here is the q2 = [1, y, C] block; hetq/homq are (V, K).
void pgen_glm_geno_moments(const unsigned char* packed, int64_t n_var,
                           int64_t rec_size, int64_t n_samples,
                           const unsigned char* keep, const double* pcols,
                           int64_t np_, const double* qcols, int64_t nq,
                           const double* ptot, double n_kept, double* n_out,
                           double* mp, double* hetq, double* homq) {
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    double* mpo = mp + v * np_;
    double* heto = hetq + v * nq;
    double* homo = homq + v * nq;
    std::memcpy(mpo, ptot, (size_t)np_ * sizeof(double));
    std::memset(heto, 0, (size_t)nq * sizeof(double));
    std::memset(homo, 0, (size_t)nq * sizeof(double));
    double nm = 0.0;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char b = rec[j];
      if (!b) continue;
      const int64_t base = 4 * j;
      const int lim = (int)(base + 4 <= n_samples ? 4 : n_samples - base);
      for (int p = 0; p < lim; ++p) {
        const int code = (b >> (2 * p)) & 3;
        if (!code) continue;
        const int64_t s = base + p;
        if (!keep[s]) continue;
        if (code == 3) {
          const double* pr = pcols + s * np_;
          for (int64_t c = 0; c < np_; ++c) mpo[c] -= pr[c];
          nm += 1.0;
        } else {
          const double* q = qcols + s * nq;
          double* acc = (code == 1) ? heto : homo;
          for (int64_t c = 0; c < nq; ++c) acc[c] += q[c];
        }
      }
    }
    n_out[v] = n_kept - nm;
  }
}

void pgen_glm_geno_moments_par(const unsigned char* packed, int64_t n_var,
                               int64_t rec_size, int64_t n_samples,
                               const unsigned char* keep,
                               const double* pcols, int64_t np_,
                               const double* qcols, int64_t nq,
                               const double* ptot, double n_kept,
                               double* n_out, double* mp, double* hetq,
                               double* homq) {
  if (n_var * rec_size < (16 << 20)) {
    pgen_glm_geno_moments(packed, n_var, rec_size, n_samples, keep, pcols,
                          np_, qcols, nq, ptot, n_kept, n_out, mp, hetq,
                          homq);
    return;
  }
  const int64_t mid = n_var / 2;
  std::thread th([&] {
    pgen_glm_geno_moments(packed, mid, rec_size, n_samples, keep, pcols,
                          np_, qcols, nq, ptot, n_kept, n_out, mp, hetq,
                          homq);
  });
  pgen_glm_geno_moments(packed + mid * rec_size, n_var - mid, rec_size,
                        n_samples, keep, pcols, np_, qcols, nq, ptot, n_kept,
                        n_out + mid, mp + mid * np_, hetq + mid * nq,
                        homq + mid * nq);
  th.join();
}

void pgen_glm_moments_par(const unsigned char* packed, int64_t n_var,
                          int64_t rec_size, int64_t n_samples,
                          const unsigned char* keep, const double* pcols,
                          int64_t np_, const double* qcols, int64_t nq,
                          const double* ptot, double n_kept, double* n_out,
                          double* mp, double* gq, double* sg, double* sg2) {
  if (n_var * rec_size < (16 << 20)) {
    pgen_glm_moments(packed, n_var, rec_size, n_samples, keep, pcols, np_,
                     qcols, nq, ptot, n_kept, n_out, mp, gq, sg, sg2);
    return;
  }
  const int64_t mid = n_var / 2;
  std::thread th([&] {
    pgen_glm_moments(packed, mid, rec_size, n_samples, keep, pcols, np_,
                     qcols, nq, ptot, n_kept, n_out, mp, gq, sg, sg2);
  });
  pgen_glm_moments(packed + mid * rec_size, n_var - mid, rec_size, n_samples,
                   keep, pcols, np_, qcols, nq, ptot, n_kept, n_out + mid,
                   mp + mid * np_, gq + mid * nq, sg + mid, sg2 + mid);
  th.join();
}

// Polygenic-score accumulation, sparse-complement form (ops/score.py
// native path). For a NON-flipped variant only het/hom/missing samples
// contribute (hom-ref dosage is 0); for a FLIPPED variant (effect
// allele = REF, d = 2 - g on called samples) the bulk contribution is
// a per-variant constant 2*w added to EVERY kept sample — accumulated
// once into `base` (the caller broadcasts it) — plus sparse
// corrections: het -1*w, hom -2*w, missing (-2 + mean_d)*w with mean
// imputation or -2*w without. waug carries K+1 columns (the trailing
// ones column yields the per-sample dosage sums for free). miss_ct
// counts kept-sample missing calls in USED (>=1 called) variants, from
// which the caller derives the no-imputation allele denominators.
void pgen_score_moments(const unsigned char* packed, int64_t n_var,
                        int64_t rec_size, int64_t n_samples,
                        const unsigned char* keep, const unsigned char* flip,
                        const double* waug, int64_t kk, int mean_impute,
                        int64_t n_kept, double* sums, int64_t* miss_ct,
                        double* base, int64_t* m_used) {
  int64_t used = 0;
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    // pass 1: class counts over kept samples (rows are L1-resident, so
    // the second pass below re-reads them for free)
    int64_t nhet = 0, nhom = 0, nmiss = 0;
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char b = rec[j];
      if (!b) continue;
      const int64_t bbase = 4 * j;
      const int lim = (int)(bbase + 4 <= n_samples ? 4 : n_samples - bbase);
      for (int p = 0; p < lim; ++p) {
        const int code = (b >> (2 * p)) & 3;
        if (!code || !keep[bbase + p]) continue;
        if (code == 1) ++nhet;
        else if (code == 2) ++nhom;
        else ++nmiss;
      }
    }
    const int64_t n_called = n_kept - nmiss;
    if (n_called <= 0) continue;  // unused variant: contributes nothing
    ++used;
    const double* wv = waug + v * kk;
    const bool fl = flip[v] != 0;
    const double mean_g = (double)(nhet + 2 * nhom) / (double)n_called;
    // per-class coefficients relative to the (flip ? 2 : 0) base
    const double c_het = fl ? -1.0 : 1.0;
    const double c_hom = fl ? -2.0 : 2.0;
    const double c_mis =
        mean_impute ? (fl ? -mean_g : mean_g) : (fl ? -2.0 : 0.0);
    if (fl)
      for (int64_t c = 0; c < kk; ++c) base[c] += 2.0 * wv[c];
    for (int64_t j = 0; j < rec_size; ++j) {
      const unsigned char b = rec[j];
      if (!b) continue;
      const int64_t bbase = 4 * j;
      const int lim = (int)(bbase + 4 <= n_samples ? 4 : n_samples - bbase);
      for (int p = 0; p < lim; ++p) {
        const int code = (b >> (2 * p)) & 3;
        if (!code) continue;
        const int64_t s = bbase + p;
        if (!keep[s]) continue;
        double coef;
        if (code == 1) coef = c_het;
        else if (code == 2) coef = c_hom;
        else { coef = c_mis; ++miss_ct[s]; }
        if (coef != 0.0) {
          double* o = sums + s * kk;
          for (int64_t c = 0; c < kk; ++c) o[c] += coef * wv[c];
        }
      }
    }
  }
  *m_used += used;
}

void pgen_score_moments_par(const unsigned char* packed, int64_t n_var,
                            int64_t rec_size, int64_t n_samples,
                            const unsigned char* keep,
                            const unsigned char* flip, const double* waug,
                            int64_t kk, int mean_impute, int64_t n_kept,
                            double* sums, int64_t* miss_ct, double* base,
                            int64_t* m_used) {
  if (n_var * rec_size < (16 << 20)) {
    pgen_score_moments(packed, n_var, rec_size, n_samples, keep, flip, waug,
                       kk, mean_impute, n_kept, sums, miss_ct, base, m_used);
    return;
  }
  // sums/miss_ct/base are shared accumulators: give the second thread
  // its own buffers and reduce after the join
  const int64_t mid = n_var / 2;
  std::vector<double> sums2((size_t)(n_samples * kk), 0.0);
  std::vector<int64_t> miss2((size_t)n_samples, 0);
  std::vector<double> base2((size_t)kk, 0.0);
  int64_t used2 = 0;
  std::thread th([&] {
    pgen_score_moments(packed + mid * rec_size, n_var - mid, rec_size,
                       n_samples, keep, flip + mid, waug + mid * kk, kk,
                       mean_impute, n_kept, sums2.data(), miss2.data(),
                       base2.data(), &used2);
  });
  pgen_score_moments(packed, mid, rec_size, n_samples, keep, flip, waug, kk,
                     mean_impute, n_kept, sums, miss_ct, base, m_used);
  th.join();
  for (int64_t i = 0; i < n_samples * kk; ++i) sums[i] += sums2[(size_t)i];
  for (int64_t i = 0; i < n_samples; ++i) miss_ct[i] += miss2[(size_t)i];
  for (int64_t c = 0; c < kk; ++c) base[c] += base2[(size_t)c];
  *m_used += used2;
}

// Pack a (n_var, n_samples) u8 code matrix into mode-0x02 records.
void pgen_pack_codes(const unsigned char* codes, int64_t n_var,
                     int64_t n_samples, unsigned char* packed) {
  const int64_t rec_size = (2 * n_samples + 7) / 8;
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* src = codes + v * n_samples;
    unsigned char* rec = packed + v * rec_size;
    std::memset(rec, 0, (size_t)rec_size);
    for (int64_t s = 0; s < n_samples; ++s) {
      rec[s >> 2] |= (unsigned char)((src[s] & 3) << ((s & 3) * 2));
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BGZF (.vcf.gz) output: blocked gzip per the SAM/BGZF spec — each block is
// an independent gzip member (<=65280 input bytes) carrying a BC extra field
// with the compressed block size, so bcftools/tabix can random-access it.
// Blocks are independent, so callers parallelize by compressing separate
// text chunks on separate threads and concatenating in order.
// ---------------------------------------------------------------------------

#include <zlib.h>
#ifdef PGEN_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {
constexpr int64_t kBgzfChunk = 65280;

// worst case for one block: stored deflate (~5B/16KB + 26B framing)
inline int64_t bgzf_bound(int64_t n) { return n + (n >> 10) + 64; }

// Raw-deflate one chunk; returns compressed length or -1.
inline int64_t deflate_chunk(const unsigned char* in, int64_t n,
                             unsigned char* out, int64_t cap, int level,
                             uint32_t* crc_out) {
#ifdef PGEN_HAVE_LIBDEFLATE
  // RAII holder so each pool thread's compressor is freed at thread exit.
  struct CompTls {
    libdeflate_compressor* c = nullptr;
    int level = -1;
    ~CompTls() {
      if (c) libdeflate_free_compressor(c);
    }
  };
  static thread_local CompTls tls;
  if (!tls.c || tls.level != level) {
    if (tls.c) libdeflate_free_compressor(tls.c);
    tls.c = libdeflate_alloc_compressor(level);
    tls.level = level;
  }
  libdeflate_compressor* comp = tls.c;
  if (!comp) return -1;
  const size_t clen =
      libdeflate_deflate_compress(comp, in, (size_t)n, out, (size_t)cap);
  if (clen == 0) return -1;
  *crc_out = (uint32_t)libdeflate_crc32(0, in, (size_t)n);
  return (int64_t)clen;
#else
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK)
    return -1;
  zs.next_in = const_cast<unsigned char*>(in);
  zs.avail_in = (uInt)n;
  zs.next_out = out;
  zs.avail_out = (uInt)cap;
  const int rc = deflate(&zs, Z_FINISH);
  const int64_t clen = (int64_t)zs.total_out;
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return -1;
  *crc_out = (uint32_t)crc32(crc32(0L, Z_NULL, 0), in, (uInt)n);
  return clen;
#endif
}
}  // namespace

extern "C" {

// Compress `n` bytes into BGZF blocks. Returns bytes written, or -1 on
// error / insufficient cap. cap should be >= pgen_bgzf_bound(n).
int64_t pgen_bgzf_compress(const unsigned char* in, int64_t n,
                           unsigned char* out, int64_t cap, int level) {
  unsigned char* dst = out;
  unsigned char* const end = out + cap;
  int64_t off = 0;
  while (off < n) {
    const int64_t chunk = n - off < kBgzfChunk ? n - off : kBgzfChunk;
    if (dst + bgzf_bound(chunk) > end) return -1;
    unsigned char* const hdr = dst;
    // gzip header with FEXTRA + BC subfield (BSIZE filled after deflate)
    const unsigned char ghdr[18] = {0x1f, 0x8b, 8,    4,    0, 0, 0, 0, 0,
                                    0xff, 6,    0,    'B',  'C', 2, 0, 0, 0};
    std::memcpy(hdr, ghdr, 18);
    uint32_t crc = 0;
    const int64_t clen = deflate_chunk(in + off, chunk, hdr + 18,
                                       end - (hdr + 18), level, &crc);
    if (clen < 0) return -1;
    const int64_t bsize = 18 + clen + 8;  // header + data + crc/isize
    if (bsize > 65536) return -1;
    hdr[16] = (unsigned char)((bsize - 1) & 0xff);
    hdr[17] = (unsigned char)(((bsize - 1) >> 8) & 0xff);
    unsigned char* tail = hdr + 18 + clen;
    tail[0] = crc & 0xff;
    tail[1] = (crc >> 8) & 0xff;
    tail[2] = (crc >> 16) & 0xff;
    tail[3] = (crc >> 24) & 0xff;
    tail[4] = chunk & 0xff;
    tail[5] = (chunk >> 8) & 0xff;
    tail[6] = (chunk >> 16) & 0xff;
    tail[7] = (chunk >> 24) & 0xff;
    dst = tail + 8;
    off += chunk;
  }
  return dst - out;
}

// Upper bound on pgen_bgzf_compress output size for n input bytes.
int64_t pgen_bgzf_bound(int64_t n) {
  const int64_t blocks = n / kBgzfChunk + 2;
  return n + blocks * 96 + (n >> 9) + 64;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// VCF -> PGEN import parse: the reverse of the emission path. One pass over
// a newline-terminated span of VCF data rows produces (a) the packed 2-bit
// records (4 hard calls/byte, LSB-first — the C10 geometry, pfile.rs:171-183)
// and (b) the .pvar row bytes (each row's first 8 fields, span-copied so the
// text round-trips exactly). The reference has no VCF input at all.
// ---------------------------------------------------------------------------

namespace {

// Parse the leading GT token of a sample field at p (avail bytes before the
// row's '\n'). Returns code 0..3 and sets *adv to the token length (1 or 3),
// or returns 255 for unsupported/malformed tokens. Grammar (kept in exact
// agreement with the vectorized numpy parser in pipeline/vcf_import.py):
// a lone '.', or a{/|}b with a,b in {0,1,.}; any '.' allele -> missing
// (plink2 hard-call semantics). Phased '|' imports as the unphased code.
// Per-byte GT-allele classifier: '0'->0, '1'->1, '.'->0x10 (missing flag),
// anything else 0xFF. Lets the hot loop resolve a plain 3-byte token plus
// its terminator with one predictable branch (see import_span).
struct GtByte {
  unsigned char t[256];
  GtByte() {
    std::memset(t, 0xFF, sizeof(t));
    t[(unsigned char)'0'] = 0;
    t[(unsigned char)'1'] = 1;
    t[(unsigned char)'.'] = 0x10;
  }
};
const GtByte kGtByte;

inline unsigned parse_gt(const unsigned char* p, int64_t avail, int* adv) {
  const unsigned char b0 = p[0];
  const bool pairable =
      avail >= 3 && (p[1] == '/' || p[1] == '|') &&
      (p[2] == '0' || p[2] == '1' || p[2] == '.');
  if (b0 == '.') {
    if (pairable) {
      *adv = 3;
      return 3;
    }
    *adv = 1;
    return 3;  // lone '.'; the caller validates the terminator
  }
  if ((b0 == '0' || b0 == '1') && pairable) {
    *adv = 3;
    if (p[2] == '.') return 3;
    return (unsigned)(b0 - '0') + (unsigned)(p[2] - '0');
  }
  return 255;
}

// Parse rows in buf[0, n) (each '\n'-terminated). Writes packed records and
// pvar bytes; on error fills err[3] = {0-based row, 1-based sample or 0,
// reason: 1 ragged, 2 FORMAT, 3 GT} and returns -1, else returns row count.
int64_t import_span(const unsigned char* buf, int64_t n, int64_t n_samples,
                    int64_t rec_size, unsigned char* packed,
                    unsigned char* pvar_out, int64_t* pvar_len,
                    int64_t* err) {
  const unsigned char* p = buf;
  const unsigned char* const bend = buf + n;
#if defined(__AVX512BW__)
  // Stride-4 lane-split constants: a plain "a/b<sep>" GT field is exactly
  // 4 bytes, so 64 loaded bytes are 16 fields, one per u32 lane
  // (byte 0 = allele a, 1 = separator, 2 = allele b, 3 = terminator).
  const __m512i k_lo8 = _mm512_set1_epi32(0xFF);
  const __m512i k_slash = _mm512_set1_epi32('/');
  const __m512i k_pipe = _mm512_set1_epi32('|');
  const __m512i k_tab32 = _mm512_set1_epi32('\t');
  const __m512i k_ch0 = _mm512_set1_epi32('0');
  const __m512i k_ch1 = _mm512_set1_epi32('1');
  const __m512i k_dot = _mm512_set1_epi32('.');
  const __m512i k_three = _mm512_set1_epi32(3);
  const __m512i k_shifts = _mm512_setr_epi32(0, 2, 4, 6, 8, 10, 12, 14, 16,
                                             18, 20, 22, 24, 26, 28, 30);
#endif
  unsigned char* pv = pvar_out;
  int64_t row = 0;
  auto fail = [&](int64_t sample, int64_t reason) {
    err[0] = row;
    err[1] = sample;
    err[2] = reason;
    return (int64_t)-1;
  };
  while (p < bend) {
    const unsigned char* const line_start = p;
    const unsigned char* const line_end =
        (const unsigned char*)std::memchr(p, '\n', bend - p);
    if (!line_end) return fail(0, 1);  // caller guarantees termination
    // fields 1..8 (CHROM..INFO): find the 8th tab
    const unsigned char* q = p;
    for (int f = 0; f < 8; ++f) {
      q = (const unsigned char*)std::memchr(q, '\t', line_end - q);
      if (!q) return fail(0, 1);
      ++q;
    }
    const unsigned char* const info_end = q - 1;  // tab after INFO
    // FORMAT must lead with GT (VCF spec: GT first when present)
    if (line_end - q < 2 || q[0] != 'G' || q[1] != 'T' ||
        (line_end - q > 2 && q[2] != '\t' && q[2] != ':'))
      return fail(0, 2);
    q += 2;
    if (q < line_end && *q == ':') {  // FORMAT subfields: skip to its tab
      q = (const unsigned char*)std::memchr(q, '\t', line_end - q);
      if (!q) return fail(0, 1);
    }
    if (q >= line_end || *q != '\t') return fail(0, 1);
    ++q;
    // pvar row: first 8 fields verbatim + '\n'
    std::memcpy(pv, line_start, (size_t)(info_end - line_start));
    pv += info_end - line_start;
    *pv++ = '\n';
    // N sample fields
    unsigned char* rec = packed + row * rec_size;
    std::memset(rec, 0, (size_t)rec_size);
    int64_t s = 0;
#if defined(__AVX512BW__)
    // 16 fields (64 B) per iteration while every field is the plain
    // 4-byte "a/b\t" shape. Any deviation — subfields, multi-digit
    // alleles, the row's own '\n' (never one of the accepted byte
    // values, so a short row cannot validate), or the last field
    // (terminated by '\n', kept out by the s bound) — fails the
    // combined mask and drops to the scalar loop below, which re-parses
    // from the same position with full validation. s stays ≡ 0 (mod 4),
    // so the 16 packed 2-bit codes land as 4 whole record bytes.
    while (s + 16 <= n_samples - 1 && q + 64 <= bend) {
      const __m512i x = _mm512_loadu_si512((const void*)q);
      const __m512i a = _mm512_and_si512(x, k_lo8);
      const __m512i sep = _mm512_and_si512(_mm512_srli_epi32(x, 8), k_lo8);
      const __m512i b = _mm512_and_si512(_mm512_srli_epi32(x, 16), k_lo8);
      const __m512i t = _mm512_srli_epi32(x, 24);
      const __mmask16 am = _mm512_cmpeq_epi32_mask(a, k_dot);
      const __mmask16 bm = _mm512_cmpeq_epi32_mask(b, k_dot);
      const __mmask16 ok =
          (_mm512_cmpeq_epi32_mask(sep, k_slash) |
           _mm512_cmpeq_epi32_mask(sep, k_pipe)) &
          _mm512_cmpeq_epi32_mask(t, k_tab32) &
          (_mm512_cmpeq_epi32_mask(a, k_ch0) |
           _mm512_cmpeq_epi32_mask(a, k_ch1) | am) &
          (_mm512_cmpeq_epi32_mask(b, k_ch0) |
           _mm512_cmpeq_epi32_mask(b, k_ch1) | bm);
      if (ok != (__mmask16)0xFFFF) break;
      __m512i code = _mm512_add_epi32(_mm512_sub_epi32(a, k_ch0),
                                      _mm512_sub_epi32(b, k_ch0));
      code = _mm512_mask_mov_epi32(code, (__mmask16)(am | bm), k_three);
      const uint32_t word = (uint32_t)_mm512_reduce_or_epi32(
          _mm512_sllv_epi32(code, k_shifts));
      std::memcpy(rec + (s >> 2), &word, 4);
      q += 64;
      s += 16;
    }
#endif
    for (; s < n_samples; ++s) {
      // fast path: a plain 3-byte token followed by its terminator, all
      // resolved branchlessly from 4 loaded bytes + the classifier table;
      // one always-predicted branch guards it (taken for every field of a
      // plain GT VCF — the emitter's own output shape)
      if (q + 4 <= line_end + 1) {  // q[3] may be the '\n' itself
        const unsigned v0 = kGtByte.t[q[0]];
        const unsigned v2 = kGtByte.t[q[2]];
        const unsigned char b1 = q[1];
        const unsigned char b3 = q[3];
        const unsigned char want = s == n_samples - 1 ? '\n' : '\t';
        if (((b1 == '/') | (b1 == '|')) & (b3 == want) &
            (((v0 | v2) & 0xE0) == 0)) {
          const unsigned sum = v0 + v2;
          const unsigned code = sum >= 0x10 ? 3u : sum;
          rec[s >> 2] |= (unsigned char)(code << ((s & 3) * 2));
          q += 4;
          continue;
        }
      }
      int adv;
      const unsigned code = parse_gt(q, line_end - q, &adv);
      if (code == 255) return fail(s + 1, 3);
      rec[s >> 2] |= (unsigned char)(code << ((s & 3) * 2));
      q += adv;
      const unsigned char c = q < line_end ? *q : '\n';
      if (c == '\t') {
        if (s == n_samples - 1) return fail(0, 1);  // extra fields
        ++q;
      } else if (c == ':') {  // subfields: skip to the field's end
        const unsigned char* t =
            (const unsigned char*)std::memchr(q, '\t', line_end - q);
        if (t) {
          if (s == n_samples - 1) return fail(0, 1);
          q = t + 1;
        } else {
          if (s != n_samples - 1) return fail(0, 1);  // short row
          q = line_end;
        }
      } else if (c == '\n') {
        if (s != n_samples - 1) return fail(0, 1);  // short row
        q = line_end;
      } else {
        return fail(s + 1, 3);  // junk directly after the GT token
      }
    }
    p = line_end + 1;
    ++row;
  }
  *pvar_len = pv - pvar_out;
  return row;
}

}  // namespace

extern "C" {

// Two-thread wrapper: splits at a newline near the midpoint (the first
// half's row count — for the second thread's packed offset — comes from a
// SIMD newline count). pvar_out needs capacity n; packed needs
// (newline count) * rec_size. Returns total rows, or -1 with err filled
// (err[0] is the 0-based row index across the whole span).
int64_t pgen_vcf_import_rows(const unsigned char* buf, int64_t n,
                             int64_t n_samples, int64_t rec_size,
                             unsigned char* packed, unsigned char* pvar_out,
                             int64_t* pvar_len, int64_t* err) {
  if (n < (4 << 20)) {
    return import_span(buf, n, n_samples, rec_size, packed, pvar_out,
                       pvar_len, err);
  }
  const unsigned char* midp =
      (const unsigned char*)std::memchr(buf + n / 2, '\n', n - n / 2);
  if (!midp) {
    return import_span(buf, n, n_samples, rec_size, packed, pvar_out,
                       pvar_len, err);
  }
  const int64_t mid = (midp - buf) + 1;
  int64_t tabs0 = 0, rows0 = 0, crs0 = 0;
  pgen_count_seps(buf, mid, &tabs0, &rows0, &crs0);
  int64_t len0 = 0, len1 = 0, r0 = 0, r1 = 0;
  int64_t err0[3] = {0, 0, 0}, err1[3] = {0, 0, 0};
  std::thread th([&] {
    r0 = import_span(buf, mid, n_samples, rec_size, packed, pvar_out, &len0,
                     err0);
  });
  r1 = import_span(buf + mid, n - mid, n_samples, rec_size,
                   packed + rows0 * rec_size, pvar_out + mid, &len1, err1);
  th.join();
  if (r0 < 0 || r1 < 0) {
    if (r0 < 0) {
      err[0] = err0[0];
      err[1] = err0[1];
      err[2] = err0[2];
    } else {
      err[0] = rows0 + err1[0];
      err[1] = err1[1];
      err[2] = err1[2];
    }
    return -1;
  }
  // compact the second thread's pvar region against the first's
  std::memmove(pvar_out + len0, pvar_out + mid, (size_t)len1);
  *pvar_len = len0 + len1;
  return r0 + r1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BGZF input: blocked-gzip decompression for `pgen-tpu import x.vcf.gz`.
// Each BGZF member is independent (BC extra subfield carries its compressed
// size, ISIZE its output size), so the member walk yields an exact output
// layout and members decompress in parallel.
// ---------------------------------------------------------------------------

namespace {

struct BgzfBlock {
  int64_t in_off;    // member start
  int64_t data_off;  // deflate payload start
  int64_t data_len;  // deflate payload length
  int64_t out_off;
  int64_t out_len;
};

// Walk the member chain; returns false if `in` is not well-formed BGZF.
bool bgzf_walk(const unsigned char* in, int64_t n,
               std::vector<BgzfBlock>* blocks, int64_t* total_out) {
  int64_t off = 0, out = 0;
  while (off < n) {
    if (n - off < 28) return false;
    const unsigned char* h = in + off;
    if (h[0] != 0x1f || h[1] != 0x8b || h[2] != 8 || (h[3] & 4) == 0)
      return false;
    const int64_t xlen = h[10] | (h[11] << 8);
    if (n - off < 12 + xlen + 8) return false;
    // find the BC subfield inside the extra area
    int64_t bsize = -1;
    for (int64_t x = 0; x + 4 <= xlen;) {
      const unsigned char* sf = h + 12 + x;
      const int64_t slen = sf[2] | (sf[3] << 8);
      if (sf[0] == 'B' && sf[1] == 'C' && slen == 2 && x + 6 <= xlen) {
        bsize = (sf[4] | (sf[5] << 8)) + 1;
        break;
      }
      x += 4 + slen;
    }
    if (bsize < 12 + xlen + 8 || off + bsize > n) return false;
    const unsigned char* tail = in + off + bsize - 8;
    const int64_t isize = (int64_t)tail[4] | ((int64_t)tail[5] << 8) |
                          ((int64_t)tail[6] << 16) | ((int64_t)tail[7] << 24);
    if (blocks) {
      blocks->push_back({off, off + 12 + xlen, bsize - 12 - xlen - 8, out,
                         isize});
    }
    out += isize;
    off += bsize;
  }
  *total_out = out;
  return true;
}

bool inflate_block(const BgzfBlock& b, const unsigned char* in,
                   unsigned char* out) {
  if (b.out_len == 0) return true;  // EOF marker / empty block
  // the member tail's CRC32 guards against payload corruption that still
  // inflates to the right length
  const unsigned char* tail = in + b.data_off + b.data_len;
  const uint32_t want_crc = (uint32_t)tail[0] | ((uint32_t)tail[1] << 8) |
                            ((uint32_t)tail[2] << 16) |
                            ((uint32_t)tail[3] << 24);
#ifdef PGEN_HAVE_LIBDEFLATE
  struct DecTls {
    libdeflate_decompressor* d = nullptr;
    ~DecTls() {
      if (d) libdeflate_free_decompressor(d);
    }
  };
  static thread_local DecTls tls;
  if (!tls.d) tls.d = libdeflate_alloc_decompressor();
  if (!tls.d) return false;
  size_t got = 0;
  if (libdeflate_deflate_decompress(tls.d, in + b.data_off,
                                    (size_t)b.data_len, out + b.out_off,
                                    (size_t)b.out_len,
                                    &got) != LIBDEFLATE_SUCCESS ||
      (int64_t)got != b.out_len)
    return false;
  return (uint32_t)libdeflate_crc32(0, out + b.out_off, (size_t)b.out_len) ==
         want_crc;
#else
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<unsigned char*>(in + b.data_off);
  zs.avail_in = (uInt)b.data_len;
  zs.next_out = out + b.out_off;
  zs.avail_out = (uInt)b.out_len;
  const int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || (int64_t)zs.total_out != b.out_len) return false;
  return (uint32_t)crc32(crc32(0L, Z_NULL, 0), out + b.out_off,
                         (uInt)b.out_len) == want_crc;
#endif
}

}  // namespace

extern "C" {

// Total decompressed size of a BGZF stream, or -1 if not well-formed BGZF
// (caller falls back to generic gzip).
int64_t pgen_bgzf_decompressed_size(const unsigned char* in, int64_t n) {
  int64_t total = 0;
  if (!bgzf_walk(in, n, nullptr, &total)) return -1;
  return total;
}

// Decompress a BGZF stream (members in parallel). Returns bytes written or
// -1 on corruption / cap mismatch.
int64_t pgen_bgzf_decompress(const unsigned char* in, int64_t n,
                             unsigned char* out, int64_t cap) {
  std::vector<BgzfBlock> blocks;
  int64_t total = 0;
  if (!bgzf_walk(in, n, &blocks, &total) || total > cap) return -1;
  const size_t nb = blocks.size();
  bool ok0 = true, ok1 = true;
  const size_t mid = nb / 2;
  if (nb >= 8) {
    std::thread th([&] {
      for (size_t i = 0; i < mid && ok0; ++i)
        ok0 = inflate_block(blocks[i], in, out);
    });
    for (size_t i = mid; i < nb && ok1; ++i)
      ok1 = inflate_block(blocks[i], in, out);
    th.join();
  } else {
    for (size_t i = 0; i < nb && ok0; ++i)
      ok0 = inflate_block(blocks[i], in, out);
  }
  return (ok0 && ok1) ? total : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-sample genotype histogram: the column-axis reduction twin of
// pgen_gt_counts (per-variant). counts is (n_samples, 4) int64; the working
// set (4 counters per sample) stays cache-resident, so the pass is bound by
// reading the packed bytes.
// ---------------------------------------------------------------------------

namespace {

void sample_counts_span(const unsigned char* packed, int64_t n_var,
                        int64_t rec_size, int64_t n_samples, int64_t* counts) {
  const int64_t full = n_samples / 4;
  const int tail = (int)(n_samples % 4);
  for (int64_t v = 0; v < n_var; ++v) {
    const unsigned char* rec = packed + v * rec_size;
    for (int64_t j = 0; j < full; ++j) {
      const unsigned char* cs = kCodes.t[rec[j]];
      ++counts[(4 * j + 0) * 4 + cs[0]];
      ++counts[(4 * j + 1) * 4 + cs[1]];
      ++counts[(4 * j + 2) * 4 + cs[2]];
      ++counts[(4 * j + 3) * 4 + cs[3]];
    }
    if (tail) {
      const unsigned char* cs = kCodes.t[rec[full]];
      for (int p = 0; p < tail; ++p) ++counts[(4 * full + p) * 4 + cs[p]];
    }
  }
}

}  // namespace

extern "C" {

void pgen_sample_counts(const unsigned char* packed, int64_t n_var,
                        int64_t rec_size, int64_t n_samples,
                        int64_t* counts) {
  std::memset(counts, 0, (size_t)(n_samples * 4) * sizeof(int64_t));
  if (n_var * rec_size < (8 << 20)) {
    sample_counts_span(packed, n_var, rec_size, n_samples, counts);
    return;
  }
  const int64_t mid = n_var / 2;
  std::vector<int64_t> c1((size_t)(n_samples * 4), 0);
  std::thread th([&] {
    sample_counts_span(packed, mid, rec_size, n_samples, counts);
  });
  sample_counts_span(packed + mid * rec_size, n_var - mid, rec_size,
                     n_samples, c1.data());
  th.join();
  for (int64_t i = 0; i < n_samples * 4; ++i) counts[i] += c1[i];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Text rows of an f64 table (pca's .eigenvec): each row's prefix bytes, then
// its k values tab-separated, then '\n'. A value is std::to_chars's general
// form at 10 digits, which the standard defines as printf's "%.10g" and which
// is Python's f"{x:.10g}" byte for byte: both round correctly, ties to even,
// and write "-0", "inf" and "-inf" alike; a NaN of either sign is written
// "nan", as Python writes it (to_chars writes "-nan"). The rows are split
// over n_threads threads.

namespace {

// x as "%.10g" at dst (at most 17 bytes); returns the end.
char* put_g10(char* dst, double x) {
  if (std::isnan(x)) {
    std::memcpy(dst, "nan", 3);
    return dst + 3;
  }
  return std::to_chars(dst, dst + 17, x, std::chars_format::general, 10).ptr;
}

// Rows [lo, hi) at dst, which has room for each row's prefix and 18 bytes a
// value ("-1.234567891e-308" is 17; a tab or the newline after each);
// returns the end.
char* format_g10_span(const double* vals, int64_t lo, int64_t hi, int64_t k,
                      const unsigned char* prefix_buf, const int64_t* prefix_off,
                      char* dst) {
  for (int64_t r = lo; r < hi; ++r) {
    const int64_t plen = prefix_off[r + 1] - prefix_off[r];
    std::memcpy(dst, prefix_buf + prefix_off[r], (size_t)plen);
    dst += plen;
    for (int64_t c = 0; c < k; ++c) {
      if (c) *dst++ = '\t';
      dst = put_g10(dst, vals[r * k + c]);
    }
    *dst++ = '\n';
  }
  return dst;
}

}  // namespace

extern "C" {

// vals: (n, k) row-major f64; prefix_buf / prefix_off: row r's prefix is
// prefix_buf[prefix_off[r], prefix_off[r + 1]). Each of n_threads threads
// writes its share of the rows where the room for them starts in out; the
// shares are then moved down to follow each other. Returns the bytes
// written to out, or -1 if cap is short of the room for every row.
int64_t pgen_format_g10_rows(const double* vals, int64_t n, int64_t k,
                             const unsigned char* prefix_buf,
                             const int64_t* prefix_off, unsigned char* out,
                             int64_t cap, int n_threads) {
  if (prefix_off[n] - prefix_off[0] + n * (18 * k + 1) > cap) return -1;
  const int64_t parts = std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
  char* base = (char*)out;
  std::vector<int64_t> start((size_t)parts), len((size_t)parts);
  auto run = [&](int64_t t) {
    const int64_t lo = n * t / parts, hi = n * (t + 1) / parts;
    start[(size_t)t] = prefix_off[lo] - prefix_off[0] + lo * (18 * k + 1);
    char* at = base + start[(size_t)t];
    len[(size_t)t] = format_g10_span(vals, lo, hi, k, prefix_buf, prefix_off, at) - at;
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < parts; ++t) pool.emplace_back(run, t);
  run(0);
  for (auto& th : pool) th.join();
  int64_t total = len[0];
  for (int64_t t = 1; t < parts; ++t) {
    std::memmove(base + total, base + start[(size_t)t], (size_t)len[(size_t)t]);
    total += len[(size_t)t];
  }
  return total;
}

}  // extern "C"
